"""int8 compression for KV pages crossing a slow boundary: the forms of
``dynamo_tpu/engine/kv_compress.py``.

Each (token, head) row of a page block ``[..., hd]`` is quantized to int8
with a float32 amax/127 scale (hd bytes + 4 against 2·hd in 16 bits), at
a per-element error of at most s/2. Lossy, so opt-in where it is not the
default: the host KV tier (``EngineConfig.host_tier_int8``, on by default
once the tier is enabled) and the transfer plane (``PrefillWorker``
``compress_kv`` / ``DYN_KV_TRANSFER_INT8``).

Two forms, as in the reference:

- the device forms :func:`quantize_pages` / :func:`dequantize_pages`,
  torch ops on the pages' own device (the host tier quantizes before its
  device-to-host copy and dequantizes after its host-to-device copy, so
  the link moves int8). Their arithmetic is the reference's jitted
  arithmetic as XLA compiles it: the scale is ``amax * float32(1/127)``
  (XLA turns the division by the constant into a multiply by its float32
  reciprocal), floored at 1e-12, and ``a / s`` is a true division,
  rounded half to even, clipped to ±127. On CPU tensors the bytes are
  the jitted forms' bytes;
- the host forms ``quantize_pages_np`` / ``dequantize_pages_np``, the
  reference's numpy (a true division by 127: about one scale in twenty
  lands one ulp away from the device form's, and its row's int8 values
  follow), on a float32 copy of the pages (exact from bfloat16 and
  float16), so the transfer plane's bytes are the reference's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


# float32(1 / 127), exactly representable in float32: the multiplier XLA
# puts in place of the reference's division of amax by 127
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_pages(pages: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device form: pages ``[..., hd]`` (any float dtype) -> (int8 of the
    same shape, float32 scales ``[..., 1]``), on the pages' device."""
    a32 = pages.to(torch.float32)
    amax = a32.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp_min(amax * _INV_127, 1e-12)
    q = torch.clamp(torch.round(a32 / s), -127, 127).to(torch.int8)
    return q, s


def dequantize_pages(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Device inverse, in float32 (the caller casts to the pool's dtype,
    rounding to nearest even)."""
    return q.to(torch.float32) * s


def quantize_pages_np(pages: torch.Tensor
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Host pages (a CPU tensor) -> (int8 of the same shape, float32
    scales [L, n, KV, ps, 1])."""
    a32 = pages.to(torch.float32).numpy()
    amax = np.max(np.abs(a32), axis=-1, keepdims=True)
    s = np.maximum(amax / 127.0, 1e-12).astype(np.float32)
    q = np.clip(np.rint(a32 / s), -127, 127).astype(np.int8)
    return q, s


def dequantize_pages_np(q: np.ndarray, s: np.ndarray,
                        dtype: torch.dtype) -> torch.Tensor:
    """The inverse, as a CPU tensor of the pool's ``dtype``: the float32
    product is the reference's, and its rounding to bfloat16 or float16
    is to nearest even, as ``astype`` rounds in numpy (``ml_dtypes``)."""
    prod = np.asarray(q, np.float32) * s
    return torch.from_numpy(np.ascontiguousarray(prod)).to(dtype)
