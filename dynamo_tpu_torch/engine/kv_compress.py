"""int8 compression for KV pages crossing the transfer plane: the host
forms of ``dynamo_tpu/engine/kv_compress.py``.

Each (token, head) row of a page block ``[L, n, KV, ps, hd]`` is
quantized to int8 with a float32 amax/127 scale (hd bytes + 4 against
2·hd in 16 bits), at a per-element error of at most s/2. Lossy, so
opt-in (``PrefillWorker`` ``compress_kv`` / ``DYN_KV_TRANSFER_INT8``).
The arithmetic is the reference's numpy, on a float32 copy of the pages
(exact from bfloat16 and float16), so the bytes are the reference's.
The device forms and the host KV tier are not ported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


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
