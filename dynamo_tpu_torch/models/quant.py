"""Weight-only int8 quantization (per-output-channel symmetric).

The port's copy of ``dynamo_tpu/models/quant.py``. Decode is bound by the
weight bytes it streams each step, and int8 storage halves them; the
activations stay bfloat16. For a weight ``w[..., in, out]`` the scheme is
``q = round(w / s)`` in int8 with per-output-channel scales
``s[..., 1, out] = amax(|w|, in) / 127``, and ``x @ w`` is computed as
``(x @ q) * s`` (exact: the scale is constant along the contraction).

:class:`QuantInt8` duck-types the few tensor operations the model code
applies to weights (``x @ w``, ``[layer]``, ``index_select`` on the
leading axis, ``shape``, ``astype``, ``reshape``), so ``models/llama.py``
has no int8 branches; a MoE stack ``[L, E, in, out]`` is one
``QuantInt8`` whose ``[layer][expert]`` (or one expert taken by a device
index) is a ``[in, out]`` weight, and every expert product runs on the
int8 GEMM: no stack is ever dequantized. The JAX
package's XLA fuses the widening and the scale into the consumer dot,
so the bfloat16 weights never exist in device memory; here ``x @ w`` goes
to ``ops/int8_gemm.py int8_matmul``, the hand-written CUDA kernel on the
card and its plain version on the CPU. ``q`` is kept in the kernel's
layout, the checkpoint's ``[..., out, in]`` (one output channel's
weights contiguous along the contraction); :attr:`QuantInt8.shape` and
:meth:`QuantInt8.dequant` speak the JAX package's ``[..., in, out]``.
A ``QuantInt8`` made with ``plain=True`` (:meth:`QuantInt8.as_plain`)
multiplies through the plain version on any device: the plain path the
kernel path is held against on the card.

The quantization arithmetic is ``quantize_int8_np``'s, in float32 on any
device (``torch.round`` rounds half to even, as ``np.rint`` does), so the
int8 values and scales are bitwise the JAX package's.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..ops.int8_gemm import int8_matmul, int8_matmul_plain

# Params quantized under --dtype int8: every large projection matrix.
# Excluded: embed (gather table), routers + router_bias (tiny,
# routing-precision-critical), norms and biases (1-D). Every key is
# served: the dense and Mixtral-style stacks (models/llama.py; experts
# [L, E, in, out]) and the MLA and DeepSeek-MoE stacks (models/mla.py,
# where w_uk and w_uv dequantize before their per-head reshape).
QUANT_KEYS = frozenset({
    # llama/qwen/gemma stack
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head",
    # MLA (DeepSeek) stack: q path, latent projections, output
    "w_q", "w_dq", "w_uq", "w_dkv", "w_uk", "w_uv", "w_o",
    # DeepSeek MoE segments: dense first-k, routed experts, shared
    "w_gate_d", "w_up_d", "w_down_d",
    "w_gate_e", "w_up_e", "w_down_e",
    "w_gate_s", "w_up_s", "w_down_s",
})


class QuantInt8:
    """int8 weight ``q [..., out, in]`` + float32 per-output-channel scale
    ``s [..., 1, out]``; see the module docstring. ``q`` and ``s`` may
    also be numpy arrays while a param is cut to a tensor-parallel
    shard (``parallel/mesh.py shard_param``)."""

    __slots__ = ("q", "s", "plain")

    def __init__(self, q, s, plain: bool = False):
        self.q, self.s, self.plain = q, s, plain

    # ---- duck-typed tensor surface (only what model code uses on weights)

    @property
    def shape(self):
        """The JAX package's ``[..., in, out]``."""
        *lead, out, inp = self.q.shape
        return (*lead, inp, out)

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def nbytes(self) -> int:
        return self.q.nbytes + self.s.nbytes

    def dequant(self, dtype=None) -> torch.Tensor:
        """The float weights ``[..., in, out]`` (float32, or ``dtype``)."""
        w = self.q.transpose(-1, -2).to(self.s.dtype) * self.s
        return w.to(dtype) if dtype is not None else w

    def astype(self, dtype) -> torch.Tensor:
        return self.dequant(dtype)

    def reshape(self, *shape) -> torch.Tensor:
        return self.dequant().reshape(*shape)

    def __getitem__(self, idx) -> "QuantInt8":
        # leading-(layer-, expert-)axis indexing only: q and s share them
        return QuantInt8(self.q[idx], self.s[idx], self.plain)

    def index_select(self, dim: int, index: torch.Tensor) -> "QuantInt8":
        """The entries ``index`` (a device tensor) of a leading axis, as
        ``torch.index_select`` takes them: a copy, made on the device."""
        if dim < 0 or dim >= self.q.ndim - 2:
            raise ValueError(f"index_select on dim {dim}: only the leading "
                             f"axes of {self!r}")
        return QuantInt8(self.q.index_select(dim, index),
                         self.s.index_select(dim, index), self.plain)

    def as_plain(self) -> "QuantInt8":
        """The same weights, multiplied through the plain version."""
        return QuantInt8(self.q, self.s, True)

    def __rmatmul__(self, x: torch.Tensor) -> torch.Tensor:
        # torch.Tensor.__matmul__ turns the TypeError of a non-tensor
        # operand into NotImplemented, so Python lands here
        if self.plain:
            return int8_matmul_plain(x, self.q, self.s)
        return int8_matmul(x, self.q, self.s)

    def __repr__(self) -> str:
        return (f"QuantInt8(shape={tuple(self.shape)}, "
                f"s={tuple(self.s.shape)}{', plain' if self.plain else ''})")


def scale_of(amax: torch.Tensor) -> torch.Tensor:
    """Per-channel scales from the channels' ``amax`` (float32):
    ``max(amax / 127, 1e-12)``."""
    return torch.clamp(amax / 127.0, min=1e-12)


def quantize_rows(wt: torch.Tensor,
                  scale: Optional[torch.Tensor] = None) -> QuantInt8:
    """Quantize weights given in the kernel's layout ``wt [..., out, in]``
    (any float dtype, any device): float32, amax over ``in``, ``s =
    max(amax / 127, 1e-12)``, ``q = clip(rint(w / s), -127, 127)``.
    ``scale`` [..., out, 1], when given, replaces the scales taken from
    ``wt`` (a tensor-parallel shard of ``in`` quantized with the scales
    of the whole rows)."""
    w32 = wt.float()
    s = scale if scale is not None else scale_of(
        w32.abs().amax(dim=-1, keepdim=True))
    q = torch.round(w32 / s).clamp_(-127, 127).to(torch.int8)
    return QuantInt8(q.contiguous(), s.transpose(-1, -2).contiguous())


def quantize_int8(w: torch.Tensor,
                  rows: Optional[Callable[[torch.Tensor], QuantInt8]] = None
                  ) -> QuantInt8:
    """Quantize ``w [..., in, out]`` (the JAX package's layout) one
    matrix at a time (a layer's, or a layer's expert's), so the float32
    temporaries stay one matrix's size. ``rows(wt)`` quantizes one
    matrix given in the kernel's layout ``[out, in]`` in place of
    :func:`quantize_rows`."""
    if w.dim() > 2:
        parts = [quantize_int8(w[i], rows) for i in range(w.shape[0])]
        return QuantInt8(torch.stack([p.q for p in parts]),
                         torch.stack([p.s for p in parts]))
    return (rows or quantize_rows)(w.transpose(-1, -2))


def quantize_params(params: Dict, keys=QUANT_KEYS,
                    quantize: Optional[Callable] = None) -> Dict:
    """Quantize the projection weights of a params dict (tensors on any
    device; keys outside ``keys`` untouched). ``quantize(name, w)``
    replaces :func:`quantize_int8` (a tensor-parallel rank's, whose
    scales span the whole rows: ``parallel/mesh.py quantize_shard``)."""
    out = {}
    for k, v in params.items():
        if k in keys and not isinstance(v, QuantInt8):
            out[k] = quantize(k, v) if quantize else quantize_int8(v)
        else:
            out[k] = v
    return out


def synthetic_int8_params(cfg, device="cuda") -> Dict:
    """Shape-faithful int8 params with MEANINGLESS values, built in
    milliseconds, for throughput measurement only: quantized keys get
    uninitialised int8 (always finite) with fan-in scales, norms ones and
    everything else zeros, so activations stay finite throughout."""
    from ..runtime.device import resolve_device
    from .registry import get_model_module

    device = resolve_device(device)
    out = {}
    for name, _, shape in get_model_module(cfg).param_table(cfg):
        if name in QUANT_KEYS:
            *lead, inp, outd = shape
            q = torch.empty((*lead, outd, inp), dtype=torch.int8,
                            device=device)
            s = torch.full((*lead, 1, outd), 1.0 / inp ** 0.5 / 127.0,
                           dtype=torch.float32, device=device)
            out[name] = QuantInt8(q, s)
        elif name.startswith(("ln_", "q_norm", "k_norm", "kv_norm")):
            out[name] = torch.ones(shape, dtype=cfg.torch_dtype,
                                   device=device)
        else:
            out[name] = torch.zeros(shape, dtype=cfg.torch_dtype,
                                    device=device)
    return out
