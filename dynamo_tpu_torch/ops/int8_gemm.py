"""Weight-only int8 GEMM: the CUDA kernel's wrapper and its plain version.

:func:`int8_matmul` computes ``(x @ q^T) * s`` for bfloat16 activations
``x [..., K]``, int8 weights ``q [N, K]`` (the checkpoint's ``[out, in]``
layout, one output channel's weights contiguous) and float32
per-output-channel scales ``s [N]``, giving ``[..., N]`` in x's dtype.
It is what ``models/quant.py QuantInt8`` runs for ``x @ w``: the JAX
package's ``QuantInt8.__rmatmul__`` (``dynamo_tpu/models/quant.py:87-92``),
where XLA fuses the int8 widening and the scale into the dot. There is
no Pallas kernel behind it; ``csrc/int8_gemm.cu`` is the port's own, and
its note says what bounds it on an H100 and what its design does about
it.

For tensors on the CPU the wrapper computes the plain version
(:func:`int8_matmul_plain`, the JAX package's order: the product with
the weights widened to x's dtype, then the scale in x's dtype); for CUDA
tensors it launches the kernel on the current stream or raises — there
is no fallback. The route comes from the shape (:func:`int8_gemm_plan`):
``small_m`` (M <= :data:`SMALL_M_MAX` rows, decode: bound by the weight
bytes, K split over a thread-block cluster) or ``large_m`` (prefill
chunks: 128 x 128 tiles). Every launching call adds one to
``INT8_GEMM_LAUNCHES[route]``; a CUDA graph's replay adds the counts its
capture recorded (``engine/cuda_graphs.py``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

# launching wrapper calls since the last reset, by route
INT8_GEMM_LAUNCHES: Dict[str, int] = {"small_m": 0, "large_m": 0}
INT8_GEMM_ROUTES = ("small_m", "large_m")  # the C entry's route numbers

SMALL_M_MAX = 64     # rows the small-M route takes (four m16 tiles)
SMALL_TILE_N = 32    # output columns a small-M block
CHUNK_K = 64         # the kernels' step along K
MAX_SPLITS = 8       # blocks of one cluster splitting K (portable maximum)
BLOCKS_PER_SM = 4    # the small-M plan's target of blocks in flight an SM

# H100 SXM peaks (NVIDIA's data sheet, 700 W): device memory and the
# dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def reset_launch_counts() -> None:
    for k in INT8_GEMM_LAUNCHES:
        INT8_GEMM_LAUNCHES[k] = 0


def int8_gemm_plan(M: int, N: int, K: int, sms: int) -> Tuple[int, int, int]:
    """(route, m16 tiles, splits) of a call, from host-known shapes only
    (so a CUDA graph can capture it). Small M: the m16 tiles that cover
    M (1, 2 or 4) and the K splits of each 32-column tile, a power of two
    up to :data:`MAX_SPLITS`, enough for ``BLOCKS_PER_SM * sms`` blocks
    where the tiles alone are fewer, with at least eight 64-wide chunks
    of K a split (two a warp). Large M: (1, 0, 0)."""
    if M > SMALL_M_MAX:
        return 1, 0, 0
    mt = 1 if M <= 16 else 2 if M <= 32 else 4
    tiles = -(-N // SMALL_TILE_N)
    want = -(-(BLOCKS_PER_SM * sms) // tiles)
    chunks = -(-K // CHUNK_K)
    cap = min(MAX_SPLITS, want, max(chunks // 8, 1))
    splits = 1
    while splits * 2 <= cap:
        splits *= 2
    return 0, mt, splits


def int8_gemm_work(M: int, K: int, N: int) -> dict:
    """The least work of one call: each input read once and the output
    written once (``K N`` int8 weights, ``4 N`` bytes of scales, ``2 M K``
    of bf16 x, ``2 M N`` of bf16 y) at :data:`HBM_BYTES_PER_S`, and
    ``2 M K N`` operations at :data:`BF16_FLOPS`; the bound is the
    larger of the two times."""
    nbytes = K * N + 4 * N + 2 * M * K + 2 * M * N
    flops = 2 * M * K * N
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# The kernel against the float32 evaluation of its plain version
# (int8_gemm_tolerance): one bf16 rounding of the output, 2^-8 of it,
# plus the float32 sums taken in another order, within 2^-16 of the sum
# of the terms' magnitudes (a few times sqrt(K) float32 roundings for K
# up to 16,384).
OUT_RTOL = 2.0 ** -8
SUM_RTOL = 2.0 ** -16


def int8_gemm_tolerance(x: torch.Tensor, q: torch.Tensor,
                        s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(reference, tolerance) of a call, both [M, N] float32: the plain
    version evaluated in float32 (TF32 off), and ``OUT_RTOL |ref| +
    SUM_RTOL (|x| @ |q|^T) s``."""
    xf = x.float().reshape(-1, q.shape[1])
    qf = q.float()
    sf = s.reshape(-1).float()
    ref = int8_matmul_plain(xf, q, sf)
    mag = (xf.abs() @ qf.abs().t()) * sf
    return ref, OUT_RTOL * ref.abs() + SUM_RTOL * mag


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                      s: torch.Tensor) -> torch.Tensor:
    """The plain version, in the JAX package's order: ``x @ q`` with the
    weights widened to x's dtype (so the product rounds to x's dtype),
    then the scale in x's dtype. q: [N, K] int8; s: [N] (or [1, N])."""
    y = x @ q.t().to(x.dtype)
    return y * s.reshape(-1).to(x.dtype)


_SMS: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _lib():
    """The kernel's library (``csrc/int8_gemm.cu``)."""
    from .build import library

    lib = library("int8_gemm")
    if not getattr(lib, "_dyn_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dyn_int8_gemm.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.dyn_int8_gemm.restype = i
        lib._dyn_typed = True
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """``(x @ q^T) * s``: x [..., K]; q [N, K] int8, contiguous; s [N]
    float32 (or [1, N]). On the CPU the plain version; on a CUDA device
    the kernel, which takes bfloat16 x, K a multiple of 16, contiguous
    operands and 16-byte-aligned x and q, and raises on anything else.
    Returns [..., N] in x's dtype."""
    _check(q.dim() == 2 and q.dtype == torch.int8,
           f"q must be [N, K] int8, got {tuple(q.shape)} {q.dtype}")
    N, K = q.shape
    _check(x.shape[-1] == K, f"x's last dimension {x.shape[-1]} != K {K}")
    _check(s.numel() == N and s.dtype == torch.float32,
           f"s must hold N={N} float32 scales, got {tuple(s.shape)} "
           f"{s.dtype}")
    devs = {x.device, q.device, s.device}
    if all(d.type == "cpu" for d in devs):
        return int8_matmul_plain(x, q, s)
    _check(len(devs) == 1 and x.is_cuda,
           f"int8 GEMM operands on mixed or unsupported devices: "
           f"{sorted(str(d) for d in devs)}")
    _check(x.dtype == torch.bfloat16,
           f"the int8 GEMM kernel takes bfloat16 x, got {x.dtype}")
    _check(K % 16 == 0, f"K={K} is not a multiple of 16")
    for name, t in (("x", x), ("q", q), ("s", s)):
        _check(t.is_contiguous(), f"{name} must be contiguous")
    for name, t in (("x", x), ("q", q)):  # 16-byte loads
        _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    lead = tuple(x.shape[:-1])
    M = x.numel() // K
    y = torch.empty(lead + (N,), dtype=x.dtype, device=x.device)
    if M == 0:
        return y
    route, mt, splits = int8_gemm_plan(M, N, K, _sm_count(x.device))
    err = _lib().dyn_int8_gemm(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), M, N, K,
        route, mt, splits, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8 GEMM launch failed: CUDA error {err} "
                           f"(M={M} N={N} K={K} route "
                           f"{INT8_GEMM_ROUTES[route]}, {mt} m16 tiles, "
                           f"{splits} splits)")
    INT8_GEMM_LAUNCHES[INT8_GEMM_ROUTES[route]] += 1
    return y
