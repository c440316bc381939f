"""Weight-only int8 GEMM: the CUDA kernels' wrapper and their plain version.

:func:`int8_matmul` computes ``(x @ q^T) * s`` for activations ``x [...,
K]`` (bfloat16, float16 or float32), int8 weights ``q [N, K]`` (the
checkpoint's ``[out, in]`` layout, one output channel's weights
contiguous) and float32 per-output-channel scales ``s [N]``, giving
``[..., N]`` in x's dtype. It is what ``models/quant.py QuantInt8`` runs
for ``x @ w``: the JAX package's ``QuantInt8.__rmatmul__``
(``dynamo_tpu/models/quant.py:87-92``), where XLA fuses the int8 widening
and the scale into the dot. There is no Pallas kernel behind it;
``csrc/int8_gemm.cu`` is the port's own, and its note says what bounds it
on an H100 and what its design does about it.

For tensors on the CPU the wrapper computes the plain version
(:func:`int8_matmul_plain`, the JAX package's order: the product with
the weights widened to x's dtype, then the scale in x's dtype); for CUDA
tensors it launches a kernel on the current stream or raises — there is
no fallback. :func:`int8_gemm_plan` picks the route, its tile, its K
splits and its grid from the shape alone, so a CUDA graph can capture
them:
- ``small_m`` (bfloat16 and float16, decode: up to 16 rows of every
  product and 32 of the narrower ones, :data:`SMALL_M_TAKES`): bound by
  the weight bytes; a TMA ring streams 64-channel tiles of q and the rows
  of x into shared memory for ``mma.sync``, K split over a thread-block
  cluster; launched programmatically (PDL), so a call streams its first
  weights while the kernel before it finishes;
- ``wgmma`` (bfloat16 and float16, the rest: prefill chunks, the larger
  decode batches, and w_gate/w_up and lm_head above 16 rows): a TMA ring
  feeding warp-specialised register-A ``wgmma`` on persistent tiles of
  128 channels by 16-256 tokens, K split over a cluster where the tiles
  do not fill the card.
The float16 forms of ``small_m`` and ``wgmma`` are the same designs with
float16 tensor-core products and a float16 widening of the weights. The
float32 forms ("2xTF32", float32 x as the tiny preset and the 1b-shaped
float32 engine serve) run on the TF32 tensor cores: x split into a TF32
part and its remainder, two TF32 products an operation (the int8 weights
are exact in TF32), each stage's or chunk's products summed from zero and
added in float32; ``small_m`` (``mma.sync`` m16n8k8, the weights as A and
the tokens as n8, up to :data:`SMALL_M_ROWS_F32` rows) and ``wgmma``
(``wgmma`` m64nBTk8, 16-128 tokens a tile), with their own crossover
(:data:`SMALL_M_TAKES_F32`) and time model (:data:`WG_CHUNK_US_F32`).
Every launching call adds one to ``INT8_GEMM_LAUNCHES[launch_key(route,
dtype)]``: the route's name, with ``_f16`` for a float16 call and
``_f32`` for a float32 one, so the three forms count apart; a CUDA
graph's replay adds the counts its capture recorded
(``engine/cuda_graphs.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

# the routes, in the C entry's numbering; each has a bfloat16, a float16
# and a float32 form
INT8_GEMM_ROUTES = ("small_m", "wgmma")
# the forms' suffixes in the launch counts' keys (launch_key)
FORM_SUFFIX = {torch.bfloat16: "", torch.float16: "_f16",
               torch.float32: "_f32"}
# launching wrapper calls since the last reset, by route and form
# (launch_key)
INT8_GEMM_LAUNCHES: Dict[str, int] = {
    r + f: 0 for f in FORM_SUFFIX.values() for r in INT8_GEMM_ROUTES}
# x's dtype in the C entry's numbering
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}

# The crossover (both routes timed at the 8B model's shapes and one
# rank's at tp=2, M = 1 to 64 rows, on an H100; PERF.md, Findings): the
# small-M route takes M rows of N channels where M <= rows and N <=
# channels of an entry; the wgmma route the rest. Up to 16 rows of every
# product (w_gate/w_up and lm_head included: 14.5-187 against 16.1-201
# us), and up to 32 rows of at most 4,096 channels (wq, wo, wk/wv,
# w_down and their tp=2 shards: 4.4-31.4 against 7.6-40.0 us); w_gate/
# w_up at 24-32 rows are faster on the wgmma route, and lm_head there is
# within 2% either way (a tie, to wgmma).
SMALL_M_TAKES = ((16, math.inf), (32, 4096))
# The float32 forms' crossover, in the same form (both float32 forms
# timed at Llama-3.2-1B's and the 8B model's projections, M = 1 to 64
# rows, on an H100; PERF.md, Findings): the float32 small-M kernel,
# which holds at most SMALL_M_ROWS_F32 rows (two n8 tiles), is the faster
# up to there at every N (3.7-215 against 6.7-370 us)
SMALL_M_TAKES_F32 = ((16, math.inf),)
SMALL_M_ROWS = 32    # the most rows the small-M kernel takes (2 m16 tiles)
SMALL_M_ROWS_F32 = 16  # ... in its float32 form (2 n8 tiles)
SMALL_TILE_N = 64    # output channels a small-M block
SMALL_STAGE_K = 128  # the small-M kernel's ring stage along K
SMALL_MIN_STAGES = 4  # stages a small-M split at least: one a K group
CHUNK_K = 64         # the wgmma kernel's step along K
MAX_SPLITS = 8       # blocks of one cluster splitting K (portable maximum)
WG_TILE_N = 128      # output channels a wgmma tile (64 a warpgroup)
WG_TOKENS = (16, 32, 64, 128, 256)  # tokens a wgmma tile (wgmma's N)
# ... in the float32 form, whose chunk sums take a second BT / 2
# registers a thread
WG_TOKENS_F32 = (16, 32, 64, 128)

# H100 SXM peaks (NVIDIA's data sheet, 700 W): device memory, the dense
# bf16 and TF32 tensor-core rates and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 494.7e12
FFMA_FLOPS = 67e12


class Int8Plan(NamedTuple):
    """One call's launch: its route; its tile (small_m: tiles of tokens,
    1 or 2, m16 tiles in bfloat16 and float16, n8 tiles in float32;
    wgmma: tokens a tile, :data:`WG_TOKENS`, :data:`WG_TOKENS_F32` in
    float32); the blocks of one cluster that split K; and the blocks
    launched."""
    route: str
    tile: int
    splits: int
    grid: int


def reset_launch_counts() -> None:
    for k in INT8_GEMM_LAUNCHES:
        INT8_GEMM_LAUNCHES[k] = 0


def launch_key(route: str, dtype: torch.dtype) -> str:
    """The :data:`INT8_GEMM_LAUNCHES` key of a call: the route, with
    ``_f16`` for its float16 form and ``_f32`` for its float32 form."""
    return route + FORM_SUFFIX[dtype]


# The wgmma plan's model of an H100 SXM (700 W), fitted to the kernel's
# times over the served shapes (``python -m
# dynamo_tpu_torch.ops.time_int8_gemm --plans``; PERF.md, Findings): a
# block's time for one 64-wide chunk of K, by tokens a tile, and
# a K split's fold: WG_FOLD_US, + WG_FOLD_SPLIT_US a split, + 1 us a 64
# tokens of the tile.
WG_CHUNK_US = {16: 0.40, 32: 0.41, 64: 0.44, 128: 0.53, 256: 0.80}
WG_FOLD_US = 1.0
WG_FOLD_SPLIT_US = 0.47
# the float32 form's chunk time, fitted the same way (``--plans --dtype
# float32``): two TF32 products, lo's pass over the stage and a float32
# add of the chunk's sums, one chunk in flight
WG_CHUNK_US_F32 = {16: 0.70, 32: 0.76, 64: 1.05, 128: 1.65}


def resident_model(tokens: int, splits: int, sms: int) -> int:
    """Clusters of ``splits`` blocks a card of ``sms`` SMs holds at once,
    one block an SM, as the CUDA driver counts them for the wgmma kernel
    on an H100 SXM's 132 SMs (``cudaOccupancyMaxActiveClusters`` at every
    tile width: 132, 66, 39, 30, 22, 17, 15 and 15 clusters of 1 to 8
    blocks; PERF.md). On the card the wrapper asks the CUDA driver
    instead."""
    return sms * {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15,
                  8: 15}[splits] // 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wgmma_plan(M: int, N: int, K: int,
                resident: Callable[[int, int], int],
                dtype: torch.dtype = torch.bfloat16) -> Int8Plan:
    """The wgmma route's tile, splits and grid: the candidate with the
    least estimated time. A cluster walks ceil(tiles / resident) tiles
    one after the other, each of ceil(chunks / splits) 64-wide chunks of
    K at :data:`WG_CHUNK_US` a chunk (:data:`WG_CHUNK_US_F32` in
    float32), plus its fold if split (:data:`WG_FOLD_US`); never less
    than the bytes of q and x at :data:`HBM_BYTES_PER_S`. Ties go to
    fewer splits, then to fewer padded rows. Each split takes at least
    two chunks."""
    f32 = dtype == torch.float32
    chunk_us = WG_CHUNK_US_F32 if f32 else WG_CHUNK_US
    chunks = _cdiv(K, CHUNK_K)
    floor_us = (N * K + (4 if f32 else 2) * M * K) / HBM_BYTES_PER_S * 1e6
    best = None
    for tokens in WG_TOKENS_F32 if f32 else WG_TOKENS:
        rows = _cdiv(M, tokens)
        tiles = rows * _cdiv(N, WG_TILE_N)
        for splits in (1, 2, 4, 8):
            if splits > 1 and chunks < 2 * splits:
                continue
            res = resident(tokens, splits)
            fold_us = (WG_FOLD_US + WG_FOLD_SPLIT_US * splits + tokens / 64
                       if splits > 1 else 0.0)
            est = max(floor_us, _cdiv(tiles, res) * (
                _cdiv(chunks, splits) * chunk_us[tokens] + fold_us))
            key = (round(est, 3), splits, rows * tokens)
            if best is None or key < best[0]:
                best = (key, Int8Plan("wgmma", tokens, splits,
                                      min(tiles, res) * splits))
    return best[1]


def int8_gemm_plan(M: int, N: int, K: int, sms: int,
                   dtype: torch.dtype = torch.bfloat16,
                   resident: Optional[Callable[[int, int], int]] = None
                   ) -> Int8Plan:
    """The launch of one call (:class:`Int8Plan`), from host-known shapes
    only (so a CUDA graph can capture it), in the form of x's dtype.
    bfloat16 and float16 x (the float16 forms run at the bfloat16 rate,
    and take the bfloat16 crossover), and float32 x with its own
    crossover, where :func:`small_m_takes` (the measured crossover):
    small_m (:func:`small_m_plan`). Otherwise wgmma (:func:`wgmma_plan`),
    a persistent grid of as many clusters as the card holds at once
    (``resident(tokens, splits)``; by default :func:`resident_model`) or
    as there are tiles."""
    if resident is None:
        def resident(tokens, splits):
            return resident_model(tokens, splits, sms)
    if small_m_takes(M, N, dtype):
        return small_m_plan(M, N, K, sms, resident, dtype)
    return wgmma_plan(M, N, K, resident, dtype)


def small_m_takes(M: int, N: int,
                  dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether a call of M rows and N channels goes to the small-M route
    (the crossover: :data:`SMALL_M_TAKES` for bfloat16 and float16,
    :data:`SMALL_M_TAKES_F32` for float32)."""
    takes = SMALL_M_TAKES_F32 if dtype == torch.float32 else SMALL_M_TAKES
    return any(M <= rows and N <= n for rows, n in takes)


def small_m_plan(M: int, N: int, K: int, sms: int,
                 resident: Optional[Callable[[int, int], int]] = None,
                 dtype: torch.dtype = torch.bfloat16) -> Int8Plan:
    """The small_m route's launch (M <= :data:`SMALL_M_ROWS`, or
    :data:`SMALL_M_ROWS_F32` in float32): the tiles of tokens that cover
    M (m16 tiles; n8 tiles in float32), and the K splits of each
    64-channel tile (1 to :data:`MAX_SPLITS`, a cluster): the fewest
    128-wide stages of K a block (ties to fewer splits), each split
    keeping :data:`SMALL_MIN_STAGES`, with every tile's cluster on the
    card at once one block an SM (``resident(tokens, splits)``, the
    wgmma kernel's count in the same form, by default
    :func:`resident_model`): placed two to an SM, a block computes at
    half speed, and its cluster waits for it."""
    if resident is None:
        def resident(tokens, splits):
            return resident_model(tokens, splits, sms)
    mt = _cdiv(M, 8 if dtype == torch.float32 else 16)
    tiles = _cdiv(N, SMALL_TILE_N)
    stages = _cdiv(K, SMALL_STAGE_K)
    best = 1
    for splits in range(2, MAX_SPLITS + 1):
        if (_cdiv(stages, splits) >= SMALL_MIN_STAGES
                and tiles <= resident(WG_TOKENS[0], splits)
                and _cdiv(stages, splits) < _cdiv(stages, best)):
            best = splits
    return Int8Plan("small_m", mt, best, tiles * best)


# the operations the tensor cores do for one of the product's, and their
# dense peak rate, by the activations' type (NVIDIA's data sheet): the
# 16-bit types one at the bf16 rate, float32 two TF32 products (2xTF32)
TC_OPS = {torch.bfloat16: (1, BF16_FLOPS), torch.float16: (1, BF16_FLOPS),
          torch.float32: (2, TF32_FLOPS)}


def int8_gemm_work(M: int, K: int, N: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    """The least work of one call: each input read once and the output
    written once (``K N`` int8 weights, ``4 N`` bytes of scales, ``M K``
    of x and ``M N`` of y in ``dtype``) at :data:`HBM_BYTES_PER_S`, and
    ``2 M K N`` operations on the tensor cores as the kernels do them
    (:data:`TC_OPS`: in float32 two TF32 products each, 4 M K N at
    :data:`TF32_FLOPS`); the bound is the larger of the two times. A
    float32 call also carries ``bound_ffma_ms``, its operations at the
    CUDA cores' float32 rate (:data:`FFMA_FLOPS`), the larger of that and
    the bytes."""
    e = torch.empty((), dtype=dtype).element_size()
    nbytes = K * N + 4 * N + e * M * K + e * M * N
    flops = 2 * M * K * N
    times, peak = TC_OPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = times * flops / peak * 1e3
    work = {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if dtype == torch.float32:
        work["bound_ffma_ms"] = max(t_bytes, flops / FFMA_FLOPS * 1e3)
    return work


# A kernel against the float32 evaluation of its plain version
# (int8_gemm_tolerance): one rounding of the output to its dtype (2^-8 of
# it in bfloat16, 2^-11 in float16, 2^-24 in float32), plus the float32
# sums taken in another order, within 2^-16 of the sum of the terms'
# magnitudes (a few times sqrt(K) float32 roundings for K up to 16,384).
OUT_RTOL = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11,
            torch.float32: 2.0 ** -24}
SUM_RTOL = 2.0 ** -16


def int8_gemm_tolerance(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(reference, tolerance) of a call (its output is in x's dtype), both
    [M, N] float32: the plain version evaluated in float32 (TF32 off),
    and ``OUT_RTOL[x.dtype] |ref| + SUM_RTOL (|x| @ |q|^T) s``."""
    rtol = OUT_RTOL[x.dtype]
    xf = x.float().reshape(-1, q.shape[1])
    qf = q.float()
    sf = s.reshape(-1).float()
    ref = int8_matmul_plain(xf, q, sf)
    mag = (xf.abs() @ qf.abs().t()) * sf
    return ref, rtol * ref.abs() + SUM_RTOL * mag


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                      s: torch.Tensor) -> torch.Tensor:
    """The plain version, in the JAX package's order: ``x @ q`` with the
    weights widened to x's dtype (so the product rounds to x's dtype),
    then the scale in x's dtype. q: [N, K] int8; s: [N] (or [1, N]).
    In float16 the product before the scale overflows to inf where
    ``|x @ q|`` passes 65504, which the kernels (float32 sums, the scale
    applied before the one rounding) never do."""
    y = x @ q.t().to(x.dtype)
    return y * s.reshape(-1).to(x.dtype)


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def resident_of(device: torch.device, dtype: torch.dtype = torch.bfloat16
                ) -> Callable[[int, int], int]:
    """resident(tokens, splits) of the card: the CUDA driver's count of
    co-resident clusters of ``splits`` blocks of the wgmma kernel's form
    for ``dtype`` (the float16 form shares the bfloat16 form's counts,
    which the card tests hold; the float32 form has its own)."""
    idx = _device_index(device)
    form = torch.float32 if dtype == torch.float32 else torch.bfloat16
    return functools.partial(_resident, idx, form)


@functools.lru_cache(maxsize=None)
def _resident(idx: int, dtype: torch.dtype, tokens: int, splits: int) -> int:
    n = resident_count(tokens, splits, dtype)
    if n <= 0:
        raise RuntimeError(
            f"int8 GEMM: no cluster of {splits} blocks of the "
            f"{tokens}-token {dtype} wgmma kernel fits (CUDA error {-n})")
    return n


def resident_count(tile: int, splits: int, dtype: torch.dtype) -> int:
    """The CUDA driver's count for the form of ``dtype`` (bfloat16,
    float16 or float32) on the current device: clusters of ``splits``
    blocks of the ``tile``-token wgmma kernel, or, for tile 1 or 2,
    blocks of the small-M kernel of that many token tiles in clusters of
    ``splits`` (negative: a CUDA error)."""
    return _lib().dyn_int8_gemm_resident(tile, splits, _DTYPES[dtype])


def device_plan(M: int, N: int, K: int, device: torch.device,
                dtype: torch.dtype = torch.bfloat16) -> Int8Plan:
    """The plan :func:`int8_matmul` takes for these shapes on a CUDA
    device: :func:`int8_gemm_plan` with the card's SM count and its
    co-resident clusters, searched once a shape."""
    return _device_plan(M, N, K, _device_index(device), dtype)


@functools.lru_cache(maxsize=None)
def _device_plan(M: int, N: int, K: int, idx: int,
                 dtype: torch.dtype) -> Int8Plan:
    sms = torch.cuda.get_device_properties(idx).multi_processor_count
    return int8_gemm_plan(M, N, K, sms, dtype,
                          resident_of(torch.device("cuda", idx), dtype))


def _lib():
    """The kernels' library (``csrc/int8_gemm.cu``)."""
    from .build import library

    lib = library("int8_gemm")
    if not getattr(lib, "_dyn_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dyn_int8_gemm.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.dyn_int8_gemm.restype = i
        lib.dyn_int8_gemm_resident.argtypes = [i, i, i]
        lib.dyn_int8_gemm_resident.restype = i
        lib.dyn_int8_gemm_programmatic.argtypes = [i]
        lib.dyn_int8_gemm_programmatic.restype = i
        lib._dyn_typed = True
    return lib


def set_programmatic(on: bool) -> bool:
    """Switch programmatic launch (PDL) of the small-M route on or off
    (on by default), to time the two; returns the previous setting."""
    return bool(_lib().dyn_int8_gemm_programmatic(int(on)))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def int8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                plan: Optional[Int8Plan] = None) -> torch.Tensor:
    """``(x @ q^T) * s``: x [..., K]; q [N, K] int8, contiguous; s [N]
    float32 (or [1, N]). On the CPU the plain version; on a CUDA device
    a kernel, which takes bfloat16, float16 or float32 x (each route in
    the form of x's dtype), K a multiple of 16, contiguous operands and
    16-byte-aligned x and q, and raises on anything else. ``plan`` overrides :func:`int8_gemm_plan`'s (to time
    one route against another). Returns [..., N] in x's dtype."""
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
    _check(x.dtype in _DTYPES,
           f"the int8 GEMM kernels take bfloat16, float16 or float32 x, "
           f"got {x.dtype}")
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
    if plan is None:
        plan = device_plan(M, N, K, x.device, x.dtype)
    err = _lib().dyn_int8_gemm(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), M, N, K,
        INT8_GEMM_ROUTES.index(plan.route), plan.tile, plan.splits,
        plan.grid, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8 GEMM launch failed: CUDA error {err} "
                           f"(M={M} N={N} K={K} {x.dtype}, {plan})")
    INT8_GEMM_LAUNCHES[launch_key(plan.route, x.dtype)] += 1
    return y
