"""Paged GQA attention: the CUDA kernels' wrappers and their plain versions.

Two kernels, in ``csrc/paged_attention.cu`` (decode) and
``csrc/paged_prefill.cu`` (prefill); the note at the top of each says
what bounds it on an H100 and what its design does about it:

- :func:`paged_attention_decode_layered` (and the 4-D-pool form
  :func:`paged_attention_decode`) replaces the TPU kernel reached through
  ``dynamo_tpu/ops/paged_attention.py`` ``paged_attention_decode_layered``:
  one query per row against the row's pages in ``[lower, length)`` of ONE
  layer of the stacked pool, optionally returning the online-softmax stats
  ``(m, l)``. :func:`paged_attention_decode_window` runs the same kernel
  for one step of the fused decode window (the main path's form): the
  kernel folds the window's in-flight keys into the pool's softmax on
  the card, where the JAX package merges the stats in XLA.
  Decode is bound by the bytes of K/V it reads. The route comes from the
  shape (:func:`decode_route`), never from a failure: bfloat16 at
  head_dim 64/128/256, page size 16/32/64/128 and GQA groups up to 8 (the
  ``llama3_8b`` and ``1b`` presets) run ``paged_decode_bf16_kernel``
  (independent warps, tensor-core products, a per-warp ``cp.async`` ring
  of 16-key blocks; the splits of a row and kv head are one thread-block
  cluster, :func:`decode_cluster_plan`, and fold with the window keys
  through its distributed shared memory), and float16 at the same shapes
  its float16 form (route ``f16_mma``); float32 at head_dim
  16/32/64/128/256, page size 8 to 128 and GQA groups up to 8 (the
  ``tiny``, ``1b`` and ``llama3_8b`` presets in float32) run
  ``paged_decode_f32_kernel``, the same design with float32 rings and
  CUDA-core products; every other shape, in every dtype, runs the
  generic ``paged_decode_generic_kernel`` (route ``generic``: route 1's
  design carried to any shape, ``mma.sync`` products in the call's type,
  3xTF32 in float32, key blocks that cross page boundaries, heads in
  tiles of 16, one cluster launch; the shapes of
  :func:`prefill_generic_shape`, planned by :func:`decode_generic_plan`;
  past head_dim 256 the value columns in tiles of at most 256, one block
  each, every tile taking the scores over the whole head_dim);
  a shape outside that raises. The plans take host-known shapes only.
- :func:`paged_attention_prefill` replaces the TPU kernel reached through
  ``paged_attention_prefill``: chunked-prefill attention with causal
  visibility by absolute ``q_positions`` (-1 = padding) intersected with
  the per-row sliding window ``eff_win``. The route comes from the shape
  (:func:`prefill_route`): ``paged_prefill_bf16_kernel`` (``wgmma`` and a
  TMA ring) for bfloat16 at its shapes, ``paged_prefill_f32_kernel``
  (3xTF32 on ``mma.sync``, the same TMA ring) for float32 at the float32
  decode route's shapes; float16 at the bfloat16 kernel's shapes takes
  its float16 form (route ``f16``). Every other shape, in every dtype,
  runs the generic ``paged_prefill_generic_kernel`` (route ``generic``:
  ``mma.sync`` products in the call's type, 3xTF32 in float32, from a
  ``cp.async`` ring of key blocks that cross page boundaries, so any
  page size and GQA group; any head_dim up to
  :data:`GENERIC_MAX_HEAD_DIM`, :func:`prefill_generic_shape`, planned
  by :func:`prefill_generic_plan`, in value-column tiles past 256 as
  the decode kernel); a shape outside that raises.
- :func:`paged_attention_decode_sharded` (and its window form
  :func:`paged_attention_decode_window_sharded`) and
  :func:`paged_attention_prefill_sharded` replace the JAX package's
  ``shard_map`` wrappers of the same names: one rank's call of the
  kernels above on its own heads and its ``data`` rows (see
  :func:`_data_rows`), no collectives inside.

Each wrapper checks device, dtype, shape and contiguity. For tensors on
the CPU it computes its plain PyTorch version (the CPU tests' path); for
CUDA tensors it launches its kernel on the current stream or raises —
there is no fallback. Every wrapper call that launches adds one to
``LAUNCHES[name]``, once per call (a sharded wrapper's call counts as
a call of its kernel; with a mesh the model calls only the sharded
wrappers): a decode call on any route is one kernel, which folds its
splits and the window keys itself. ``DECODE_ROUTE_LAUNCHES`` and
``PREFILL_ROUTE_LAUNCHES`` count the same calls by route.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch

NEG_INF = -1e30  # finite "masked" value: keeps exp() NaN-free
NO_WINDOW = 1 << 30  # "infinite" effective sliding window (int32-safe)

# launching wrapper calls since the last reset (plain ints): one kernel
# launch each
LAUNCHES: Dict[str, int] = {"paged_attention_decode": 0,
                            "paged_attention_prefill": 0}
# the C entries' route numbers, and the same calls by route (see
# decode_route and prefill_route): route 3 is the float16 form of route
# 1's kernel, so float16 calls count apart from bfloat16's
DECODE_ROUTES = ("generic", "bf16_mma", "f32", "f16_mma")
DECODE_ROUTE_LAUNCHES: Dict[str, int] = {r: 0 for r in DECODE_ROUTES}
PREFILL_ROUTES = ("generic", "bf16", "f32", "f16")
PREFILL_ROUTE_LAUNCHES: Dict[str, int] = {r: 0 for r in PREFILL_ROUTES}

# the dtypes the wrappers take, in the C entries' numbering
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DTYPE_NAMES = "float32/bfloat16/float16"
# shapes the bfloat16 prefill kernel and its float16 form are built for
PREFILL_BF16_HEAD_DIMS = (64, 128, 256)
PREFILL_BF16_PAGE_SIZES = (16, 32, 64, 128)
PREFILL_BF16_MAX_GROUP = 8
# shapes and splits the bfloat16 decode kernel and its float16 form are
# built for (bf16_shape and MAX_SPLITS in csrc/paged_attention.cu, which
# refuses any other; tests/test_torch_kernels.py holds the two sides
# against each other)
DECODE_BF16_HEAD_DIMS = (64, 128, 256)
DECODE_BF16_PAGE_SIZES = (16, 32, 64, 128)
DECODE_BF16_MAX_GROUP = 8
DECODE_BF16_MAX_SPLITS = 8  # one cluster: the portable maximum size
# the cluster sizes the bf16 plan picks from, largest first
DECODE_CLUSTER_SIZES = (8, 4, 2, 1)
# shapes the float32 decode and prefill kernels are built for (f32_shape
# in csrc/attention_common.cuh)
F32_HEAD_DIMS = (16, 32, 64, 128, 256)
F32_PAGE_SIZES = (8, 16, 32, 64, 128)
F32_MAX_GROUP = 8
# shared memory a block may take on an H100 (227 KB, after opting in)
SMEM_LIMIT = 232448
# the generic prefill and decode kernels: any head_dim up to these, by
# dtype (GN_MAX_HD_F32 / GN_MAX_HD_16 in csrc/attention_common.cuh): the
# largest below which every head_dim's plan of both kernels fits a
# block's SMEM_LIMIT (the prefill kernel's in float32, the decode
# kernel's in 16 bits); padded for their products to the next of these
# widths, and past GENERIC_MAX_COLS cut into value-column tiles
GENERIC_MAX_HEAD_DIM = {torch.float32: 656, torch.bfloat16: 576,
                        torch.float16: 576}
PREFILL_GENERIC_HEAD_DIMS = (16, 32, 64, 96, 128, 192, 256)
GENERIC_MAX_COLS = 256


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, DECODE_ROUTE_LAUNCHES, PREFILL_ROUTE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def effective_window(window: int, is_sliding: bool, B: int,
                     device) -> torch.Tensor:
    """Per-row effective sliding window for the kernels: ``window`` on
    sliding layers, :data:`NO_WINDOW` on global ones."""
    return torch.full((B,), window if is_sliding else NO_WINDOW,
                      dtype=torch.int32, device=device)


def _lib():
    """The decode kernels' library (``csrc/paged_attention.cu``)."""
    from .build import library

    lib = library("paged_attention")
    if not getattr(lib, "_dyn_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dyn_paged_attention_decode.argtypes = [
            i, i, p, p, p, ctypes.c_longlong, p, p, p, p, p, p,
            i, i, i, i, i, i, i, i, f, f, p]
        lib.dyn_paged_attention_decode.restype = i
        lib.dyn_paged_attention_decode_window.argtypes = [
            i, i, p, p, p, ctypes.c_longlong, p, p, p, p, p, p, i, i, p,
            i, i, i, i, i, i, i, i, f, f, p]
        lib.dyn_paged_attention_decode_window.restype = i
        lib.dyn_paged_decode_generic_smem.argtypes = [i, i]
        lib.dyn_paged_decode_generic_smem.restype = i
        lib.dyn_paged_decode_clusters.argtypes = [
            i, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        lib.dyn_paged_decode_clusters.restype = i
        lib._dyn_typed = True
    return lib


def _prefill_lib():
    """The prefill kernels' library (``csrc/paged_prefill.cu``)."""
    from .build import library

    lib = library("paged_prefill")
    if not getattr(lib, "_dyn_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dyn_paged_attention_prefill.argtypes = [
            i, i, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, f, p]
        lib.dyn_paged_attention_prefill.restype = i
        lib.dyn_paged_prefill_generic_smem.argtypes = [i, i]
        lib.dyn_paged_prefill_generic_smem.restype = i
        lib._dyn_typed = True
    return lib


_CLUSTERS: Dict[tuple, Dict[int, int]] = {}


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _clusters(device: torch.device, route: int, dtype: torch.dtype, H: int,
              KV: int, ps: int, hd: int) -> Dict[int, int]:
    """Clusters of each size in :data:`DECODE_CLUSTER_SIZES` that the card
    holds at once of the route's decode kernel (0 = generic, 1 = bf16, 2 =
    float32, 3 = float16) in ``dtype`` at this shape, queried once
    (cudaOccupancyMaxActiveClusters)."""
    key = (_device_index(device), route, dtype, H // KV, ps, hd)
    if key not in _CLUSTERS:
        found = {}
        for S in DECODE_CLUSTER_SIZES:
            n = ctypes.c_int(0)
            with torch.cuda.device(key[0]):
                err = _lib().dyn_paged_decode_clusters(
                    route, _DTYPES[dtype], H, KV, ps, hd, S, ctypes.byref(n))
            if err != 0:
                raise RuntimeError(f"decode cluster occupancy query failed: "
                                   f"CUDA error {err} (route {route} "
                                   f"{dtype} H={H} KV={KV} ps={ps} hd={hd} "
                                   f"cluster {S})")
            found[S] = n.value
        _CLUSTERS[key] = found
    return _CLUSTERS[key]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (plain version); False when
    all lie on one CUDA device (kernel). Anything else raises."""
    devs = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devs):
        return True
    if len(devs) == 1 and next(iter(devs)).type == "cuda":
        return False
    raise ValueError(f"paged attention operands on mixed or unsupported "
                     f"devices: {sorted(str(d) for d in devs)}")


def _i32(name: str, t: torch.Tensor, shape: Tuple[int, ...]) -> None:
    _check(t.dtype == torch.int32, f"{name} must be int32, got {t.dtype}")
    _check(tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != {shape}")
    _check(t.is_contiguous(), f"{name} must be contiguous")


# ------------------------------------------------------------------ decode


def paged_attention_decode(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *,
                           scale: Optional[float] = None,
                           return_stats: bool = False,
                           softcap: Optional[float] = None,
                           lower: Optional[torch.Tensor] = None):
    """One decode step against a single-layer pool ``[N, KV, ps, hd]``:
    the layered kernel with L=1 (``unsqueeze`` is a view, no copy)."""
    return paged_attention_decode_layered(
        q, k_pages.unsqueeze(0), v_pages.unsqueeze(0), 0, page_table,
        lengths, scale=scale, return_stats=return_stats, softcap=softcap,
        lower=lower)


def paged_attention_decode_layered(
        q: torch.Tensor, k_pools: torch.Tensor, v_pools: torch.Tensor,
        layer: int, page_table: torch.Tensor, lengths: torch.Tensor, *,
        scale: Optional[float] = None, return_stats: bool = False,
        softcap: Optional[float] = None,
        lower: Optional[torch.Tensor] = None
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Paged GQA decode attention against ONE layer of the stacked pools.

    q: [B, H, hd]; k_pools/v_pools: [L, N, KV, ps, hd] (same dtype as q,
    float32, bfloat16 or float16); layer: int; page_table: [B, P] int32
    (padded with 0); lengths: [B] int32 — context per row INCLUDING the
    token just written (0 = padding row → zeros); lower: [B] int32 first
    visible position (sliding window), default 0.
    Returns out [B, H, hd] in q.dtype; with ``return_stats`` also the
    online-softmax stats (m, l) as float32 [B, H] — an all-masked view
    gives m = NEG_INF, l = 0.
    """
    _check(q.dim() == 3, f"q must be [B, H, hd], got {tuple(q.shape)}")
    B, H, hd = q.shape
    _check(k_pools.dim() == 5 and k_pools.shape == v_pools.shape,
           "k_pools/v_pools must both be [L, N, KV, ps, hd]")
    L, N, KV, ps, hd_k = k_pools.shape
    _check(hd_k == hd and H % KV == 0, "head_dim / GQA mismatch")
    _check(q.dtype in _DTYPES and k_pools.dtype == q.dtype
           and v_pools.dtype == q.dtype,
           f"dtypes must match and be {_DTYPE_NAMES}: "
           f"{q.dtype}, {k_pools.dtype}, {v_pools.dtype}")
    layer = int(layer)
    _check(0 <= layer < L, f"layer {layer} out of range [0, {L})")
    _check(page_table.dim() == 2 and page_table.shape[0] == B,
           "page_table must be [B, P]")
    P = page_table.shape[1]
    _i32("page_table", page_table, (B, P))
    _i32("lengths", lengths, (B,))
    if lower is None:
        lower = torch.zeros_like(lengths)
    _i32("lower", lower, (B,))
    for name, t in (("q", q), ("k_pools", k_pools), ("v_pools", v_pools)):
        _check(t.is_contiguous(), f"{name} must be contiguous")
    if scale is None:
        scale = hd ** -0.5
    if _on_cpu(q, k_pools, v_pools, page_table, lengths, lower):
        out, m, l = decode_reference(q, k_pools, v_pools, layer, page_table,
                                     lengths, lower, scale, softcap)
        return (out, m, l) if return_stats else out
    route, splits = _decode_launch_plan(q, k_pools, v_pools, B, P)
    out = torch.empty_like(q)
    m = l = None
    if return_stats:
        m = torch.empty((B, H), dtype=torch.float32, device=q.device)
        l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    err = _lib().dyn_paged_attention_decode(
        route, _DTYPES[q.dtype], q.data_ptr(), k_pools.data_ptr(),
        v_pools.data_ptr(), layer, page_table.data_ptr(), lengths.data_ptr(),
        lower.data_ptr(), out.data_ptr(),
        m.data_ptr() if m is not None else None,
        l.data_ptr() if l is not None else None,
        B, H, KV, N, ps, hd, P, splits, float(scale), float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_decode launch failed: CUDA "
                           f"error {err} (B={B} H={H} KV={KV} ps={ps} "
                           f"hd={hd} route {DECODE_ROUTES[route]})")
    LAUNCHES["paged_attention_decode"] += 1
    DECODE_ROUTE_LAUNCHES[DECODE_ROUTES[route]] += 1
    return (out, m, l) if return_stats else out


def _f32_shape(dtype: torch.dtype, H: int, KV: int, ps: int,
               hd: int) -> bool:
    return (dtype == torch.float32 and hd in F32_HEAD_DIMS
            and ps in F32_PAGE_SIZES and H // KV <= F32_MAX_GROUP)


def decode_route(dtype: torch.dtype, H: int, KV: int, ps: int,
                 hd: int) -> int:
    """The decode kernel a shape runs on, by shape alone: 1 (``bf16_mma``,
    ``paged_decode_bf16_kernel``) for bfloat16 and 3 (``f16_mma``, its
    float16 form) for float16 at the ``DECODE_BF16_*`` head dims, page
    sizes and GQA groups, 2 (``f32``, ``paged_decode_f32_kernel``) for
    float32 at the ``F32_*`` ones, else 0 (``generic``,
    ``paged_decode_generic_kernel``, in every dtype; it takes the shapes
    of :func:`prefill_generic_shape`)."""
    if (dtype in (torch.bfloat16, torch.float16)
            and hd in DECODE_BF16_HEAD_DIMS
            and ps in DECODE_BF16_PAGE_SIZES
            and H // KV <= DECODE_BF16_MAX_GROUP):
        return 1 if dtype == torch.bfloat16 else 3
    return 2 if _f32_shape(dtype, H, KV, ps, hd) else 0


def prefill_route(dtype: torch.dtype, H: int, KV: int, ps: int,
                  hd: int) -> int:
    """The prefill kernel a shape runs on, by shape alone: 1 (``bf16``,
    ``paged_prefill_bf16_kernel``) for bfloat16 and 3 (``f16``, its
    float16 form) for float16 at the ``PREFILL_BF16_*`` head dims, page
    sizes and GQA groups, 2 (``f32``, ``paged_prefill_f32_kernel``) for
    float32 at the ``F32_*`` ones, else 0 (``generic``,
    ``paged_prefill_generic_kernel``, in every dtype; it takes the shapes
    of :func:`prefill_generic_shape`)."""
    if (dtype in (torch.bfloat16, torch.float16)
            and hd in PREFILL_BF16_HEAD_DIMS
            and ps in PREFILL_BF16_PAGE_SIZES
            and H // KV <= PREFILL_BF16_MAX_GROUP):
        return 1 if dtype == torch.bfloat16 else 3
    return 2 if _f32_shape(dtype, H, KV, ps, hd) else 0


def decode_f32_smem(hd: int) -> int:
    """Shared memory of a block of the float32 decode kernel
    (``DecodeF32Tile<hd>::SMEM`` in csrc/paged_attention.cu, which the
    card tests hold this equal to): four warps' rings of 3 stages of K
    and V of 8 keys, the window's K and V rows (16 slots) and scores, the
    stages' mbarriers."""
    ring = 4 * 3 * 2 * 8 * hd * 4
    merge = 4 * (4 * 8 * hd + 3 * 4 * 8 + 2 * 8 + 8 * 8 + 8)
    return max(ring, merge) + 2 * 16 * hd * 4 + 4 * 8 * 16 + 4 * 3 * 8


def prefill_f32_smem(hd: int, ps: int) -> int:
    """Shared memory of a block of the float32 prefill kernel
    (``f32_tile_smem`` in csrc/paged_prefill.cu, which the card tests
    hold this equal to): 1 KB of alignment slack, Q [64, hd], two stages
    of K and V of min(ps, 64, 4096 // hd) keys, the stages' mbarriers."""
    kb = min(ps, 16 if hd >= 256 else 32 if hd >= 128 else 64)
    return 1024 + 64 * hd * 4 + 2 * 2 * kb * hd * 4 + 2 * 2 * 8


def prefill_generic_shape(dtype: torch.dtype, hd: int) -> bool:
    """Whether the generic prefill kernel, and the generic decode kernel
    with it, take head_dim ``hd`` in ``dtype`` (``generic_shape`` in
    csrc/attention_common.cuh): any page size and GQA group, any head_dim
    from 1 to ``GENERIC_MAX_HEAD_DIM[dtype]`` (rows that are not 16-byte
    multiples take narrower copies, zero-filled to the padded width)."""
    return 1 <= hd <= GENERIC_MAX_HEAD_DIM.get(dtype, 0)


def generic_columns(hd: int) -> Tuple[int, int, int]:
    """How both generic kernels take head_dim ``hd`` (``gn_qk_width``,
    ``gn_col_width`` and ``gn_col_tiles`` in csrc/attention_common.cuh):
    ``(qk_width, col_width, col_tiles)``. Up to
    :data:`GENERIC_MAX_COLS`, one tile of ``hd`` columns at the padded
    width; past it (the wide form) Q and K whole at ``hd`` padded to 16
    for the scores, and the value columns in ``col_tiles`` tiles of
    ``col_width`` (a multiple of 8; the last may be narrower), one block
    each."""
    if hd <= GENERIC_MAX_COLS:
        return next(w for w in PREFILL_GENERIC_HEAD_DIMS if w >= hd), hd, 1
    tiles = -(-hd // GENERIC_MAX_COLS)
    width = -(-(-(-hd // tiles)) // 8) * 8
    return -(-hd // 16) * 16, width, -(-hd // width)


class GenericPrefillPlan(NamedTuple):
    """How the generic prefill kernel cuts one call (its launch in
    csrc/paged_prefill.cu): a block owns ``rows`` (query, head) rows,
    ``queries`` queries times ``heads`` heads of one (row, kv head) and
    head tile (``head_tiles`` a kv head: one past 64 heads) and column
    tile (``col_tiles`` of ``col_width`` value columns, padded to
    ``col_pad`` for P V); it walks key blocks of ``keys`` positions in a
    ring of ``stages``, Q and K at head_dim ``head_dim`` (padded);
    ``smem`` bytes of shared memory a block."""
    rows: int
    queries: int
    heads: int
    head_tiles: int
    keys: int
    stages: int
    head_dim: int
    smem: int
    col_tiles: int
    col_width: int
    col_pad: int


def prefill_generic_plan(G: int, ps: int, hd: int,
                         dtype: torch.dtype) -> GenericPrefillPlan:
    """The generic prefill kernel's plan at GQA group ``G``, page size
    ``ps`` and head_dim ``hd`` in ``dtype``: a mirror of ``gn_hdp``,
    ``gn_keys`` and ``gn_smem`` in csrc/paged_prefill.cu, whose
    ``dyn_paged_prefill_generic_smem`` the card tests hold equal to
    ``smem``. The page size changes nothing: key blocks cross pages."""
    rows = 64
    heads = min(G, rows)
    qw, cw, tiles = generic_columns(hd)
    hdp = next(w for w in PREFILL_GENERIC_HEAD_DIMS if w >= cw)
    esize = 4 if dtype == torch.float32 else 2
    if hd > GENERIC_MAX_COLS:  # the wide form: whole Q and K rows
        keys = 8 if esize == 4 else 32
    elif esize == 4:
        keys = 64 if hdp <= 64 else 32 if hdp <= 128 else 16
    else:
        keys = 64 if hdp <= 128 else 32
    stages = 2
    v_stride = hdp + 4 if esize == 4 else hdp + 8
    smem = ((rows * (qw + 8) + stages * keys * (qw + 8 + v_stride))
            * esize + stages * keys * 4 + 2 * keys * 8)
    return GenericPrefillPlan(rows, rows // heads, heads, -(-G // rows),
                              keys, stages, qw, smem, tiles, cw, hdp)


class GenericDecodePlan(NamedTuple):
    """How the generic decode kernel cuts one call (its launch in
    csrc/paged_attention.cu): a block owns one (row, kv head, head tile),
    ``heads`` of the group's heads in ``rows`` m16 rows (``head_tiles`` a
    kv head); its four warps walk key blocks of ``keys`` positions, each
    in a ring of ``stages``, Q and K at head_dim ``head_dim`` (padded); a
    row takes one live split for each ``ring_keys`` keys (one ring of
    blocks) it fills; ``smem`` bytes of shared memory a block. Each
    block folds and writes one tile of ``col_width`` value columns
    (``col_tiles`` of them, padded to ``col_pad`` for P V)."""
    rows: int
    heads: int
    head_tiles: int
    keys: int
    stages: int
    head_dim: int
    ring_keys: int
    smem: int
    col_tiles: int
    col_width: int
    col_pad: int


def decode_generic_plan(G: int, ps: int, hd: int,
                        dtype: torch.dtype) -> GenericDecodePlan:
    """The generic decode kernel's plan at GQA group ``G``, page size
    ``ps`` and head_dim ``hd`` in ``dtype``: a mirror of ``dg_keys``,
    ``dg_smem`` and the launch in csrc/paged_attention.cu, whose
    ``dyn_paged_decode_generic_smem`` the card tests hold equal to
    ``smem``. The page size changes nothing: key blocks cross pages."""
    rows, warps = 16, 4
    qw, cw, tiles = generic_columns(hd)
    hdp = next(w for w in PREFILL_GENERIC_HEAD_DIMS if w >= cw)
    esize = 4 if dtype == torch.float32 else 2
    # the wide form's rings hold whole K rows: fewer stages (dg_stages)
    stages = 3 if hd <= GENERIC_MAX_COLS else 1 if esize == 4 else 2
    keys = 8 if esize == 4 else 16
    v_stride = hdp + 4 if esize == 4 else hdp + 8
    ring = (rows * (qw + 8)
            + warps * stages * keys * (qw + 8 + v_stride)) * esize
    merge = 4 * (warps * rows * hdp + 3 * warps * rows + 2 * rows
                 + rows * DECODE_BF16_MAX_SPLITS + rows)
    smem = max(ring, merge) + warps * stages * (keys * 8 + 4)
    return GenericDecodePlan(rows, min(G, rows), -(-G // rows), keys,
                             stages, qw, warps * stages * keys, smem,
                             tiles, cw, hdp)


def decode_generic_splits_cap(P: int, ps: int, plan: GenericDecodePlan) -> int:
    """The most splits the generic kernel can give keys to, for a page
    table of ``P`` entries: a row's key blocks cover at most ``P * ps``
    positions, and it takes one live split for each ring of blocks
    (``plan.ring_keys`` keys, a ring of each warp's stages) that
    its blocks fill."""
    blocks = -(-(P * ps) // plan.keys)
    return max(1, -(-blocks // (plan.ring_keys // plan.keys)))


def decode_generic_shares(lo: int, length: int, P: int, ps: int, S: int,
                          plan: GenericDecodePlan) -> List[Tuple[int, int]]:
    """The generic kernel's cut of one row over a cluster of ``S``
    splits (``jb`` and ``nb`` in csrc/paged_attention.cu): the key blocks
    ``[first, first + n)`` of ``plan.keys`` positions that each live
    split walks, in split order. The row's blocks cover its extent
    ``[lo, min(length, P * ps))``, cut into near-equal shares, one for
    each ring of blocks the row fills (``plan.ring_keys`` keys) up to
    ``S``: a live split takes half a ring at least once there are two;
    the other splits take none."""
    kb, end = plan.keys, min(length, P * ps)
    first = lo // kb
    n = -(-end // kb) - first if end > lo else 0
    live = min(S, -(-n // (plan.ring_keys // kb)))
    cuts = [first + n * s // max(live, 1) for s in range(live + 1)]
    return [(cuts[s], cuts[s + 1] - cuts[s]) for s in range(live)]


def decode_cluster_plan(B: int, KV: int, P: int,
                        clusters: Dict[int, int]) -> int:
    """A decode kernel's splits per (row, kv head), one thread-block
    cluster, from host-known shapes only: the largest size of
    :data:`DECODE_CLUSTER_SIZES`, at most ``P``, of which the card holds
    all ``B * KV`` clusters at once (``clusters[S]``, from
    cudaOccupancyMaxActiveClusters), else 1. The kernel cuts a row's
    visible pages into at most that many contiguous shares of at least
    one ring of keys each (``db_min_pages`` in csrc/paged_attention.cu):
    short rows leave the cluster's last splits idle. The generic kernel
    takes it with ``KV`` its kv heads times head tiles and ``P`` the
    splits a row can fill (:func:`decode_generic_splits_cap`), and cuts
    a row's key blocks, not its pages (:func:`decode_generic_shares`)."""
    pairs = B * KV
    for S in DECODE_CLUSTER_SIZES:
        if S <= P and pairs <= clusters.get(S, 0):
            return S
    return 1


def _decode_launch_plan(q: torch.Tensor, k_pools: torch.Tensor,
                        v_pools: torch.Tensor, B: int,
                        P: int) -> Tuple[int, int]:
    """Route and splits of one decode call on the card; raises for shapes
    no kernel takes."""
    H, hd = q.shape[1], q.shape[2]
    KV, ps = k_pools.shape[2], k_pools.shape[3]
    G = H // KV
    route = decode_route(q.dtype, H, KV, ps, hd)
    if route == 0:
        _check(prefill_generic_shape(q.dtype, hd),
               f"{q.dtype} generic decode kernel takes head_dim up to "
               f"{GENERIC_MAX_HEAD_DIM[q.dtype]} "
               f"(got head_dim {hd}, page_size {ps}, group {G})")
    _check(k_pools.data_ptr() % 16 == 0 and v_pools.data_ptr() % 16 == 0,
           "pools must be 16-byte aligned (16-byte page copies)")
    _check(route not in (0, 2) or q.data_ptr() % 16 == 0,
           "q must be 16-byte aligned (16-byte loads)")
    clusters = _clusters(q.device, route, q.dtype, H, KV, ps, hd)
    if route != 0:
        return route, decode_cluster_plan(B, KV, P, clusters)
    plan = decode_generic_plan(G, ps, hd, q.dtype)
    return route, decode_cluster_plan(
        B, KV * plan.head_tiles * plan.col_tiles,
        decode_generic_splits_cap(P, ps, plan), clusters)


def paged_attention_decode_window(
        q: torch.Tensor, k_pools: torch.Tensor, v_pools: torch.Tensor,
        layer: int, page_table: torch.Tensor, start: torch.Tensor,
        q_pos: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor, n_win: int,
        *, scale: Optional[float] = None, softcap: Optional[float] = None,
        eff_win: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode attention for one step of the fused decode window: the
    (frozen) pool of ONE layer for positions < start, plus the in-flight
    window buffer for positions start .. start + n_win - 1, in one softmax.
    The kernel side of ``dynamo_tpu/models/llama.py``
    ``_pool_window_attention_pallas``, whose merge of the decode kernel's
    (m, l) stats with the buffer here runs inside the decode kernel on
    the card.

    q: [B, H, hd]; k_pools/v_pools: [L, N, KV, ps, hd]; page_table: [B, P]
    int32; start: [B] int32 first window position (-1 = padding row);
    q_pos: [B] int32 current query position; wk/wv: [B, Kw, KV, hd] (slot w
    holds position start + w); n_win: valid slots (step index + 1);
    eff_win: [B] int32 sliding window (None = none). On sliding layers only
    positions > q_pos - eff_win are visible, on both sides.
    Returns [B, H, hd] in q.dtype (padding rows give zeros).
    """
    _check(q.dim() == 3, f"q must be [B, H, hd], got {tuple(q.shape)}")
    B, H, hd = q.shape
    _check(k_pools.dim() == 5 and k_pools.shape == v_pools.shape,
           "k_pools/v_pools must both be [L, N, KV, ps, hd]")
    L, N, KV, ps, hd_k = k_pools.shape
    _check(wk.dim() == 4 and wk.shape == wv.shape and wk.shape[0] == B
           and wk.shape[2:] == (KV, hd), "wk/wv must both be [B, Kw, KV, hd]")
    Kw = wk.shape[1]
    _check(hd_k == hd and H % KV == 0, "head_dim / GQA mismatch")
    _check(q.dtype in _DTYPES and all(t.dtype == q.dtype for t in
                                      (k_pools, v_pools, wk, wv)),
           f"dtypes must match and be {_DTYPE_NAMES}: "
           f"{q.dtype}, {k_pools.dtype}, {v_pools.dtype}, {wk.dtype}, "
           f"{wv.dtype}")
    layer = int(layer)
    _check(0 <= layer < L, f"layer {layer} out of range [0, {L})")
    _check(1 <= n_win <= Kw, f"n_win {n_win} out of range [1, {Kw}]")
    _check(page_table.dim() == 2 and page_table.shape[0] == B,
           "page_table must be [B, P]")
    P = page_table.shape[1]
    _i32("page_table", page_table, (B, P))
    _i32("start", start, (B,))
    _i32("q_pos", q_pos, (B,))
    if eff_win is not None:
        _i32("eff_win", eff_win, (B,))
    for name, t in (("q", q), ("k_pools", k_pools), ("v_pools", v_pools),
                    ("wk", wk), ("wv", wv)):
        _check(t.is_contiguous(), f"{name} must be contiguous")
    if scale is None:
        scale = hd ** -0.5
    operands = [q, k_pools, v_pools, page_table, start, q_pos, wk, wv]
    if _on_cpu(*operands, *([eff_win] if eff_win is not None else [])):
        return window_reference(q, k_pools, v_pools, layer, page_table,
                                start, q_pos, wk, wv, n_win, scale, softcap,
                                eff_win)
    route, splits = _decode_launch_plan(q, k_pools, v_pools, B, P)
    _check(all(t.data_ptr() % 16 == 0 for t in (q, wk, wv)),
           "q, wk and wv must be 16-byte aligned (16-byte loads)")
    out = torch.empty_like(q)
    err = _lib().dyn_paged_attention_decode_window(
        route, _DTYPES[q.dtype], q.data_ptr(), k_pools.data_ptr(),
        v_pools.data_ptr(), layer, page_table.data_ptr(), start.data_ptr(),
        q_pos.data_ptr(), eff_win.data_ptr() if eff_win is not None else None,
        wk.data_ptr(), wv.data_ptr(), n_win, Kw, out.data_ptr(),
        B, H, KV, N, ps, hd, P,
        splits, float(scale), float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_decode_window launch failed: "
                           f"CUDA error {err} (B={B} H={H} KV={KV} ps={ps} "
                           f"hd={hd} Kw={Kw} route {DECODE_ROUTES[route]})")
    LAUNCHES["paged_attention_decode"] += 1
    DECODE_ROUTE_LAUNCHES[DECODE_ROUTES[route]] += 1
    return out


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of float32 scores for the plain paths, evaluated in float64
    and rounded once to float32: the correctly rounded value in effect,
    whatever code path the host's math library takes for float32 (on the
    CPU, MKL picks its own by the processor: its float32 ``exp`` gives
    other bits under another ``MKL_ENABLE_INSTRUCTIONS`` or ``MKL_CBWR``).
    Returns float32."""
    return torch.exp(x.double()).float()


def window_reference(q, k_pools, v_pools, layer: int, page_table, start,
                     q_pos, wk, wv, n_win: int, scale: float,
                     softcap: Optional[float] = None, eff_win=None):
    """Plain PyTorch version of :func:`paged_attention_decode_window`:
    the decode kernel's plain version with stats over the pool, then the
    online-softmax merge with the buffer's visible slots (exp only where
    visible)."""
    B, H, hd = q.shape
    KV, Kw = wk.shape[2], wk.shape[1]
    G = H // KV
    lengths = start.clamp(min=0).to(torch.int32)
    lower = torch.zeros_like(lengths)
    floor = None
    if eff_win is not None:
        lower = torch.minimum((q_pos + 1 - eff_win).clamp(min=0),
                              lengths).to(torch.int32)
        floor = (q_pos - eff_win).long()
    out_p, m_p, l_p = decode_reference(q, k_pools, v_pools, layer, page_table,
                                       lengths, lower, scale, softcap)
    qg = q.reshape(B, KV, G, hd).float()
    sw = torch.einsum("bkgh,bwkh->bkgw", qg, wk.float()) * scale
    if softcap:
        sw = softcap * torch.tanh(sw / softcap)
    slot = torch.arange(Kw, device=q.device)[None, :]
    vis = (slot < n_win) & (start[:, None] >= 0)
    if floor is not None:
        vis = vis & (start[:, None].long() + slot > floor[:, None])
    vis = vis[:, None, None, :]                        # [B, 1, 1, Kw]
    sw = torch.where(vis, sw, torch.full_like(sw, NEG_INF))
    m = torch.maximum(m_p.reshape(B, KV, G), sw.amax(dim=-1))
    a_p = exp_f32(m_p.reshape(B, KV, G) - m) * l_p.reshape(B, KV, G)
    p_w = torch.where(vis, exp_f32(sw - m[..., None]), torch.zeros_like(sw))
    l = torch.clamp(a_p + p_w.sum(dim=-1), min=1e-9)
    out = (out_p.reshape(B, KV, G, hd).float() * a_p[..., None]
           + torch.einsum("bkgw,bwkh->bkgh", p_w, wv.float())) / l[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


def decode_reference(q, k_pools, v_pools, layer: int, page_table, lengths,
                     lower, scale: float, softcap: Optional[float] = None):
    """Plain PyTorch version of the decode kernel: gather the row's pages,
    masked online-softmax math in float32 (exp only where visible, by
    :func:`exp_f32`).
    Returns (out [B, H, hd] in q.dtype, m [B, H], l [B, H])."""
    B, H, hd = q.shape
    _, _, KV, ps, _ = k_pools.shape
    P = page_table.shape[1]
    G = H // KV
    idx = page_table.long()
    k = k_pools[layer][idx].permute(0, 2, 1, 3, 4).reshape(B, KV, P * ps, hd)
    v = v_pools[layer][idx].permute(0, 2, 1, 3, 4).reshape(B, KV, P * ps, hd)
    qg = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgh,bksh->bkgs", qg, k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(P * ps, device=q.device)
    valid = ((pos[None, :] >= lower[:, None].long())
             & (pos[None, :] < lengths[:, None].long()))[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = torch.clamp(s.amax(dim=-1), min=NEG_INF)
    p = torch.where(valid, exp_f32(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    out = torch.einsum("bkgs,bksh->bkgh", p, v.float())
    out = out / torch.clamp(l, min=1e-9)[..., None]
    return (out.reshape(B, H, hd).to(q.dtype), m.reshape(B, H),
            l.reshape(B, H))


# ----------------------------------------------------------------- prefill


def paged_attention_prefill(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, page_table: torch.Tensor,
                            q_positions: torch.Tensor, *,
                            scale: Optional[float] = None,
                            softcap: Optional[float] = None,
                            eff_win: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Chunked-prefill paged GQA attention.

    q: [B, T, H, hd] (the current chunk, its K/V already in the pool);
    k_pages/v_pages: [N, KV, ps, hd] — one layer (``pool[l]`` of the
    stacked pool is a view, no copy); page_table: [B, P] int32;
    q_positions: [B, T] int32 absolute (-1 padding); eff_win: [B] int32
    per-row window (default :data:`NO_WINDOW`). Key position j is visible
    to query t iff ``q_pos[t] - eff_win < j <= q_pos[t]``. Returns
    [B, T, H, hd] in q.dtype; padding queries give zeros.
    """
    _check(q.dim() == 4, f"q must be [B, T, H, hd], got {tuple(q.shape)}")
    B, T, H, hd = q.shape
    _check(k_pages.dim() == 4 and k_pages.shape == v_pages.shape,
           "k_pages/v_pages must both be [N, KV, ps, hd]")
    N, KV, ps, hd_k = k_pages.shape
    _check(hd_k == hd and H % KV == 0, "head_dim / GQA mismatch")
    _check(q.dtype in _DTYPES and k_pages.dtype == q.dtype
           and v_pages.dtype == q.dtype,
           f"dtypes must match and be {_DTYPE_NAMES}: "
           f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    _check(page_table.dim() == 2 and page_table.shape[0] == B,
           "page_table must be [B, P]")
    P = page_table.shape[1]
    _i32("page_table", page_table, (B, P))
    _i32("q_positions", q_positions, (B, T))
    if eff_win is None:
        eff_win = torch.full((B,), NO_WINDOW, dtype=torch.int32,
                             device=q.device)
    _i32("eff_win", eff_win, (B,))
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        _check(t.is_contiguous(), f"{name} must be contiguous")
    if scale is None:
        scale = hd ** -0.5
    if _on_cpu(q, k_pages, v_pages, page_table, q_positions, eff_win):
        return prefill_reference(q, k_pages, v_pages, page_table,
                                 q_positions, scale, softcap, eff_win)

    G = H // KV
    route = prefill_route(q.dtype, H, KV, ps, hd)
    if route == 0:
        _check(prefill_generic_shape(q.dtype, hd),
               f"{q.dtype} generic prefill kernel takes head_dim up to "
               f"{GENERIC_MAX_HEAD_DIM[q.dtype]} "
               f"(got head_dim {hd}, page_size {ps}, group {G})")
    _check(all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)),
           "q and the pools must be 16-byte aligned (16-byte loads)")
    lib = _prefill_lib()
    out = torch.empty_like(q)
    err = lib.dyn_paged_attention_prefill(
        route, _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), q_positions.data_ptr(),
        eff_win.data_ptr(), out.data_ptr(), B, T, H, KV, N, ps, hd, P,
        float(scale), float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_prefill launch failed: CUDA "
                           f"error {err} (B={B} T={T} H={H} KV={KV} ps={ps} "
                           f"hd={hd} route {PREFILL_ROUTES[route]})")
    LAUNCHES["paged_attention_prefill"] += 1
    PREFILL_ROUTE_LAUNCHES[PREFILL_ROUTES[route]] += 1
    return out


def prefill_reference(q, k_pages, v_pages, page_table, q_positions,
                      scale: float, softcap: Optional[float] = None,
                      eff_win: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the prefill kernel: the gather path of
    ``dynamo_tpu/models/llama.py`` ``_paged_attention`` (which builds the
    dense ``[B, P*ps, KV, hd]`` view of the row's pages), with float32
    probabilities and zeros for padding queries (q_pos < 0) as the kernel
    gives."""
    B, T, H, hd = q.shape
    _, KV, ps, _ = k_pages.shape
    P = page_table.shape[1]
    S = P * ps
    G = H // KV
    idx = page_table.long()
    k = k_pages[idx].permute(0, 1, 3, 2, 4).reshape(B, S, KV, hd)
    v = v_pages[idx].permute(0, 1, 3, 2, 4).reshape(B, S, KV, hd)
    qg = q.reshape(B, T, KV, G, hd)
    s = torch.einsum("btkgh,bskh->bkgts", qg.float(), k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qp = q_positions.long()[:, :, None]                 # [B, T, 1]
    kvp = torch.arange(S, device=q.device)[None, None, :]
    visible = kvp <= qp
    if eff_win is not None:
        visible = visible & (kvp > qp - eff_win.long()[:, None, None])
    vis = visible[:, None, None, :, :]                  # [B, 1, 1, T, S]
    s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v.float())
    out = torch.where((q_positions >= 0)[:, :, None, None, None], out,
                      torch.zeros_like(out))
    return out.reshape(B, T, H, hd).to(q.dtype)


# --------------------------------------------------------- tensor parallel


def _data_rows(mesh, B: int, kv_heads: int, local_kv: int) -> slice:
    """The rows of a ``B``-row batch that ``mesh``'s rank attends to (its
    block on the ``data`` axis), once the batch and the kv heads are
    seen to split. Where they do not, the JAX package's model takes
    XLA's gather path instead of its sharded kernel
    (``dynamo_tpu/models/llama.py`` ``_attention``); on the card that
    would hide the kernel, so this raises."""
    if kv_heads % mesh.model:
        raise ValueError(f"{kv_heads} kv heads do not split over "
                         f"model={mesh.model}")
    if local_kv != kv_heads // mesh.model:
        raise ValueError(f"the pool shard holds {local_kv} kv heads; a "
                         f"rank of model={mesh.model} holds "
                         f"{kv_heads // mesh.model} of {kv_heads}")
    if B % mesh.data:
        raise ValueError(f"{B} rows do not split over data={mesh.data}")
    n = B // mesh.data
    return slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)


def paged_attention_decode_sharded(
        q: torch.Tensor, k_pools: torch.Tensor, v_pools: torch.Tensor,
        layer: int, page_table: torch.Tensor, lengths: torch.Tensor, *,
        mesh, kv_heads: int, scale: Optional[float] = None,
        return_stats: bool = True, softcap: Optional[float] = None,
        lower: Optional[torch.Tensor] = None):
    """One rank's part of the JAX package's
    ``paged_attention_decode_sharded`` (``shard_map`` of the layered decode
    kernel, heads with their kv heads over ``model``, rows over ``data``):
    the decode kernel on the rank's heads and its rows.

    q: [B, H/model, hd], the rank's q heads of every row; k_pools/v_pools:
    the rank's pool shard [L, N, kv_heads/model, ps, hd]
    (``parallel/mesh.py`` ``shard_kv_cache``); page_table [B, P],
    lengths and lower [B]: every row; kv_heads: the model's kv heads over
    all ranks; mesh: the rank's ``MeshView``. Returns the rank's block:
    out [B/data, H/model, hd] and, with ``return_stats``, (m, l)
    [B/data, H/model] float32."""
    rows = _data_rows(mesh, q.shape[0], kv_heads, k_pools.shape[2])
    return paged_attention_decode_layered(
        q[rows], k_pools, v_pools, layer, page_table[rows], lengths[rows],
        scale=scale, return_stats=return_stats, softcap=softcap,
        lower=lower[rows] if lower is not None else None)


def paged_attention_decode_window_sharded(
        q: torch.Tensor, k_pools: torch.Tensor, v_pools: torch.Tensor,
        layer: int, page_table: torch.Tensor, start: torch.Tensor,
        q_pos: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor, n_win: int,
        *, mesh, kv_heads: int, scale: Optional[float] = None,
        softcap: Optional[float] = None,
        eff_win: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The window form of :func:`paged_attention_decode_sharded`, the one
    the fused decode window takes (the JAX package reaches its sharded
    wrapper there, ``dynamo_tpu/models/llama.py``
    ``_pool_window_attention_pallas``): :func:`paged_attention_decode_window`
    on the rank's heads and rows. wk/wv: [B, Kw, kv_heads/model, hd], the
    rank's kv heads of every row; other operands as there, every row.
    Returns [B/data, H/model, hd]."""
    rows = _data_rows(mesh, q.shape[0], kv_heads, k_pools.shape[2])
    return paged_attention_decode_window(
        q[rows], k_pools, v_pools, layer, page_table[rows], start[rows],
        q_pos[rows], wk[rows], wv[rows], n_win, scale=scale, softcap=softcap,
        eff_win=eff_win[rows] if eff_win is not None else None)


def paged_attention_prefill_sharded(
        q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        page_table: torch.Tensor, q_positions: torch.Tensor, *, mesh,
        kv_heads: int, scale: Optional[float] = None,
        softcap: Optional[float] = None,
        eff_win: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One rank's part of the JAX package's
    ``paged_attention_prefill_sharded``: :func:`paged_attention_prefill`
    on the rank's heads and rows. q: [B, T, H/model, hd], the rank's q
    heads of every row; k_pages/v_pages: one layer of the rank's pool
    shard [N, kv_heads/model, ps, hd]; page_table [B, P], q_positions
    [B, T], eff_win [B]: every row. Returns [B/data, T, H/model, hd]."""
    rows = _data_rows(mesh, q.shape[0], kv_heads, k_pages.shape[1])
    return paged_attention_prefill(
        q[rows], k_pages, v_pages, page_table[rows], q_positions[rows],
        scale=scale, softcap=softcap,
        eff_win=eff_win[rows] if eff_win is not None else None)


def prefill_work(q_positions: torch.Tensor,
                 eff_win: Optional[torch.Tensor] = None
                 ) -> Tuple[int, int, int]:
    """The work one prefill call must do, counted from its inputs:
    ``(queries, pairs, kv_positions)`` summed over rows — the valid
    queries (q_pos >= 0), the visible (query, key) pairs (each query sees
    ``min(q_pos + 1, eff_win)`` keys), and the K/V positions some query of
    the row sees (the union of the queries' visible ranges). A kernel's
    bound follows: ``4 * pairs * H * hd`` operations; Q and the output
    moved once per query and head, K and V once per position and kv head.
    """
    qp = q_positions.long()
    B = qp.shape[0]
    win = (eff_win.long()[:, None] if eff_win is not None
           else torch.full((B, 1), NO_WINDOW, dtype=torch.long,
                           device=qp.device))
    valid = qp >= 0
    if not bool(valid.any()):
        return 0, 0, 0
    lo = (qp - win + 1).clamp(min=0)
    pairs = int(torch.where(valid, qp - lo + 1, 0).sum())
    # union of the rows' intervals [lo, qp]: +1 at lo, -1 past qp (slot S
    # collects the padding queries), covered where the running sum > 0
    S = int(qp.max()) + 2
    diff = torch.zeros((B, S + 1), dtype=torch.long, device=qp.device)
    ones = torch.ones_like(qp)
    diff.scatter_add_(1, torch.where(valid, lo, S), ones)
    diff.scatter_add_(1, torch.where(valid, qp + 1, S), -ones)
    kv_positions = int((diff[:, :S].cumsum(1) > 0).sum())
    return int(valid.sum()), pairs, kv_positions


def decode_work(lengths: torch.Tensor, lower: Optional[torch.Tensor] = None,
                window_keys: Optional[torch.Tensor] = None, *, heads: int,
                kv_heads: int, head_dim: int, elem_bytes: int
                ) -> Tuple[int, int, int]:
    """The work one decode call must do, counted from its inputs:
    ``(rows, kv_positions, bytes)``. ``kv_positions`` sums over rows the
    pool positions in ``[lower, lengths)`` plus the row's visible
    in-flight keys (``window_keys``, the window form); ``rows`` counts the
    rows that see at least one key. ``bytes`` reads K and V once per
    position and kv head, and q and the output once per live row and head
    (the int32 row data and page-table entries, under 0.1% here, are left
    out). A kernel's bound follows with ``4 * kv_positions * heads *
    head_dim`` operations."""
    n = lengths.long()
    lo = lower.long() if lower is not None else torch.zeros_like(n)
    per_row = (n - lo).clamp(min=0)
    if window_keys is not None:
        per_row = per_row + window_keys.long().clamp(min=0)
    rows = int((per_row > 0).sum())
    positions = int(per_row.sum())
    moved = (2 * positions * kv_heads + 2 * rows * heads) * head_dim
    return rows, positions, moved * elem_bytes
