"""The port's paged-attention wrappers (ops/paged_attention.py) against the
JAX package's Pallas kernels run in interpret mode, on the CPU.

On CPU tensors the port's wrappers compute their plain PyTorch versions,
so these tests pin the arithmetic the CUDA kernels implement
(tests/test_torch_kernels.py holds the kernels themselves against those
plain versions on a machine with the GPU). Every case
of tests/test_ops.py is mirrored here, with the same inputs (made with
numpy) fed to both sides. Tolerances: atol 1e-5 in float32 (same math,
different summation order), 2e-2 in bfloat16 (one bf16 rounding of the
output on each side)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models.llama import (_paged_attention as jax_paged_attention,
                                     _pool_window_attention as jax_pool_window,
                                     _pool_window_attention_pallas as
                                     jax_pool_window_pallas)
from dynamo_tpu.ops.paged_attention import (
    paged_attention_decode as jax_decode,
    paged_attention_decode_layered as jax_decode_layered,
    paged_attention_prefill as jax_prefill)
from dynamo_tpu_torch.models.llama import (_paged_attention,
                                           _pool_window_attention,
                                           _pool_window_attention_kernel)
from dynamo_tpu_torch.ops import paged_attention as ops
from dynamo_tpu_torch.ops.paged_attention import (
    paged_attention_decode, paged_attention_decode_layered,
    paged_attention_prefill)

F32 = dict(rtol=0, atol=1e-5)
BF16 = dict(rtol=0, atol=2e-2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _both(a, dtype="float32"):
    """(jax array, torch tensor) of the same numpy data."""
    j = jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else a.dtype)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
    return j, t


def _pages(rng, num_pages, ps, KV, hd, dtype="float32"):
    k = rng.randn(num_pages, KV, ps, hd).astype(np.float32)
    v = rng.randn(num_pages, KV, ps, hd).astype(np.float32)
    return _both(k, dtype), _both(v, dtype)


def _table(rng, B, P, num_pages, lengths, ps):
    table = np.zeros((B, P), np.int32)
    for b in range(B):
        npages = -(-int(lengths[b]) // ps)
        table[b, :npages] = rng.choice(np.arange(1, num_pages), npages,
                                       replace=False)
    return table


# ------------------------------------------------------------------ decode


@pytest.mark.parametrize("group,hd,ps", [(4, 64, 8), (1, 32, 16)])
def test_decode_matches_jax_kernel(group, hd, ps):
    rng = np.random.RandomState(0)
    KV, B, P, num_pages = 2, 5, 4, 32
    H = KV * group
    qj, qt = _both(rng.randn(B, H, hd).astype(np.float32))
    (kj, kt), (vj, vt) = _pages(rng, num_pages, ps, KV, hd)
    lengths = np.array([1, ps, ps + 3, 2 * ps, P * ps], np.int32)
    table = _table(rng, B, P, num_pages, lengths, ps)
    want = jax_decode(qj, kj, vj, jnp.asarray(table), jnp.asarray(lengths),
                      scale=hd ** -0.5, interpret=True)
    got = paged_attention_decode(qt, kt, vt, torch.from_numpy(table),
                                 torch.from_numpy(lengths), scale=hd ** -0.5)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_decode_stats_match_jax_kernel():
    """(m, l) online-softmax stats of the layered form, including a row of
    length 0 (m = NEG_INF, l = 0) and a window that empties the view."""
    rng = np.random.RandomState(1)
    L, KV, group, hd, ps, B, P, N = 3, 2, 2, 32, 8, 4, 3, 16
    H = KV * group
    qj, qt = _both(rng.randn(B, H, hd).astype(np.float32))
    kp = rng.randn(L, N, KV, ps, hd).astype(np.float32)
    vp = rng.randn(L, N, KV, ps, hd).astype(np.float32)
    (kj, kt), (vj, vt) = _both(kp), _both(vp)
    lengths = np.array([13, 0, 24, 9], np.int32)
    lower = np.array([0, 0, 20, 9], np.int32)  # row 3: empty view
    table = _table(rng, B, P, N, lengths, ps)
    for layer in range(L):
        w_out, w_m, w_l = jax_decode_layered(
            qj, kj, vj, jnp.int32(layer), jnp.asarray(table),
            jnp.asarray(lengths), interpret=True, return_stats=True,
            lower=jnp.asarray(lower))
        g_out, g_m, g_l = paged_attention_decode_layered(
            qt, kt, vt, layer, torch.from_numpy(table),
            torch.from_numpy(lengths), return_stats=True,
            lower=torch.from_numpy(lower))
        np.testing.assert_allclose(_np(g_out), _np(w_out), **F32)
        np.testing.assert_allclose(_np(g_m), _np(w_m), rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(_np(g_l), _np(w_l), rtol=1e-5, atol=1e-5)
    assert (_np(g_m)[1] == ops.NEG_INF).all() and (_np(g_l)[1] == 0).all()
    assert (_np(g_l)[3] == 0).all()


def test_decode_padding_rows_zero():
    rng = np.random.RandomState(2)
    B, H, KV, hd, ps, P = 3, 4, 2, 32, 8, 2
    (kj, kt), (vj, vt) = _pages(rng, 8, ps, KV, hd)
    table = np.zeros((B, P), np.int32)
    lengths = np.array([0, 5, 0], np.int32)
    q = np.ones((B, H, hd), np.float32)
    want = jax_decode(jnp.asarray(q), kj, vj, jnp.asarray(table),
                      jnp.asarray(lengths), interpret=True)
    got = _np(paged_attention_decode(torch.from_numpy(q), kt, vt,
                                     torch.from_numpy(table),
                                     torch.from_numpy(lengths)))
    np.testing.assert_allclose(got, _np(want), **F32)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_array_equal(got[2], 0.0)
    assert np.abs(got[1]).sum() > 0


def test_decode_bf16():
    rng = np.random.RandomState(3)
    B, H, KV, hd, ps = 2, 8, 4, 64, 8
    qj, qt = _both(rng.randn(B, H, hd).astype(np.float32), "bfloat16")
    (kj, kt), (vj, vt) = _pages(rng, 8, ps, KV, hd, "bfloat16")
    table = np.array([[1, 2], [3, 0]], np.int32)
    lengths = np.array([11, 8], np.int32)
    want = jax_decode(qj, kj, vj, jnp.asarray(table), jnp.asarray(lengths),
                      interpret=True)
    got = paged_attention_decode(qt, kt, vt, torch.from_numpy(table),
                                 torch.from_numpy(lengths))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


def test_decode_softcap_and_window():
    rng = np.random.RandomState(7)
    KV, group, hd, ps, B, P, num_pages = 2, 2, 32, 8, 4, 4, 32
    H = KV * group
    qj, qt = _both(rng.randn(B, H, hd).astype(np.float32))
    (kj, kt), (vj, vt) = _pages(rng, num_pages, ps, KV, hd)
    lengths = np.array([ps + 3, 2 * ps, P * ps, 5], np.int32)
    table = _table(rng, B, P, num_pages, lengths, ps)
    window, softcap = 6, 15.0
    lower = np.clip(lengths - window, 0, np.maximum(lengths - 1, 0)
                    ).astype(np.int32)
    want = jax_decode(qj, kj, vj, jnp.asarray(table), jnp.asarray(lengths),
                      scale=hd ** -0.5, interpret=True, softcap=softcap,
                      lower=jnp.asarray(lower))
    got = paged_attention_decode(qt, kt, vt, torch.from_numpy(table),
                                 torch.from_numpy(lengths), scale=hd ** -0.5,
                                 softcap=softcap,
                                 lower=torch.from_numpy(lower))
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    # and the JAX gather path with the same window
    gather = jax_paged_attention(qj[:, None], kj, vj, jnp.asarray(table),
                                 jnp.asarray(lengths - 1)[:, None],
                                 hd ** -0.5, softcap=softcap, window=window,
                                 is_sliding=True)[:, 0]
    np.testing.assert_allclose(_np(got), _np(gather), **F32)


# -------------------------------------------------------- window merge


@pytest.mark.parametrize("window", [None, 5])
def test_pool_window_merge_matches_jax(window):
    """The fused-window pool attention (decode kernel with stats + online-
    softmax merge with the in-flight buffer) and its plain concat form,
    both against the JAX package's: mid-pool row, page-boundary row,
    empty pool (start=0); padding rows (start=-1) are discarded by the
    window and are not compared."""
    rng = np.random.RandomState(7)
    B, H, KV, hd, ps, P, L, K = 4, 8, 4, 64, 8, 3, 2, 4
    kp = rng.randn(L, 16, KV, ps, hd).astype(np.float32)
    vp = rng.randn(L, 16, KV, ps, hd).astype(np.float32)
    (kj, kt), (vj, vt) = _both(kp), _both(vp)
    qj, qt = _both(rng.randn(B, 1, H, hd).astype(np.float32))
    wkj, wkt = _both(rng.randn(B, K, KV, hd).astype(np.float32))
    wvj, wvt = _both(rng.randn(B, K, KV, hd).astype(np.float32))
    table = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9], [1, 0, 0]], np.int32)
    start = np.array([13, 16, 0, -1], np.int32)
    scale = hd ** -0.5
    for i in (0, K - 1):
        qpos = np.maximum(start + i, 0).astype(np.int32)
        kw = dict(softcap=None, window=window, is_sliding=window is not None)
        for l in range(L):
            want = jax_pool_window_pallas(
                qj, kj, vj, jnp.int32(l), jnp.asarray(table),
                jnp.asarray(start), wkj, wvj, i, scale, interpret=True,
                q_pos=jnp.asarray(qpos), **kw)
            want_plain = jax_pool_window(
                qj, kj[l], vj[l], jnp.asarray(table), jnp.asarray(start),
                wkj, wvj, i, scale, q_pos=jnp.asarray(qpos), **kw)
            got = _pool_window_attention_kernel(
                qt, kt, vt, l, torch.from_numpy(table),
                torch.from_numpy(start), wkt, wvt, i, scale,
                q_pos=torch.from_numpy(qpos), **kw)
            got_plain = _pool_window_attention(
                qt, kt[l], vt[l], torch.from_numpy(table),
                torch.from_numpy(start), wkt, wvt, i, scale,
                q_pos=torch.from_numpy(qpos), **kw)
            np.testing.assert_allclose(_np(got)[:3], _np(want)[:3], **F32)
            np.testing.assert_allclose(_np(got_plain)[:3],
                                       _np(want_plain)[:3], **F32)
            np.testing.assert_allclose(_np(got)[:3], _np(got_plain)[:3],
                                       **F32)


# ----------------------------------------------------------------- prefill


@pytest.mark.parametrize("group,hd,T", [(2, 16, 8), (4, 32, 16)])
def test_prefill_matches_jax_kernel(group, hd, T):
    """Chunk starting mid-sequence (prefix cached), per-row positions, a
    padding row (kernel zeros), trailing invalid pages."""
    rng = np.random.RandomState(0)
    B, KV, ps, N, P = 3, 2, 4, 32, 6
    H = KV * group
    qj, qt = _both(rng.randn(B, T, H, hd).astype(np.float32))
    (kj, kt), (vj, vt) = _pages(rng, N, ps, KV, hd)
    table = np.zeros((B, P), np.int32)
    table[0, :4] = [3, 7, 2, 9]
    table[1, :2] = [11, 4]
    positions = np.full((B, T), -1, np.int32)
    positions[0] = np.arange(8, 8 + T)
    positions[1] = np.arange(T)
    want = jax_prefill(qj, kj, vj, jnp.asarray(table),
                       jnp.asarray(positions), scale=0.3, interpret=True)
    got = paged_attention_prefill(qt, kt, vt, torch.from_numpy(table),
                                  torch.from_numpy(positions), scale=0.3)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert np.all(_np(got)[2] == 0.0)
    # the plain version of the model layer (gather path) on live rows
    gather = jax_paged_attention(qj, kj, vj, jnp.asarray(table),
                                 jnp.asarray(positions), 0.3)
    mine = _paged_attention(qt, kt, vt, torch.from_numpy(table),
                            torch.from_numpy(positions), 0.3)
    np.testing.assert_allclose(_np(mine)[:2], _np(gather)[:2], **F32)


def test_prefill_bf16():
    rng = np.random.RandomState(1)
    B, KV, group, ps, hd, N, P, T = 2, 2, 2, 4, 16, 16, 4, 8
    H = KV * group
    qj, qt = _both(rng.randn(B, T, H, hd).astype(np.float32), "bfloat16")
    (kj, kt), (vj, vt) = _pages(rng, N, ps, KV, hd, "bfloat16")
    table = np.zeros((B, P), np.int32)
    table[0, :3] = [1, 5, 9]
    table[1, :2] = [2, 8]
    positions = np.stack([np.arange(4, 4 + T), np.arange(T)]).astype(np.int32)
    want = jax_prefill(qj, kj, vj, jnp.asarray(table),
                       jnp.asarray(positions), scale=0.25, interpret=True)
    got = paged_attention_prefill(qt, kt, vt, torch.from_numpy(table),
                                  torch.from_numpy(positions), scale=0.25)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


def test_prefill_softcap_and_window():
    rng = np.random.RandomState(8)
    KV, group, hd, ps, T, B, P, N = 2, 2, 32, 8, 24, 2, 4, 32
    H = KV * group
    qj, qt = _both(rng.randn(B, T, H, hd).astype(np.float32))
    (kj, kt), (vj, vt) = _pages(rng, N, ps, KV, hd)
    table = np.stack([rng.choice(np.arange(1, N), P, replace=False)
                      for _ in range(B)]).astype(np.int32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    window, softcap = 7, 12.0
    win = np.full((B,), window, np.int32)
    want = jax_prefill(qj, kj, vj, jnp.asarray(table),
                       jnp.asarray(positions), scale=hd ** -0.5,
                       interpret=True, softcap=softcap,
                       eff_win=jnp.asarray(win))
    got = paged_attention_prefill(qt, kt, vt, torch.from_numpy(table),
                                  torch.from_numpy(positions),
                                  scale=hd ** -0.5, softcap=softcap,
                                  eff_win=torch.from_numpy(win))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_prefill_window_second_chunk_page_skip():
    """Second chunk past the window: pages below the window's reach are
    skipped, output still matches."""
    rng = np.random.RandomState(9)
    KV, group, hd, ps, T, B, P, N = 1, 2, 32, 4, 8, 1, 8, 32
    H = KV * group
    qj, qt = _both(rng.randn(B, T, H, hd).astype(np.float32))
    (kj, kt), (vj, vt) = _pages(rng, N, ps, KV, hd)
    table = np.arange(1, P + 1, dtype=np.int32)[None]
    positions = (20 + np.arange(T, dtype=np.int32))[None]
    win = np.full((B,), 6, np.int32)
    want = jax_prefill(qj, kj, vj, jnp.asarray(table),
                       jnp.asarray(positions), scale=hd ** -0.5,
                       interpret=True, eff_win=jnp.asarray(win))
    got = paged_attention_prefill(qt, kt, vt, torch.from_numpy(table),
                                  torch.from_numpy(positions),
                                  scale=hd ** -0.5,
                                  eff_win=torch.from_numpy(win))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("case", ["first", "continuation", "padded",
                                  "windowed", "all_padding"])
def test_prefill_work_counts_the_mask(case):
    """prefill_work (the kernel's bound in chip_smoke.py) against a
    brute-force count of the visible (query, key) mask."""
    rng = np.random.RandomState(11)
    T = 24
    pos = np.full((3, T), -1, np.int32)
    win = np.full((3,), ops.NO_WINDOW, np.int32)
    pos[0] = np.arange(T)
    if case in ("continuation", "windowed"):
        pos[0] = 100 + np.arange(T)
        pos[1, :10] = 37 + np.arange(10)
    if case == "padded":
        pos[1, :5] = np.arange(5)
        pos[2, 3:9] = 50 + np.arange(6)
    if case == "windowed":
        win[:] = [7, 3, 1]
        pos[2] = 5 + np.arange(T)
    if case == "all_padding":
        pos[:] = -1
    rng.shuffle(pos[1])  # query order does not matter
    keys = np.arange(pos.max() + 1)[None, None, :]
    qp = pos[:, :, None]
    vis = (keys <= qp) & (keys > qp - win[:, None, None]) & (qp >= 0)
    got = ops.prefill_work(torch.from_numpy(pos), torch.from_numpy(win))
    assert got == (int((pos >= 0).sum()), int(vis.sum()),
                   int(vis.any(axis=1).sum()))
    if case == "first":  # a causal chunk from position 0: T (T + 1) / 2
        assert ops.prefill_work(torch.from_numpy(pos[:1]))[1:] == (
            T * (T + 1) // 2, T)


@pytest.mark.parametrize("case", ["plain", "lower", "window", "padding"])
def test_decode_work_counts_the_mask(case):
    """decode_work (the decode kernel's bound in chip_smoke.py) against a
    brute-force count of the visible pool positions and window keys."""
    rng = np.random.RandomState(12)
    B, H, KV, hd, el = 6, 32, 8, 128, 2
    lengths = rng.randint(1, 700, B).astype(np.int32)
    lower = np.zeros(B, np.int32)
    win = None
    if case in ("lower", "window"):
        lower = np.minimum(rng.randint(0, 500, B), lengths).astype(np.int32)
    if case == "window":
        win = rng.randint(1, 5, B).astype(np.int32)
    if case == "padding":
        lengths[[1, 4]] = 0
    keys = np.arange(lengths.max())[None, :]
    vis = (keys >= lower[:, None]) & (keys < lengths[:, None])
    per_row = vis.sum(axis=1) + (win if win is not None else 0)
    rows, positions, moved = ops.decode_work(
        torch.from_numpy(lengths), torch.from_numpy(lower),
        None if win is None else torch.from_numpy(win), heads=H,
        kv_heads=KV, head_dim=hd, elem_bytes=el)
    assert rows == int((per_row > 0).sum())
    assert positions == int(per_row.sum())
    assert moved == (2 * positions * KV * hd + 2 * rows * H * hd) * el


# clusters of 1/2/4/8 bf16 decode blocks an H100 holds at once at head_dim
# 128 (cudaOccupancyMaxActiveClusters: 264 blocks, but a cluster's blocks
# share one GPC, so 30 clusters of 8 rather than 33)
H100_CLUSTERS = {1: 264, 2: 132, 4: 62, 8: 30}


@pytest.mark.parametrize("B,KV,P,resident", [
    (4, 8, 64, 2),     # the served window: 8 splits, most rows short
    (32, 8, 64, 2),    # rows x kv heads fill the wave: no split
    (8, 8, 64, 2),     # long rows spread over 4 splits
    (1, 1, 3, 4),      # fewer pages than the wave could take
    (40, 8, 4, 1),     # more (row, kv head) blocks than resident slots
    (2, 4, 16, 3),
    (4, 4, 64, 2),     # the served window at tp=2's heads
    (4, 2, 64, 2),     # ... tp=4's
    (4, 1, 64, 2),     # ... tp=8's
    (8, 1, 64, 2),     # the long-row guard at tp=8's heads
])
@pytest.mark.parametrize("route", [0, 1])
def test_decode_split_plan_covers_every_page_once(route, B, KV, P, resident):
    """The split plans from host-known shapes: one cluster per (row, kv
    head), a size of DECODE_CLUSTER_SIZES no larger than the page table
    (route 1, the bf16 kernel) or than the splits a row of that table can
    fill (route 0, the generic kernel: one split for each ring of 192
    keys, at page size 8 here, on the head tiles of a group of 12 at 8 kv
    heads and of 71 at one), all clusters resident at once (unless the
    pairs alone pass the card), and the next size up would not fit. On
    route 0 the kernel's cut of any row of the table over that cluster
    (decode_generic_shares) also covers each key of the row once. That
    the kernels cut rows so on the card is checked there
    (tests/test_torch_kernels.py: rows with more pages than splits and
    with fewer, held to a limit that a row one 16-key block short
    exceeds)."""
    sms = 132
    clusters = (H100_CLUSTERS if resident == 2 else
                {S: sms * resident // S for S in ops.DECODE_CLUSTER_SIZES})
    if route == 1:
        pairs, cap = B * KV, P
        S = ops.decode_cluster_plan(B, KV, P, clusters)
    else:
        ps = 8
        plan = ops.decode_generic_plan(12 if KV > 1 else 71, ps, 128,
                                       torch.bfloat16)
        pairs = B * KV * plan.head_tiles
        cap = ops.decode_generic_splits_cap(P, ps, plan)
        S = ops.decode_cluster_plan(B, KV * plan.head_tiles, cap, clusters)
        for lo, length in ((0, P * ps), (3, P * ps - 5), (ps + 1, 2 * ps),
                           (0, 1)):
            shares = ops.decode_generic_shares(lo, length, P, ps, S, plan)
            keys = [k for first, n in shares
                    for k in range(first * plan.keys, (first + n) * plan.keys)]
            assert sorted(k for k in keys if lo <= k < length) == list(
                range(lo, length))
            assert len(keys) == len(set(keys)) and len(shares) <= S
    assert S in ops.DECODE_CLUSTER_SIZES
    assert S <= min(cap, ops.DECODE_BF16_MAX_SPLITS)
    assert S == 1 or pairs <= clusters[S]
    if 2 * S <= min(cap, ops.DECODE_BF16_MAX_SPLITS):  # the wave set S:
        assert pairs > clusters[2 * S]  # the next size would not fit
    if route == 1 and KV <= 2 and B <= 8 and P >= 8:
        assert S == ops.DECODE_BF16_MAX_SPLITS  # few pairs: a whole cluster


def test_decode_cluster_plan_at_the_served_shapes():
    """The bf16 plan on an H100 at the 8B widths' served 4-row window
    (64-page bucket): tp=1's 32 (row, kv head) pairs pass the 30
    resident clusters of 8, so 4 splits; tp 2, 4 and 8 take whole
    clusters of 8, as does the long-row guard (8 rows, 1 kv head); 8
    rows at full heads take 2 (64 pairs pass the 62 clusters of 4);
    32 rows do not split."""
    plan = ops.decode_cluster_plan
    assert plan(4, 8, 64, H100_CLUSTERS) == 4
    assert [plan(4, 8 // tp, 64, H100_CLUSTERS) for tp in (2, 4, 8)] == [8] * 3
    assert plan(8, 1, 64, H100_CLUSTERS) == 8
    assert plan(8, 8, 64, H100_CLUSTERS) == 2
    assert plan(32, 8, 64, H100_CLUSTERS) == 1
    assert plan(4, 1, 3, H100_CLUSTERS) == 2  # no more splits than pages


@pytest.mark.parametrize("dtype,hd,ps,G,route", [
    (torch.bfloat16, 128, 64, 4, 1),   # llama3_8b
    (torch.bfloat16, 64, 64, 4, 1),    # the 1b preset
    (torch.bfloat16, 256, 16, 8, 1),
    (torch.bfloat16, 128, 128, 1, 1),
    (torch.float32, 128, 64, 4, 2),    # float32 at the 8B shape: f32
    (torch.bfloat16, 16, 64, 4, 0),    # the tiny preset's head_dim
    (torch.bfloat16, 32, 16, 1, 0),    # chip_smoke's "small" case
    (torch.bfloat16, 64, 8, 2, 0),     # chip_smoke's "mha-64" case
    (torch.bfloat16, 128, 48, 4, 0),   # a page size outside the set
])
def test_decode_route_by_shape(dtype, hd, ps, G, route):
    assert ops.decode_route(dtype, 8 * G, 8, ps, hd) == route


# ----------------------------------------------------------- wrapper rules


def test_wrappers_check_operands():
    """dtype, shape and device checks raise instead of computing."""
    q = torch.zeros(2, 4, 16)
    pool = torch.zeros(1, 4, 2, 8, 16)
    table = torch.zeros(2, 2, dtype=torch.int32)
    lengths = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        paged_attention_decode_layered(q, pool, pool, 0, table,
                                       lengths.long())
    with pytest.raises(ValueError, match="dtypes"):
        paged_attention_decode_layered(q.double(), pool, pool, 0, table,
                                       lengths)
    with pytest.raises(ValueError, match="layer"):
        paged_attention_decode_layered(q, pool, pool, 1, table, lengths)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention_prefill(
            torch.zeros(2, 3, 4, 16).transpose(1, 2).contiguous()
            .transpose(1, 2), pool[0], pool[0], table,
            torch.zeros(2, 3, dtype=torch.int32))


def test_cpu_path_never_counts_launches():
    ops.reset_launch_counts()
    q = torch.randn(1, 2, 8)
    pool = torch.randn(1, 4, 1, 4, 8)
    paged_attention_decode_layered(q, pool, pool, 0,
                                   torch.tensor([[1]], dtype=torch.int32),
                                   torch.tensor([3], dtype=torch.int32))
    assert ops.LAUNCHES == {"paged_attention_decode": 0,
                            "paged_attention_prefill": 0}
