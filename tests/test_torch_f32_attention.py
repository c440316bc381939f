"""The float32 attention routes' arithmetic, on the CPU.

The port's float32 kernels (``paged_prefill_f32_kernel`` in
``ops/csrc/paged_prefill.cu``, ``paged_decode_f32_kernel`` in
``ops/csrc/paged_attention.cu``) run only on the card. Here their
arithmetic is emulated in torch and held to the JAX package's Pallas
kernels in interpret mode, with the same inputs (made with numpy), at
the float32 tolerance, atol 1e-5:

- prefill: both products in the 3xTF32 form (each operand split into a
  TF32 value, rounded to nearest with ties away from zero to 10 mantissa
  bits as ``cvt.rna.tf32.f32`` rounds, and the remainder as the tensor
  cores read it, its 13 low bits dropped; three products, the small x
  small one dropped), the online softmax over the
  kernel's key blocks in log2 units. A control with one TF32 product
  must miss the tolerance, so the test can see the difference;
- decode: the kernel's cut of a row into cluster splits, of a split into
  8-key blocks dealt to four warps, each warp's online softmax, the
  merge of the warps and the fold of the splits with the fused window's
  in-flight keys, in float32 (its products are FFMA).

Also: the routes by shape, the launch plans' shared memory against the
227 KB a block may take, and a 2-layer float32 engine at the 1b preset's
attention shapes whose greedy tokens equal JaxEngine's. The kernels
themselves are held to the plain versions on the card
(tests/test_torch_kernels.py, ``-k f32``)."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.jax_engine import JaxEngine
from dynamo_tpu.llm.protocols.common import (PreprocessedRequest as
                                             JaxRequest)
from dynamo_tpu.llm.protocols.common import StopConditions as JaxStop
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import (_pool_window_attention_pallas as
                                     jax_pool_window_pallas)
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.ops.paged_attention import (
    paged_attention_decode_layered as jax_decode_layered,
    paged_attention_prefill as jax_prefill)
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                   StopConditions)
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops import paged_attention as ops
from dynamo_tpu_torch.runtime.engine import Context

F32 = dict(rtol=0, atol=1e-5)
LOG2E = 1.4426950408889634
NEG_INF = ops.NEG_INF

# (name, head_dim, page size, GQA group) of the presets served in float32
PRESETS = [("tiny", 16, 16, 2), ("1b", 64, 64, 4), ("8b", 128, 64, 4)]


# ---------------------------------------------------------------- 3xTF32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, to
    nearest with ties away from zero (the low 13 bits cleared)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(big, small): x to TF32, and the remainder x - big as the tensor
    cores read it (truncated to TF32)."""
    big = tf32(x)
    small = (x - big).contiguous().view(torch.int32) & -0x2000
    return big, small.view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's mma.sync takes it: the two small terms, then
    the big one, into float32 accumulators."""
    ab, as_ = split_tf32(a)
    bb, bs = split_tf32(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 product (the control)."""
    return tf32(a) @ tf32(b)


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                       # a TF32 ulp at 1.0
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0, 0.0], dtype=torch.float32)
    want = [one + ulp, -(one + ulp), one, one + ulp, 3.0, 0.0]
    assert tf32(x).tolist() == want
    big, small = split_tf32(torch.tensor([np.float32(np.pi)]))
    assert big.item() != np.float32(np.pi)
    assert (tf32(small) == small).all()    # the remainder is TF32 itself
    assert abs(float(big + small) - np.pi) < 1e-6


def prefill_emulated(q, k_pages, v_pages, table, q_pos, scale, softcap=None,
                     eff_win=None, mm=mm_3xtf32):
    """paged_prefill_f32_kernel's arithmetic in torch: per (row, kv head)
    the G heads' query rows, S = Q K^T by ``mm`` over key blocks of
    min(ps, 64, 4096 / hd) keys, the online softmax in log2 units
    (masked keys -inf, exp only where visible), O += P V by ``mm``,
    O / max(l, 1e-9); padding queries zero."""
    B, T, H, hd = q.shape
    _, KV, ps, _ = k_pages.shape
    G = H // KV
    kb = min(ps, 16 if hd >= 256 else 32 if hd >= 128 else 64)
    S = table.shape[1] * ps
    out = torch.zeros(B, T, H, hd)
    for b in range(B):
        keys = k_pages[table[b].long()]        # [P, KV, ps, hd]
        vals = v_pages[table[b].long()]
        qp = q_pos[b].long().repeat_interleave(G)        # [T * G]
        win = int(eff_win[b]) if eff_win is not None else ops.NO_WINDOW
        for kv in range(KV):
            K = keys[:, kv].reshape(S, hd)
            V = vals[:, kv].reshape(S, hd)
            Q = q[b, :, kv * G:(kv + 1) * G].reshape(T * G, hd)
            m = torch.full((T * G,), NEG_INF)
            l = torch.zeros(T * G)
            o = torch.zeros(T * G, hd)
            for j0 in range(0, S, kb):
                pos = torch.arange(j0, j0 + kb)
                x = mm(Q, K[j0:j0 + kb].T) * scale
                if softcap:
                    x = softcap * torch.tanh(x / softcap)
                x = x * LOG2E
                vis = (pos[None] <= qp[:, None]) & (pos[None] > qp[:, None]
                                                    - win)
                x = torch.where(vis, x, torch.tensor(float("-inf")))
                m_new = torch.maximum(m, x.amax(-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(x - m_new[:, None])
                l = l * alpha + p.sum(-1)
                o = o * alpha[:, None] + mm(p, V[j0:j0 + kb])
                m = m_new
            o = o / l.clamp(min=1e-9)[:, None]
            o = torch.where((qp >= 0)[:, None], o, torch.zeros_like(o))
            out[b, :, kv * G:(kv + 1) * G] = o.reshape(T, G, hd)
    return out


def _prefill_inputs(seed, hd, ps, G, T, start, KV=1, rows=1, win=None):
    rng = np.random.RandomState(seed)
    H = KV * G
    P = -(-(start + T) // ps)
    N = P * rows + 2
    q = rng.randn(rows, T, H, hd).astype(np.float32)
    kp = rng.randn(N, KV, ps, hd).astype(np.float32)
    vp = rng.randn(N, KV, ps, hd).astype(np.float32)
    table = np.stack([rng.permutation(np.arange(1, N))[:P]
                      for _ in range(rows)]).astype(np.int32)
    pos = np.broadcast_to(np.arange(start, start + T, dtype=np.int32),
                          (rows, T)).copy()
    if rows > 1:
        pos[1, T // 2:] = -1                 # a row padded halfway
    eff = np.full((rows,), win or ops.NO_WINDOW, np.int32)
    return q, kp, vp, table, pos, eff


def _jax_prefill(q, kp, vp, table, pos, eff, scale, softcap=None):
    return np.asarray(jax_prefill(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(pos), scale=scale, interpret=True, softcap=softcap,
        eff_win=jnp.asarray(eff)))


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("name,hd,ps,G", PRESETS)
def test_prefill_3xtf32_matches_jax_kernel(name, hd, ps, G):
    """A first chunk at each preset's head width (one kv head; 512
    queries at head_dim 128, fewer at the narrower widths), and a second
    chunk with a sliding window and softcap on two rows, one padded."""
    T = 512 if hd == 128 else 128
    scale = hd ** -0.5
    for start, win, softcap, rows in ((0, None, None, 1),
                                      (T // 2, 3 * ps // 2, 20.0, 2)):
        q, kp, vp, table, pos, eff = _prefill_inputs(
            hd + start, hd, ps, G, T, start, rows=rows, win=win)
        want = _jax_prefill(q, kp, vp, table, pos, eff, scale, softcap)
        got = prefill_emulated(*_torch(q, kp, vp, table, pos), scale,
                               softcap, torch.from_numpy(eff))
        np.testing.assert_allclose(got.numpy(), want, **F32)
        assert (got.numpy()[pos < 0] == 0).all()


def test_prefill_one_tf32_product_misses_the_tolerance():
    """The control: the same 512-query chunk at head_dim 128 with one TF32
    product where the kernel takes three is far outside atol 1e-5, and
    the 3xTF32 form is well inside it."""
    hd, ps, G, T = 128, 64, 4, 512
    q, kp, vp, table, pos, eff = _prefill_inputs(3, hd, ps, G, T, 0)
    want = _jax_prefill(q, kp, vp, table, pos, eff, hd ** -0.5)
    args = (*_torch(q, kp, vp, table, pos), hd ** -0.5, None,
            torch.from_numpy(eff))
    one = np.abs(prefill_emulated(*args, mm=mm_tf32).numpy() - want).max()
    three = np.abs(prefill_emulated(*args).numpy() - want).max()
    assert one > 1e-5 * 10, one
    assert three < 1e-5 / 2, three


# ---------------------------------------------------------------- decode


def decode_emulated(q, k_pools, v_pools, layer, table, lengths=None,
                    lower=None, scale=1.0, softcap=None, splits=1,
                    window=None):
    """paged_decode_f32_kernel's arithmetic in torch (float32 products):
    a row's pages in [lower, length) cut into at most ``splits``
    contiguous shares of at least one ring of keys (3 stages x 4 warps of
    8 keys), a share's 8-key blocks dealt to four warps in turn, each
    warp's online softmax (exp2 of natural-unit scores times log2 e), the
    warps merged at the block's max, the splits and the window's visible
    in-flight keys folded at the joint max.
    ``window``: (start, q_pos, wk, wv, n_win, eff_win) of the fused
    window form, whose pool extent is [q_pos + 1 - eff_win, start).
    Returns (out, m, l) as the kernel writes them."""
    B, H, hd = q.shape
    _, _, KV, ps, _ = k_pools.shape
    P = table.shape[1]
    G = H // KV
    kb = 8
    min_pages = max(4 * 3 * kb // ps, 1)
    out = torch.zeros(B, H, hd)
    m_out = torch.full((B, H), NEG_INF)
    l_out = torch.zeros(B, H)
    e2 = lambda x: torch.exp2(x * LOG2E)  # noqa: E731
    for b in range(B):
        if window is None:
            length, lo = int(lengths[b]), int(lower[b])
        else:
            start, qpos, wk, wv, n_win, eff = window
            length = max(int(start[b]), 0)
            lo = (min(max(int(qpos[b]) + 1 - int(eff[b]), 0), length)
                  if eff is not None else 0)
        row_begin = lo // ps if lo > 0 else 0
        row_end = min(-(-length // ps), P) if length > 0 else 0
        n = max(row_end - row_begin, 0)
        n_live = min(splits, -(-n // min_pages))
        for kv in range(KV):
            qg = q[b, kv * G:(kv + 1) * G]
            parts = []
            for sp in range(max(n_live, 1)):
                p_begin = row_begin + n * sp // n_live if n_live else row_begin
                n_pages = (row_begin + n * (sp + 1) // n_live - p_begin
                           if n_live else 0)
                k_lo = max(lo, p_begin * ps)
                k_hi = min(length, (p_begin + n_pages) * ps)
                jb = k_lo // kb
                je = -(-k_hi // kb) if k_hi > k_lo else jb
                warps = []
                for w in range(4):
                    m = torch.full((G,), NEG_INF)
                    l = torch.zeros(G)
                    o = torch.zeros(G, hd)
                    for blk in range(jb + w, je, 4):
                        pos = torch.arange(blk * kb, blk * kb + kb)
                        page = table[b, (pos // ps).clamp(max=P - 1)].long()
                        kr = k_pools[layer, page, kv, pos % ps]
                        vr = v_pools[layer, page, kv, pos % ps]
                        x = (qg @ kr.T) * scale
                        if softcap:
                            x = softcap * torch.tanh(x / softcap)
                        vis = (pos >= k_lo) & (pos < k_hi)
                        mx = torch.where(vis, x, NEG_INF).amax(-1)
                        m_new = torch.maximum(m, mx)
                        alpha = e2(m - m_new)
                        p = torch.where(vis, e2(x - m_new[:, None]), 0.0)
                        l = l * alpha + p.sum(-1)
                        o = o * alpha[:, None] + p @ vr
                        m = m_new
                    warps.append((o, m, l))
                M = torch.stack([w[1] for w in warps]).amax(0)
                ew = [e2(w[1] - M) for w in warps]
                parts.append((sum(e[:, None] * w[0] for e, w in zip(ew, warps)),
                              M, sum(e * w[2] for e, w in zip(ew, warps))))
            srcs_m = torch.stack([p[1] for p in parts])       # [S, G]
            M = srcs_m.amax(0)
            if window is not None:
                slot = torch.arange(wk.shape[1])
                floor = (int(qpos[b]) - int(eff[b]) if eff is not None
                         else -(1 << 31))
                vis = ((slot < n_win) & (int(start[b]) >= 0)
                       & (int(start[b]) + slot > floor))
                sw = (qg @ wk[b, :, kv].T) * scale
                if softcap:
                    sw = softcap * torch.tanh(sw / softcap)
                sw = torch.where(vis, sw, float("-inf"))
                M = torch.maximum(M, sw.amax(-1))
            M = M.clamp(min=NEG_INF)
            es = e2(srcs_m - M)
            L = (es * torch.stack([p[2] for p in parts])).sum(0)
            acc = sum(e[:, None] * p[0] for e, p in zip(es, parts))
            if window is not None:
                ew = e2(sw - M[:, None])
                L = L + ew.sum(-1)
                acc = acc + ew @ wv[b, :, kv]
            out[b, kv * G:(kv + 1) * G] = acc / L.clamp(min=1e-9)[:, None]
            m_out[b, kv * G:(kv + 1) * G] = M
            l_out[b, kv * G:(kv + 1) * G] = L
    return out, m_out, l_out


def _decode_inputs(seed, hd, ps, G, lengths, KV=1, L=2, P=None):
    rng = np.random.RandomState(seed)
    H = KV * G
    P = P or max(-(-n // ps) for n in lengths)
    N = P * len(lengths) + 2
    q = rng.randn(len(lengths), H, hd).astype(np.float32)
    kp = rng.randn(L, N, KV, ps, hd).astype(np.float32)
    vp = rng.randn(L, N, KV, ps, hd).astype(np.float32)
    table = np.stack([rng.permutation(np.arange(1, N))[:P]
                      for _ in lengths]).astype(np.int32)
    return q, kp, vp, table


@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("name,hd,ps,G", PRESETS)
def test_decode_emulated_matches_jax_kernel(name, hd, ps, G, splits):
    """The layered form with stats at each preset's head width (one kv
    head): rows of 0 to 12 pages, a lower bound, a softcap on layer 1;
    cut into one split and into a cluster of four."""
    lengths = np.array([0, 1, 3 * ps + 5, 12 * ps, 700], np.int32)
    lower = np.array([0, 0, ps + 1, 2 * ps, 650], np.int32)
    q, kp, vp, table = _decode_inputs(hd + splits, hd, ps, G, lengths,
                                      P=max(12, -(-700 // ps)))
    scale = hd ** -0.5
    for layer, softcap in ((0, None), (1, 30.0)):
        want = jax_decode_layered(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.int32(layer), jnp.asarray(table), jnp.asarray(lengths),
            scale=scale, interpret=True, return_stats=True,
            softcap=softcap, lower=jnp.asarray(lower))
        got = decode_emulated(*_torch(q, kp, vp), layer,
                              *_torch(table, lengths, lower), scale=scale,
                              softcap=softcap, splits=splits)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **F32)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=1e-5, atol=1e-5)
        assert (got[0][0] == 0).all() and (got[2][0] == 0).all()
        assert (got[1][0] == NEG_INF).all()


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("name,hd,ps,G", PRESETS)
def test_decode_window_emulated_matches_jax(name, hd, ps, G, window):
    """The fused window form (the served path's): the pool plus 1 to 4
    in-flight keys folded in one softmax, against the JAX package's
    pool-window attention on its Pallas kernel, at every step of a
    K = 4 window, with a cluster of four splits."""
    K = 4
    start = np.array([40, 64, 86, 656, -1], np.int32)
    q, kp, vp, table = _decode_inputs(7 * hd, hd, ps, G, [700] * 5,
                                      P=-(-700 // ps))
    rng = np.random.RandomState(hd)
    wk = rng.randn(5, K, 1, hd).astype(np.float32)
    wv = rng.randn(5, K, 1, hd).astype(np.float32)
    scale = hd ** -0.5
    eff = None if window is None else np.full((5,), window, np.int32)
    for i in range(K):
        qpos = np.maximum(start + i, 0).astype(np.int32)
        want = jax_pool_window_pallas(
            jnp.asarray(q)[:, None], jnp.asarray(kp), jnp.asarray(vp),
            jnp.int32(0), jnp.asarray(table), jnp.asarray(start),
            jnp.asarray(wk), jnp.asarray(wv), i, scale, interpret=True,
            q_pos=jnp.asarray(qpos), softcap=None, window=window,
            is_sliding=window is not None)
        got, _, _ = decode_emulated(
            *_torch(q, kp, vp), 0, torch.from_numpy(table), scale=scale,
            splits=4, window=(start, qpos, *_torch(wk, wv), i + 1, eff))
        np.testing.assert_allclose(got.numpy()[:4],
                                   np.asarray(want)[:4, 0], **F32)


# ------------------------------------------------------- routes and plans


@pytest.mark.parametrize("hd", ops.F32_HEAD_DIMS)
def test_f32_routes_take_the_set_by_shape(hd):
    """float32 at the set's head dims, pages 8-128 and groups 1-8 takes
    route 2 (``f32``) for both kernels; outside the set (the phase-2/3
    check shapes with page 4, a head_dim of 96, groups past 8) the
    generic route 0; bfloat16 never takes route 2."""
    for ps in (4, 8, 16, 32, 48, 64, 128, 256):
        for G in (1, 2, 3, 4, 7, 8, 9):
            inside = ps in ops.F32_PAGE_SIZES and G <= 8
            for route in (ops.decode_route, ops.prefill_route):
                assert route(torch.float32, 2 * G, 2, ps, hd) == (
                    2 if inside else 0), (route.__name__, hd, ps, G)
                assert route(torch.bfloat16, 2 * G, 2, ps, hd) != 2
    assert ops.decode_route(torch.float32, 8, 2, 64, 96) == 0
    assert ops.prefill_route(torch.float32, 4, 2, 4, 32) == 0
    assert ops.DECODE_ROUTES[2] == ops.PREFILL_ROUTES[2] == "f32"


@pytest.mark.parametrize("hd", ops.F32_HEAD_DIMS)
def test_f32_launch_plans_fit_shared_memory(hd):
    """Every shape of the float32 set fits the 227 KB a block may take,
    and at head_dim <= 128 two blocks of each kernel share an SM (228 KB
    an SM, 1 KB of it reserved a block)."""
    two = lambda smem: 2 * (smem + 1024) <= 228 * 1024  # noqa: E731
    assert ops.decode_f32_smem(hd) <= ops.SMEM_LIMIT
    assert two(ops.decode_f32_smem(hd)) or hd > 128
    for ps in ops.F32_PAGE_SIZES:
        smem = ops.prefill_f32_smem(hd, ps)
        assert smem <= ops.SMEM_LIMIT
        assert two(smem) or hd > 128, (hd, ps, smem)
    # the 8B's heads: Q 32 KB, two 32-key stages of K and V
    assert ops.prefill_f32_smem(128, 64) == 1024 + 32768 + 65536 + 32


def test_f32_cluster_plan_at_the_served_shapes():
    """The float32 route takes the bf16 route's cluster plan: at the
    served 4-row window of 8 kv heads, with one block an SM (132 of them:
    33 clusters of 4, 16 of 8), the 32 pairs take clusters of 4; one row
    takes 8, eight rows 2, 64 rows none."""
    clusters = {S: 132 // S for S in ops.DECODE_CLUSTER_SIZES}
    assert ops.decode_cluster_plan(4, 8, 64, clusters) == 4
    assert ops.decode_cluster_plan(1, 8, 64, clusters) == 8
    assert ops.decode_cluster_plan(8, 8, 64, clusters) == 2
    assert ops.decode_cluster_plan(64, 8, 64, clusters) == 1


# ---------------------------------------------------------------- engine


def test_f32_engine_at_1b_attention_matches_jax_engine():
    """A 2-layer float32 engine with the 1b preset's attention (head_dim
    64, 8 heads on 2 kv heads: group 4, page 64) and a narrow model width:
    greedy tokens equal JaxEngine's on the same weights."""
    shape = dict(num_heads=8, num_kv_heads=2, head_dim=64)
    jcfg, tcfg = JaxModelConfig.tiny(**shape), ModelConfig.tiny(**shape)
    ecfg = dict(page_size=64, num_pages=16, max_batch=4, prefill_chunk=64,
                prefill_buckets=(64,), batch_buckets=(1, 2, 4),
                page_buckets=(4,), decode_steps=4)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(5))
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 jparams.items()}, tcfg, device="cpu")
    jeng = JaxEngine(jcfg, JaxEngineConfig(**ecfg), params=jparams)
    teng = TorchEngine(tcfg, EngineConfig(**ecfg), params=tparams,
                       device="cpu")
    prompts = [list(range(1, 6)), list(range(30, 100)), [7, 7, 7]]
    budget = (9, 12, 6)

    async def run(engine, request_cls, stop_cls, ctx_cls):
        async def one(p, n, delay):
            await asyncio.sleep(delay)
            req = request_cls(token_ids=list(p), stop=stop_cls(max_tokens=n),
                              eos_token_ids=[])
            toks = []
            async for out in engine.generate(req, ctx_cls()):
                toks += out.token_ids
            return toks

        try:
            return await asyncio.gather(*[
                one(p, n, 0.01 * i)
                for i, (p, n) in enumerate(zip(prompts, budget))])
        finally:
            await engine.stop()

    want = asyncio.run(run(jeng, JaxRequest, JaxStop, JaxContext))
    got = asyncio.run(run(teng, PreprocessedRequest, StopConditions,
                          Context))
    assert got == want
    assert [len(t) for t in got] == list(budget)
