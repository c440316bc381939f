"""The generic prefill kernel, on the CPU, against the JAX package.

Route 0 of ``ops/csrc/paged_prefill.cu`` (``paged_prefill_generic_kernel``)
serves every prefill shape outside routes 1-3, in float32, bfloat16 and
float16: any page size and GQA group, any head_dim up to the dtype's
shared-memory bound (``GENERIC_MAX_HEAD_DIM``: 656 in float32, 576 in 16
bits), past 256 in value-column tiles. It runs only on the card
(tests/test_torch_kernels.py holds it to the plain version there). Here, with inputs made with numpy from a
seed and held to the JAX kernel (``paged_attention_prefill``) in
interpret mode:

- the wrapper's plain path (the CPU path) at the generic kernel's shapes:
  head_dim 96 at page 4, head_dim 16 at page 8, head_dim 80 at page 48,
  a group of 16, 71 heads on one kv head, a sliding window with the
  softcap, a chunk continuing mid-sequence, head_dim 20 and 7 (rows that
  are not 16-byte multiples in 16 bits), head_dim 320 and 512 (two
  value-column tiles); atol 2e-2 in bfloat16 and
  float16 (one rounding of the output to the type, as
  tests/test_torch_ops.py takes bfloat16), atol 1e-5 in float32;
- an emulation of the kernel's arithmetic in torch at the same shapes and
  tolerances: the blocks of ``prefill_generic_plan`` (64 (query, head)
  rows, head tiles past 64 heads, value-column tiles past head_dim 256,
  each taking the scores over the whole head_dim), each block's visible
  extent walked in
  key blocks that cross page boundaries, a page id outside the pool
  masked, the online softmax in log2 units; in 16 bits the probabilities
  rounded to the type before P V, in float32 both products in 3xTF32 with
  each block's P V summed from zero (a control with one TF32 product must
  miss the tolerance);
- the routes by shape, the plan's cover of every (query, head) pair and
  its shared memory;
- a bfloat16 tiny engine at page size 8 (prefill on the generic kernel
  on the card), whose greedy tokens equal JaxEngine's.
"""

import asyncio
import dataclasses
import itertools

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
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.ops.paged_attention import (paged_attention_prefill as
                                            jax_prefill)
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                   StopConditions)
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops import paged_attention as ops
from dynamo_tpu_torch.runtime.engine import Context

BF16 = dict(rtol=0, atol=2e-2)
F32 = dict(rtol=0, atol=1e-5)
LOG2E = 1.4426950408889634
DTYPES = ["float32", "bfloat16", "float16"]

# (name, head_dim, page size, group, kv heads, queries, first position,
# window or None, softcap or None, rows); a second row is padded halfway
CASES = [("hd96_page4", 96, 4, 4, 2, 12, 0, None, None, 1),
         ("hd16_page8", 16, 8, 2, 2, 16, 0, None, None, 2),
         ("hd80_page48", 80, 48, 4, 1, 10, 40, None, None, 1),
         ("group16", 64, 16, 16, 1, 8, 5, None, None, 1),
         ("mqa71", 32, 16, 71, 1, 4, 10, None, None, 1),
         ("window_softcap", 64, 8, 4, 2, 16, 24, 7, 20.0, 2),
         ("mid_sequence", 96, 8, 2, 2, 16, 37, None, None, 2),
         ("hd20", 20, 16, 4, 2, 10, 3, None, None, 2),
         ("hd7_page4", 7, 4, 2, 2, 9, 0, None, None, 1),
         ("wide_hd320", 320, 16, 4, 1, 8, 5, None, None, 2),
         ("wide_hd512_window", 512, 8, 2, 2, 8, 9, 6, 20.0, 1)]


def _inputs(case, dtype: str):
    """q, the pools, the page table, positions and windows of a case, as
    float32 numpy arrays of values exact in ``dtype``; every row's pages
    distinct and shuffled, the table one entry longer than it needs."""
    name, hd, ps, G, KV, T, start, win, _, rows = case
    rng = np.random.RandomState(hd * ps + G)
    P = -(-(start + T) // ps) + 1
    N = P * rows + 2

    def exact(*shape):
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        return x.to(getattr(torch, dtype)).float().numpy()

    q = exact(rows, T, KV * G, hd)
    kp, vp = exact(N, KV, ps, hd), exact(N, KV, ps, hd)
    table = np.stack([rng.permutation(np.arange(1, N))[:P]
                      for _ in range(rows)]).astype(np.int32)
    pos = np.broadcast_to(np.arange(start, start + T, dtype=np.int32),
                          (rows, T)).copy()
    if rows > 1:
        pos[1, T // 2:] = -1
    eff = np.full((rows,), win or ops.NO_WINDOW, np.int32)
    return q, kp, vp, table, pos, eff


def _jax(case, dtype: str, arrays) -> np.ndarray:
    q, kp, vp, table, pos, eff = arrays
    jt = getattr(jnp, dtype)
    out = jax_prefill(jnp.asarray(q, jt), jnp.asarray(kp, jt),
                      jnp.asarray(vp, jt), jnp.asarray(table),
                      jnp.asarray(pos), scale=case[1] ** -0.5,
                      interpret=True, softcap=case[8],
                      eff_win=jnp.asarray(eff))
    return np.asarray(out.astype(jnp.float32))


def _torch(dtype: str, arrays):
    q, kp, vp, table, pos, eff = (torch.from_numpy(np.ascontiguousarray(a))
                                  for a in arrays)
    dt = getattr(torch, dtype)
    return q.to(dt), kp.to(dt), vp.to(dt), table, pos, eff


# ---------------------------------------------------- the kernel's arithmetic


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` as the kernels' tf32_rna takes it."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the 3xTF32 form: each operand a TF32 value and a
    remainder read as TF32 (13 low bits dropped), the small x small
    product left out."""
    def split(x):
        big = tf32(x)
        small = (x - big).contiguous().view(torch.int32) & -0x2000
        return big, small.view(torch.float32)
    ab, as_ = split(a)
    bb, bs = split(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product (the control)."""
    return tf32(a) @ tf32(b)


def generic_emulated(q, k_pages, v_pages, table, q_pos, scale,
                     softcap=None, eff_win=None, mm=mm_3xtf32):
    """paged_prefill_generic_kernel's arithmetic in torch, block by block
    as its plan cuts the call: a block's 64 rows are (query t0 + r // GT,
    head h0 + r % GT) of one (row, kv head); it walks the key blocks of
    its queries' visible extent, KB positions each, key j on page
    table[b, j // ps] at slot j % ps (a page id outside the pool masks
    its keys and is not read). S = Q K^T, the online softmax in log2
    units (masked keys -inf), O = O alpha + P V: in float32 both products
    by ``mm`` (each block's P V from zero, added in float32), in 16 bits
    float32 products of the 16-bit values with P rounded to the type.
    Past head_dim 256 each of the plan's value-column tiles is a block of
    its own, which takes the scores over the whole head_dim and writes
    its columns alone. Returns float32 [B, T, H, hd] (padding queries
    zero)."""
    B, T, H, hd = q.shape
    N, KV, ps, _ = k_pages.shape
    P = table.shape[1]
    G = H // KV
    f32 = q.dtype == torch.float32
    plan = ops.prefill_generic_plan(G, ps, hd, q.dtype)
    kb, gt, tq = plan.keys, plan.heads, plan.queries
    win = (eff_win.long() if eff_win is not None
           else torch.full((B,), ops.NO_WINDOW, dtype=torch.long))
    kf, vf, qf = k_pages.float(), v_pages.float(), q.float()
    out = torch.zeros(B, T, H, hd)
    r = torch.arange(plan.rows)
    for b, kv, tile, t0, c0 in itertools.product(
            range(B), range(KV), range(plan.head_tiles), range(0, T, tq),
            range(0, hd, plan.col_width)):
        cols = slice(c0, min(c0 + plan.col_width, hd))
        tl, g = r // gt, tile * plan.rows + r % gt
        t = t0 + tl
        live = (tl < tq) & (g < G) & (t < T)
        tc, gc = t.clamp(max=T - 1), g.clamp(max=G - 1)
        Q = torch.where(live[:, None], qf[b, tc, kv * G + gc],
                        torch.zeros(()))
        qp = torch.where(live, q_pos[b, tc].long(), torch.tensor(-1))
        ts = q_pos[b, t0:t0 + tq].long()
        length = int(ts.max()) + 1
        minq = int(ts[ts >= 0].min()) if (ts >= 0).any() else 0
        lo = min(max(minq + 1 - int(win[b]), 0), max(length - 1, 0))
        j_end = min(-(-length // kb), -(-(P * ps) // kb))
        m = torch.full((plan.rows,), ops.NEG_INF)
        l = torch.zeros(plan.rows)
        o = torch.zeros(plan.rows, cols.stop - cols.start)
        for j in range(lo // kb, j_end):
            keys = torch.arange(j * kb, (j + 1) * kb)
            p = keys // ps
            page = torch.where(p < P, table[b, p.clamp(max=P - 1)].long(),
                               torch.tensor(-1))
            ok = (page >= 0) & (page < N)
            pc, slot = page.clamp(0, N - 1), keys % ps
            K = torch.where(ok[:, None], kf[pc, kv, slot], torch.zeros(()))
            V = torch.where(ok[:, None], vf[pc, kv, slot][:, cols],
                            torch.zeros(()))
            s = mm(Q, K.T) if f32 else Q @ K.T
            x = s * scale
            if softcap:
                x = softcap * torch.tanh(x / softcap)
            x = x * LOG2E
            vis = (ok[None] & (keys[None] <= qp[:, None])
                   & (keys[None] > qp[:, None] - win[b]))
            x = torch.where(vis, x, torch.tensor(float("-inf")))
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - m_new)
            pr = torch.exp2(x - m_new[:, None])
            l = l * alpha + pr.sum(-1)
            pv = mm(pr, V) if f32 else pr.to(q.dtype).float() @ V
            o = o * alpha[:, None] + pv
            m = m_new
        o = o / l.clamp(min=1e-9)[:, None]
        out[b, t[live], kv * G + g[live], cols] = o[live]
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_generic_prefill_plain_and_emulation_match_jax_kernel(case, dtype):
    """At each generic shape, in each dtype: the wrapper's plain path and
    the kernel's emulated arithmetic against the JAX kernel in interpret
    mode (atol 2e-2 in 16 bits, 1e-5 in float32); padding queries zero."""
    arrays = _inputs(case, dtype)
    want = _jax(case, dtype, arrays)
    q, kp, vp, table, pos, eff = _torch(dtype, arrays)
    tol = F32 if dtype == "float32" else BF16
    got = ops.paged_attention_prefill(q, kp, vp, table, pos,
                                      softcap=case[8], eff_win=eff)
    assert got.dtype == q.dtype
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    emu = generic_emulated(q, kp, vp, table, pos, case[1] ** -0.5, case[8],
                           eff).to(q.dtype)
    np.testing.assert_allclose(emu.float().numpy(), want, **tol)
    assert not emu[pos < 0].any() and not got[pos < 0].any()


def test_generic_prefill_one_tf32_product_misses_float32():
    """The control: the emulation with one TF32 product for each float32
    product misses atol 1e-5, so the test can see the 3xTF32 form."""
    case = CASES[0]
    arrays = _inputs(case, "float32")
    want = _jax(case, "float32", arrays)
    q, kp, vp, table, pos, eff = _torch("float32", arrays)
    emu = generic_emulated(q, kp, vp, table, pos, case[1] ** -0.5, None,
                           eff, mm=mm_tf32)
    assert np.abs(emu.numpy() - want).max() > 1e-5


def test_generic_prefill_masks_pages_outside_the_pool():
    """A table entry outside [0, N) contributes nothing and is not read,
    as the kernel takes it: with entry 1 of row 0 set to N and to -1,
    the queries on page 0 give what they gave, the later ones (which
    lose that page's keys) change and stay finite."""
    case = CASES[1]
    q, kp, vp, table, pos, eff = _torch("float32", _inputs(case, "float32"))
    N, ps = kp.shape[0], kp.shape[2]
    bad = table.clone()
    ref = generic_emulated(q, kp, vp, table, pos, case[1] ** -0.5)
    for page in (N, -1):
        bad[0, 1] = page
        got = generic_emulated(q, kp, vp, bad, pos, case[1] ** -0.5)
        # queries before the page see the same keys
        np.testing.assert_array_equal(got[0, :ps].numpy(),
                                      ref[0, :ps].numpy())
        # the others see fewer: the page's keys dropped changes them
        assert not torch.equal(got[0, ps + 1:], ref[0, ps + 1:])
        assert torch.isfinite(got).all()


# ------------------------------------------------------- routes and plans


@pytest.mark.parametrize("dtype", DTYPES)
def test_generic_prefill_routes_by_shape(dtype):
    """Every CASES shape runs the generic kernel in 16 bits, and in
    float32 where route 2's set leaves it (head_dim 16 or 64 at page 8 is
    route 2's); the bf16 set takes routes 1 (bfloat16) and 3 (float16),
    the float32 set route 2; float32 never takes a 16-bit route nor 16
    bits the float32 one."""
    dt = getattr(torch, dtype)
    for _, hd, ps, G, KV, *_ in CASES:
        f32_set = (hd in ops.F32_HEAD_DIMS and ps in ops.F32_PAGE_SIZES
                   and G <= ops.F32_MAX_GROUP)
        assert ops.prefill_route(dt, KV * G, KV, ps, hd) == (
            2 if dtype == "float32" and f32_set else 0)
        assert ops.prefill_generic_shape(dt, hd)
    fast = {"float32": 2, "bfloat16": 1, "float16": 3}[dtype]
    for hd in (16, 32, 64, 128, 256):
        for ps in (4, 8, 16, 48, 64, 128):
            for G in (1, 4, 8, 9, 71):
                route = ops.prefill_route(dt, 2 * G, 2, ps, hd)
                if dtype == "float32":
                    inside = ps in ops.F32_PAGE_SIZES and G <= 8
                else:
                    inside = (hd in ops.PREFILL_BF16_HEAD_DIMS
                              and ps in ops.PREFILL_BF16_PAGE_SIZES
                              and G <= 8)
                assert route == (fast if inside else 0), (hd, ps, G)
    assert ops.PREFILL_ROUTES[0] == "generic"


def test_generic_prefill_shape_set():
    """Any head_dim from 1 to the dtype's bound: 656 in float32, 576 in
    bfloat16 and float16; the bound is the shared memory's, the largest
    head_dim below which the plans of both generic kernels fit a block's
    227 KB (the next one's does not)."""
    assert ops.GENERIC_MAX_HEAD_DIM == {torch.float32: 656,
                                        torch.bfloat16: 576,
                                        torch.float16: 576}
    for dt, bound in ops.GENERIC_MAX_HEAD_DIM.items():
        for hd in range(0, 800):
            assert ops.prefill_generic_shape(dt, hd) == (1 <= hd <= bound)
            fits = (ops.prefill_generic_plan(4, 8, hd or 1, dt).smem
                    <= ops.SMEM_LIMIT
                    and ops.decode_generic_plan(4, 8, hd or 1, dt).smem
                    <= ops.SMEM_LIMIT)
            if hd <= bound:
                assert fits, (dt, hd)
            elif hd == bound + 1:
                assert not fits, (dt, hd)


@pytest.mark.parametrize("dtype", DTYPES)
def test_generic_prefill_plan_covers_every_pair_once(dtype):
    """Over a grid of groups and chunk lengths, the plan's blocks (query
    tiles x head tiles of 64 rows) cover every (query, head) pair of a kv
    head exactly once; at every head_dim its shared memory fits a block's
    227 KB, two blocks an SM at head_dim up to 128 (each block also
    takes 1 KB of the SM's 228 KB), and the padded width holds the
    head_dim."""
    dt = getattr(torch, dtype)
    for G in (1, 2, 3, 4, 7, 8, 9, 16, 31, 64, 65, 71, 128, 130):
        for T in (1, 5, 63, 64, 130):
            plan = ops.prefill_generic_plan(G, 8, 64, dt)
            assert plan.rows == 64 and plan.heads == min(G, 64)
            assert plan.queries == 64 // plan.heads
            seen = []
            for tile in range(plan.head_tiles):
                for t0 in range(0, T, plan.queries):
                    for r in range(plan.rows):
                        t, g = t0 + r // plan.heads, (tile * plan.rows
                                                      + r % plan.heads)
                        if r // plan.heads < plan.queries and g < G \
                                and t < T:
                            seen.append((t, g))
            assert sorted(seen) == [(t, g) for t in range(T)
                                    for g in range(G)], (G, T)
    for hd in range(1, ops.GENERIC_MAX_HEAD_DIM[dt] + 1):
        for ps in (1, 4, 8, 48, 64):
            plan = ops.prefill_generic_plan(4, ps, hd, dt)
            assert plan.head_dim >= hd and plan.head_dim % 16 == 0
            assert plan.keys % (8 if dtype == "float32" else 16) == 0
            assert plan.stages == 2
            assert plan.smem <= ops.SMEM_LIMIT
            # value-column tiles of at most 256 columns cover head_dim
            tiles = [(c, min(c + plan.col_width, hd))
                     for c in range(0, hd, plan.col_width)]
            assert len(tiles) == plan.col_tiles == -(-hd // 256)
            assert plan.col_width % 8 == 0 or plan.col_tiles == 1
            assert plan.col_pad >= plan.col_width and plan.col_pad <= 256
            if hd <= 128:
                assert 2 * (plan.smem + 1024) <= 228 * 1024, (hd, plan)


# ------------------------------------------------------------- an engine


ECFG = dict(page_size=8, num_pages=64, max_batch=4, prefill_chunk=16,
            prefill_buckets=(16,), batch_buckets=(1, 2, 4), page_buckets=(8,),
            decode_steps=4)


def _generate(engine, request_cls, stop_cls, ctx_cls, prompt, n):
    async def run():
        toks = []
        try:
            req = request_cls(token_ids=list(prompt),
                              stop=stop_cls(max_tokens=n))
            async for out in engine.generate(req, ctx_cls()):
                toks += out.token_ids
        finally:
            await engine.stop()
        return toks
    return asyncio.run(run())


def test_bf16_tiny_engine_at_page_8_matches_jax_engine():
    """The tiny preset in bfloat16 at page size 8 (head_dim 16: outside
    the bf16 kernel's set, so on the card its prefill runs the generic
    kernel) on seed-3 JAX params carried over by params_from_numpy (the
    seed tests/test_torch_f16.py takes), greedy on a 40-token prompt
    prefilled in three chunks: the port's tokens equal JaxEngine's, and
    the port's own at page 16. (On seed 5 the two packages' bf16 part at
    the fifth token at pages 8 and 16 alike, where the port gives the
    float32 engines' tokens: a near tie that bf16 rounding in another
    place flips, not the page size.)"""
    jcfg = dataclasses.replace(JaxModelConfig.tiny(), dtype="bfloat16")
    tcfg = ModelConfig.tiny(dtype="bfloat16")
    assert ops.prefill_route(torch.bfloat16, tcfg.num_heads,
                             tcfg.num_kv_heads, ECFG["page_size"],
                             tcfg.head_dim_) == 0
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(3))
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                               tcfg, device="cpu")
    jeng = JaxEngine(jcfg, JaxEngineConfig(**ECFG), params=jparams)
    prompt = range(30, 70)
    want = _generate(jeng, JaxRequest, JaxStop, JaxContext, prompt, 8)
    assert want == [197, 454, 76, 57, 76, 405, 228, 221]
    for ps in (8, 16):
        teng = TorchEngine(tcfg, EngineConfig(**dict(ECFG, page_size=ps,
                                                     page_buckets=(ps,))),
                           params=params, device="cpu")
        assert teng.params["embed"].dtype == torch.bfloat16
        got = _generate(teng, PreprocessedRequest, StopConditions, Context,
                        prompt, 8)
        assert got == want, ps
