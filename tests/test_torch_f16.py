"""float16 in the port, on the CPU, against the JAX package.

The JAX package serves ``ModelConfig(dtype="float16")``: its Pallas
kernels are dtype-generic. The port serves it on the float16 forms of the
bf16 attention kernels (decode route ``f16_mma``, prefill route ``f16``)
and of the int8 GEMM's tensor-core routes (``small_m_f16``,
``wgmma_f16``). Those run only on the card (tests/test_torch_kernels.py
holds them to the plain versions there); here the wrappers' plain
versions, the routes and plans, the float16 widening of the int8
weights, and whole float16 engines are held to the JAX package:

- the attention wrappers (decode with stats and softcap, its window
  form, prefill, and the sharded forms at tp=2's heads) against the JAX
  kernels in interpret mode on the same float16 inputs (made with
  numpy): atol 3e-3 + rtol 2e-3, one or two float16 roundings of an
  output of magnitude up to ~1 (2^-11 relative each, plus the two sides'
  float32 sums in another order); the stats (float32 on both sides) at
  atol 1e-5 + rtol 1e-5;
- the widening (``widen_f16x4`` and ``widen_f16x4_split`` in
  ``ops/csrc/int8_gemm.cu``) emulated bit for bit in numpy: exact for all
  256 bytes;
- ``int8_matmul_plain`` in float16 bitwise against the JAX
  ``QuantInt8.__rmatmul__`` (both round the product to float16 before
  the scale);
- ``TorchEngine`` on the float16 tiny preset, with bf16-style weights and
  with ``quant="int8"``: greedy tokens equal ``JaxEngine``'s.
"""

import asyncio
import dataclasses

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
from dynamo_tpu.models.quant import QuantInt8 as JaxQuantInt8
from dynamo_tpu.models.quant import quantize_int8 as jax_quantize_int8
from dynamo_tpu.parallel import mesh as jmesh
from dynamo_tpu.ops import paged_attention as jops
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                   StopConditions)
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.quant import QuantInt8
from dynamo_tpu_torch.ops import int8_gemm
from dynamo_tpu_torch.ops import paged_attention as ops
from dynamo_tpu_torch.parallel.mesh import MeshSpec
from dynamo_tpu_torch.runtime.engine import Context

F16 = dict(atol=3e-3, rtol=2e-3)
STATS = dict(atol=1e-5, rtol=1e-5)
H100_SMS = 132


def _f16(a: np.ndarray):
    """(jax array, torch tensor) of the same data in float16."""
    a = np.ascontiguousarray(a.astype(np.float16))
    return jnp.asarray(a), torch.from_numpy(a)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _table(rng, B, P, N):
    return np.stack([rng.permutation(np.arange(1, N))[:P]
                     for _ in range(B)]).astype(np.int32)


# --------------------------------------------------------------- wrappers


@pytest.mark.parametrize("G,hd,ps", [(4, 128, 16), (1, 64, 32),
                                     (3, 96, 4)])  # the last outside the set
def test_f16_decode_layered_matches_jax_kernel(G, hd, ps):
    """The layered decode wrapper in float16 with stats, softcap and a
    lower bound (a row of length 0, an emptied view) against the JAX
    kernel in interpret mode on the same float16 inputs; at 4 x 128 x 16
    the float16 form's shapes, at 3 x 96 x 4 a shape outside them (the
    generic kernel's on the card)."""
    rng = np.random.RandomState(G + hd + ps)
    L, KV, B, P, N = 2, 2, 5, 4, 24
    H = KV * G
    qj, qt = _f16(rng.randn(B, H, hd))
    kj, kt = _f16(rng.randn(L, N, KV, ps, hd))
    vj, vt = _f16(rng.randn(L, N, KV, ps, hd))
    table = _table(rng, B, P, N)
    lengths = np.array([0, 1, ps + 3, 3 * ps, P * ps], np.int32)
    lower = np.array([0, 0, 2, 3 * ps, ps + 1], np.int32)
    for layer in range(L):
        want = jops.paged_attention_decode_layered(
            qj, kj, vj, jnp.int32(layer), jnp.asarray(table),
            jnp.asarray(lengths), interpret=True, return_stats=True,
            softcap=25.0, lower=jnp.asarray(lower))
        got = ops.paged_attention_decode_layered(
            qt, kt, vt, layer, torch.from_numpy(table),
            torch.from_numpy(lengths), return_stats=True, softcap=25.0,
            lower=torch.from_numpy(lower))
        assert got[0].dtype == torch.float16 and want[0].dtype == jnp.float16
        np.testing.assert_allclose(_np(got[0]), _np(want[0]), **F16)
        np.testing.assert_allclose(_np(got[1]), _np(want[1]), **STATS)
        np.testing.assert_allclose(_np(got[2]), _np(want[2]), **STATS)
    assert (_np(got[0])[0] == 0).all() and (_np(got[2])[3] == 0).all()


@pytest.mark.parametrize("window", [None, 5])
def test_f16_decode_window_matches_jax(window):
    """The window form in float16 (pool + in-flight keys in one softmax)
    against JAX's _pool_window_attention_pallas in interpret mode, at
    every step of a 3-step window, with softcap and a sliding window;
    the padding row (start -1) is discarded by the window on both sides
    and not compared."""
    rng = np.random.RandomState(11)
    L, KV, G, hd, ps, B, P, N, K = 2, 2, 4, 64, 16, 4, 3, 16, 3
    H = KV * G
    qj, qt = _f16(rng.randn(B, 1, H, hd))
    kj, kt = _f16(rng.randn(L, N, KV, ps, hd))
    vj, vt = _f16(rng.randn(L, N, KV, ps, hd))
    wkj, wkt = _f16(rng.randn(B, K, KV, hd))
    wvj, wvt = _f16(rng.randn(B, K, KV, hd))
    table = _table(rng, B, P, N)
    start = np.array([13, -1, 40, 0], np.int32)
    live = start >= 0
    scale = hd ** -0.5
    for i in range(K):
        q_pos = (np.maximum(start, 0) + i).astype(np.int32)
        want = jl._pool_window_attention_pallas(
            qj, kj, vj, jnp.int32(1), jnp.asarray(table), jnp.asarray(start),
            wkj, wvj, i, scale, interpret=True, q_pos=jnp.asarray(q_pos),
            softcap=30.0, window=window, is_sliding=window is not None)[:, 0]
        eff = (None if window is None else
               torch.full((B,), window, dtype=torch.int32))
        got = ops.paged_attention_decode_window(
            qt[:, 0].contiguous(), kt, vt, 1, torch.from_numpy(table),
            torch.from_numpy(start), torch.from_numpy(q_pos), wkt, wvt,
            i + 1, scale=scale, softcap=30.0, eff_win=eff)
        assert got.dtype == torch.float16
        np.testing.assert_allclose(_np(got)[live], _np(want)[live], **F16)
        assert not got[~torch.from_numpy(live)].any()


@pytest.mark.parametrize("G,hd,ps", [(4, 128, 16), (2, 64, 32)])
def test_f16_prefill_matches_jax_kernel(G, hd, ps):
    """The prefill wrapper in float16: a chunk continuing mid-sequence, a
    row with padding queries, a sliding window on one row, softcap,
    against the JAX kernel in interpret mode."""
    rng = np.random.RandomState(G * hd + ps)
    B, T, KV, N, P = 3, 24, 2, 24, 5
    H = KV * G
    qj, qt = _f16(rng.randn(B, T, H, hd))
    kj, kt = _f16(rng.randn(N, KV, ps, hd))
    vj, vt = _f16(rng.randn(N, KV, ps, hd))
    table = _table(rng, B, P, N)
    pos = np.full((B, T), -1, np.int32)
    pos[0] = np.arange(40, 40 + T)
    pos[1, :9] = np.arange(9)
    pos[2] = np.arange(T)
    eff = np.array([ops.NO_WINDOW, ops.NO_WINDOW, 7], np.int32)
    want = jops.paged_attention_prefill(
        qj, kj, vj, jnp.asarray(table), jnp.asarray(pos), interpret=True,
        softcap=20.0, eff_win=jnp.asarray(eff))
    got = ops.paged_attention_prefill(
        qt, kt, vt, torch.from_numpy(table), torch.from_numpy(pos),
        softcap=20.0, eff_win=torch.from_numpy(eff))
    assert got.dtype == torch.float16
    np.testing.assert_allclose(_np(got), _np(want), **F16)
    assert (_np(got)[1, 9:] == 0).all()


def test_f16_sharded_wrappers_match_jax_at_tp2():
    """The sharded decode (layered, with stats) and prefill wrappers in
    float16, each rank of model=2 on its heads, joined, against JAX's
    sharded wrappers in interpret mode at tp=2."""
    rng = np.random.RandomState(5)
    L, KV, G, hd, ps, B, P, N, T = 2, 2, 2, 64, 16, 4, 3, 16, 16
    H = KV * G
    mesh, spec = jmesh.MeshSpec(data=1, model=2).build(), MeshSpec(model=2)
    q = rng.randn(B, H, hd).astype(np.float16)
    kp = rng.randn(L, N, KV, ps, hd).astype(np.float16)
    vp = rng.randn(L, N, KV, ps, hd).astype(np.float16)
    table = _table(rng, B, P, N)
    lengths = np.array([0, 5, 19, 48], np.int32)
    lower = np.array([0, 2, 9, 0], np.int32)
    want = jops.paged_attention_decode_sharded(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), 1,
        jnp.asarray(table), jnp.asarray(lengths), mesh=mesh, interpret=True,
        return_stats=True, softcap=20.0, lower=jnp.asarray(lower))
    qf = rng.randn(B, T, H, hd).astype(np.float16)
    pos = np.full((B, T), -1, np.int32)
    pos[0] = np.arange(T)
    pos[1, :5] = np.arange(5)
    pos[2] = np.arange(16, 16 + T)
    pos[3] = np.arange(8, 8 + T)
    want_pf = jops.paged_attention_prefill_sharded(
        jnp.asarray(qf), jnp.asarray(kp[0]), jnp.asarray(vp[0]),
        jnp.asarray(table), jnp.asarray(pos), mesh=mesh, interpret=True)
    hl, kl = H // 2, KV // 2
    outs, pfs = [], []
    for m in range(2):
        view = spec.view(m)
        heads, kvs = slice(m * hl, (m + 1) * hl), slice(m * kl, (m + 1) * kl)
        kk = torch.from_numpy(kp[:, :, kvs].copy())
        vv = torch.from_numpy(vp[:, :, kvs].copy())
        outs.append(ops.paged_attention_decode_sharded(
            torch.from_numpy(q[:, heads].copy()), kk, vv, 1,
            torch.from_numpy(table), torch.from_numpy(lengths), mesh=view,
            kv_heads=KV, return_stats=True, softcap=20.0,
            lower=torch.from_numpy(lower)))
        pfs.append(ops.paged_attention_prefill_sharded(
            torch.from_numpy(qf[:, :, heads].copy()), kk[0], vv[0],
            torch.from_numpy(table), torch.from_numpy(pos), mesh=view,
            kv_heads=KV))
    got = [torch.cat([o[i] for o in outs], dim=1) for i in range(3)]
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), **F16)
    for i in (1, 2):
        np.testing.assert_allclose(_np(got[i]), _np(want[i]), **STATS)
    np.testing.assert_allclose(_np(torch.cat(pfs, dim=2)), _np(want_pf),
                               **F16)


# ------------------------------------------------------------ routes, plans


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_f16_routes_take_the_bf16_set(hd):
    """float16 takes the float16 forms (decode 3, ``f16_mma``; prefill 3,
    ``f16``) exactly where bfloat16 takes the bf16 kernels; elsewhere the
    generic decode and prefill kernels (0), as bf16 does; float16 never
    takes the float32 route."""
    for ps in (4, 8, 16, 32, 48, 64, 128, 256):
        for G in (1, 3, 4, 8, 9):
            bf = ops.decode_route(torch.bfloat16, 2 * G, 2, ps, hd)
            assert ops.decode_route(torch.float16, 2 * G, 2, ps, hd) == (
                3 if bf == 1 else 0)
            assert ops.prefill_route(torch.float16, 2 * G, 2, ps, hd) == (
                3 if bf == 1 else 0)
    assert ops.DECODE_ROUTES[3] == "f16_mma" and ops.PREFILL_ROUTES[3] == "f16"
    assert ops.decode_route(torch.float16, 6, 2, 4, 96) == 0


def test_f16_int8_plan_takes_the_tensor_core_routes():
    """float16 x takes small_m and wgmma with the bf16 plans at every
    served shape and row count; float32 x takes the float32 forms of the
    same routes; the launches of a float16 call count under the route's
    ``_f16`` key."""
    shapes = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
              (4096, 128256), (2048, 512)]
    for K, N in shapes:
        for M in (1, 4, 16, 24, 32, 48, 64, 512, 4096):
            bf = int8_gemm.int8_gemm_plan(M, N, K, H100_SMS, torch.bfloat16)
            f16 = int8_gemm.int8_gemm_plan(M, N, K, H100_SMS, torch.float16)
            assert f16 == bf and f16.route in int8_gemm.INT8_GEMM_ROUTES
            assert int8_gemm.int8_gemm_plan(
                M, N, K, H100_SMS,
                torch.float32).route in int8_gemm.INT8_GEMM_ROUTES
    assert int8_gemm.launch_key("wgmma", torch.float16) == "wgmma_f16"
    assert int8_gemm.launch_key("small_m", torch.bfloat16) == "small_m"
    assert set(int8_gemm.INT8_GEMM_LAUNCHES) == {
        "small_m", "wgmma", "small_m_f16", "wgmma_f16", "small_m_f32",
        "wgmma_f32"}


def test_f16_int8_gemm_work_counts_two_byte_activations():
    w16 = int8_gemm.int8_gemm_work(512, 4096, 4096, torch.float16)
    assert w16 == int8_gemm.int8_gemm_work(512, 4096, 4096, torch.bfloat16)
    assert w16["bytes"] == 4096 * 4096 + 4 * 4096 + 2 * 512 * (4096 + 4096)


# --------------------------------------------------------------- widening


def _f16_bits(u16: np.ndarray) -> np.ndarray:
    return u16.astype(np.uint16).view(np.float16)


def _byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's __byte_perm(x, y, sel): byte n of the result is byte
    (sel >> 4n) & 7 of the eight bytes of (y:x), x's the lower four."""
    pool = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
           [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= pool[(sel >> (4 * n)) & 7] << (8 * n)
    return out


def _sub_f16x2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """sub.rn.f16x2: the two halves' float16 difference (numpy rounds
    float16 arithmetic to nearest even, as the card does)."""
    lo = _f16_bits(a & 0xFFFF) - _f16_bits(b & 0xFFFF)
    hi = _f16_bits(a >> 16) - _f16_bits(b >> 16)
    return (lo.view(np.uint16).astype(np.uint32)
            | (hi.view(np.uint16).astype(np.uint32) << 16))


def _halves(pair: np.ndarray):
    return _f16_bits(pair & 0xFFFF), _f16_bits(pair >> 16)


def test_f16_widening_is_exact_for_every_byte():
    """The float16 widenings of csrc/int8_gemm.cu emulated bit for bit:
    each byte, offset by 128, ORed or permuted into the low mantissa byte
    of 1024 (0x6400) and 1024 + 128 (0x6480) subtracted, gives the signed
    byte exactly, for all 256 bytes in every position of the word, and
    leaves the word's other bytes their own values."""
    b = np.arange(256, dtype=np.uint32)
    want = b.astype(np.uint8).view(np.int8).astype(np.float32)
    one152 = np.uint32(0x64806480)
    for pos in range(4):
        # the byte in position pos, its neighbours other bytes
        rest = 0x5A3C0F71 & ~(0xFF << (8 * pos)) & 0xFFFFFFFF
        w = ((b << (8 * pos)) | np.uint32(rest)).astype(np.uint32)
        u = w ^ np.uint32(0x80808080)
        # widen_f16x4: bytes 0, 1 -> lo, 2, 3 -> hi
        lo = _sub_f16x2(_byte_perm(u, np.uint32(0x64646464), 0x4140), one152)
        hi = _sub_f16x2(_byte_perm(u, np.uint32(0x64646464), 0x4342), one152)
        vals = [*_halves(lo), *_halves(hi)]
        np.testing.assert_array_equal(vals[pos].astype(np.float32), want)
        # widen_f16x4_split: bytes 0, 2 -> even, 1, 3 -> odd
        even = _sub_f16x2((u & 0x00FF00FF) | 0x64006400, one152)
        odd = _sub_f16x2(((u >> 8) & 0x00FF00FF) | 0x64006400, one152)
        split = [_halves(even)[0], _halves(odd)[0], _halves(even)[1],
                 _halves(odd)[1]]
        np.testing.assert_array_equal(split[pos].astype(np.float32), want)
        # every other position keeps its own byte
        for p in range(4):
            own = ((w >> (8 * p)) & 0xFF).astype(np.uint8).view(np.int8)
            np.testing.assert_array_equal(vals[p].astype(np.float32), own)
            np.testing.assert_array_equal(split[p].astype(np.float32), own)


# ------------------------------------------------------------------- int8


def test_f16_int8_matmul_plain_is_bitwise_jax_rmatmul():
    """int8_matmul_plain in float16 (the JAX order: the product rounded
    to float16 with the weights widened to float16, then the scale in
    float16) gives JAX QuantInt8.__rmatmul__'s bits, and the wrapper on
    CPU tensors is that plain version."""
    rng = np.random.RandomState(2)
    w = (rng.randn(96, 40) * 0.05).astype(np.float32)
    x = rng.randn(7, 96).astype(np.float16)
    jq = jax_quantize_int8(jnp.asarray(w))
    assert isinstance(jq, JaxQuantInt8)
    want = np.asarray(jnp.asarray(x) @ jq)
    q = torch.from_numpy(np.asarray(jq.q).T.copy())
    s = torch.from_numpy(np.asarray(jq.s).reshape(-1).copy())
    got = int8_gemm.int8_matmul_plain(torch.from_numpy(x), q, s)
    assert got.dtype == torch.float16 and want.dtype == np.float16
    np.testing.assert_array_equal(got.numpy().view(np.uint16),
                                  want.view(np.uint16))
    assert torch.equal(int8_gemm.int8_matmul(torch.from_numpy(x), q, s), got)


# ----------------------------------------------------------------- engine

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


@pytest.mark.parametrize("quant,want", [
    (None, [197, 454, 76, 57, 76, 365, 162, 264]),
    ("int8", [197, 454, 76, 57, 76, 405, 228, 221])])
def test_f16_tiny_engine_greedy_tokens_match_jax_engine(quant, want):
    """The float16 tiny preset on seed-3 JAX params (carried over by
    params_from_numpy), greedy on a 40-token prompt prefilled in three
    chunks: the port's tokens equal JaxEngine's, with bf16-style weights
    and with quant="int8" (each engine quantizes the same float16
    weights); the port's params are float16 (its int8 scales float32)."""
    jcfg = dataclasses.replace(JaxModelConfig.tiny(), dtype="float16")
    tcfg = dataclasses.replace(ModelConfig.tiny(), dtype="float16")
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(3))
    jeng = JaxEngine(jcfg, JaxEngineConfig(**ECFG), params=jparams,
                     quant=quant)
    teng = TorchEngine(tcfg, EngineConfig(**ECFG), params=params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, tcfg, device="cpu"),
        device="cpu", quant=quant)
    assert teng.params["embed"].dtype == torch.float16
    assert isinstance(teng.params["wq"], QuantInt8) == (quant == "int8")
    prompt = range(30, 70)
    jax_toks = _generate(jeng, JaxRequest, JaxStop, JaxContext, prompt, 8)
    got = _generate(teng, PreprocessedRequest, StopConditions, Context,
                    prompt, 8)
    assert jax_toks == want
    assert got == jax_toks
