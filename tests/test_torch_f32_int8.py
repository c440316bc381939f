"""The int8 GEMM's float32 forms on the CPU: their arithmetic emulated in
numpy and held to the stated tolerance, their plans, and a float32 int8
engine against the JAX package.

The float32 forms of ``small_m`` and ``wgmma`` (``ops/csrc/int8_gemm.cu``,
``small_m_f32`` and ``wgmma_f32``) run only on the card
(tests/test_torch_kernels.py holds them to the plain version there).
What they compute is checked here bit for bit where it is exact and
against ``int8_gemm_tolerance`` where it rounds:

- the widening (``widen_f32x4``, ``widen_f32_byte``): every byte value in
  every position of a word gives its exact integer as a float whose 13
  low mantissa bits are zero, so the tensor cores read it exactly as
  TF32;
- 2xTF32: x's TF32 part hi (its 13 low bits dropped, as the tensor
  cores read x) and lo = x - hi, exact in float32 and itself read as
  TF32; two products a k8 step, each mma's sum of eight products added
  to its accumulator and rounded toward zero (the tensor cores'
  accumulation, PERF.md, Findings); each ring stage's (small_m: 16 k8
  steps, 32 adds) or chunk's (wgmma: 8 steps, 16 adds) products summed
  from zero and added to a float32 sum; the four K groups (small_m) and
  the K splits folded in order. Held to the tolerance at the 1b's K
  (2,048 and 8,192) and the tiny preset's (64, 128), on random x and on
  all-positive x; a control with hi alone (one TF32 product) must fail
  it, and one long chain without the stage sums must fail it where every
  product has one sign;
- the plans: float32 takes ``small_m`` at and below its crossover
  (``SMALL_M_TAKES_F32``) and ``wgmma`` above it, at every row count;
- ``TorchEngine`` with ``quant="int8"`` in float32 at the 1b's head
  geometry (head_dim 64, four query heads a kv head), two narrow layers:
  greedy tokens equal ``JaxEngine``'s.
"""

import asyncio

import jax
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
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                   StopConditions)
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.quant import QuantInt8
from dynamo_tpu_torch.ops import int8_gemm
from dynamo_tpu_torch.runtime.engine import Context

H100_SMS = 132

# ------------------------------------------------------------- widening


def _widen_f32(u: np.ndarray, byte: int) -> np.ndarray:
    """widen_f32_byte: byte ``byte`` of the words u (already XORed with
    0x80808080) permuted into the low byte of 0x4B000000 (the float 2^23
    + that byte), less 2^23 + 128, in float32."""
    bits = np.uint32(0x4B000000) | ((u >> np.uint32(8 * byte))
                                    & np.uint32(0xFF))
    return bits.view(np.float32) - np.float32(8388736.0)


@pytest.mark.parametrize("pos", [0, 1, 2, 3])
def test_f32_widening_is_exact_tf32_for_every_byte(pos):
    """Every int8 value in byte ``pos`` of a weight word (the other bytes
    random) widens to its exact integer, and the float's 13 low mantissa
    bits are zero: TF32 holds it exactly."""
    rng = np.random.default_rng(pos)
    vals = np.arange(-128, 128, dtype=np.int64)
    others = rng.integers(0, 256, (vals.size, 4), dtype=np.int64)
    others[:, pos] = vals & 0xFF
    words = (others[:, 0] | others[:, 1] << 8 | others[:, 2] << 16
             | others[:, 3] << 24).astype(np.uint32)
    u = words ^ np.uint32(0x80808080)
    f = _widen_f32(u, pos)
    assert np.array_equal(f, vals.astype(np.float32))
    assert not np.any(f.view(np.uint32) & np.uint32(0x1FFF))


# ----------------------------------------------------------- 2xTF32


def _trunc_f32(a: np.ndarray) -> np.ndarray:
    """float64 to float32 rounded toward zero."""
    f = a.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(a)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _tf32(x: np.ndarray) -> np.ndarray:
    """x as the tensor cores read a float32 operand: 13 low bits dropped."""
    return (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def emulate(x, q, s, form: str, splits: int = 1, lo: bool = True,
            stage_sums: bool = True) -> np.ndarray:
    """The float32 forms' arithmetic on x [M, K] float32, q [N, K] int8,
    s [N]: float32 [M, N]. Per k8 step an mma adds lo q then hi q (eight
    products each, summed exactly) to its accumulator, rounded toward
    zero. ``small_m``: K in splits of whole 128-wide stages, a split's
    stages dealt to four K groups in turn; each stage's 16 steps from
    zero, added to its group's float32 sum; the groups summed in order.
    ``wgmma``: K in splits of whole 64-wide chunks, each chunk's 8 steps
    from zero, added to the split's float32 sum. The splits summed in
    rank order, then the scale. ``lo=False``: hi alone (one TF32
    product); ``stage_sums=False``: one chain over a split."""
    M, K = x.shape
    hi = _tf32(x)
    xl = _tf32((x - hi).astype(np.float32))
    steps = -(-K // 8)
    pad = steps * 8 - K

    def prods(a):
        a = np.pad(a.astype(np.float64), ((0, 0), (0, pad)))
        b = np.pad(q.astype(np.float64), ((0, 0), (0, pad)))
        return np.einsum("msk,nsk->smn", a.reshape(M, steps, 8),
                         b.reshape(-1, steps, 8))

    p_hi, p_lo = prods(hi), prods(xl)
    per = 16 if form == "small_m" else 8  # k8 steps a stage or chunk
    units = -(-steps // per)
    cps = -(-units // splits)
    total = np.zeros((M, q.shape[0]), np.float32)
    for r in range(splits):
        mine = list(range(r * cps, min(units, (r + 1) * cps)))
        groups = ([mine[g::4] for g in range(4)] if form == "small_m"
                  else [mine])
        part = np.zeros_like(total)
        for units_g in groups:
            acc = np.zeros_like(total)
            chain = np.zeros_like(total)
            for unit in units_g:
                tmp = np.zeros_like(total) if stage_sums else chain
                for j in range(unit * per, min(steps, (unit + 1) * per)):
                    if lo:
                        tmp = _trunc_f32(tmp.astype(np.float64) + p_lo[j])
                    tmp = _trunc_f32(tmp.astype(np.float64) + p_hi[j])
                if stage_sums:
                    acc = (acc + tmp).astype(np.float32)
                else:
                    chain = tmp
            part = (part + (acc if stage_sums else chain)).astype(np.float32)
        total = (total + part).astype(np.float32)
    return (total * s.astype(np.float32)).astype(np.float32)


def _operands(M, K, N, seed, positive=False, positive_q=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    if positive:
        x = np.abs(x)
    q = rng.integers(-127, 128, (N, K)).astype(np.int8)
    if positive_q:
        q = np.abs(q).astype(np.int8)
    s = ((rng.random(N) + 0.5) / 127).astype(np.float32)
    return x, q, s


def _excess(y, x, q, s) -> float:
    """The largest amount by which y passes int8_gemm_tolerance (<= 0
    within it), relative to the tolerance."""
    ref, tol = int8_gemm.int8_gemm_tolerance(
        torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s))
    return float(((torch.from_numpy(y).double() - ref.double()).abs()
                  / tol.double()).max()) - 1.0


@pytest.mark.parametrize("positive", [False, True])
@pytest.mark.parametrize("form,splits", [("small_m", 1), ("small_m", 3),
                                         ("wgmma", 1), ("wgmma", 4)])
@pytest.mark.parametrize("K", [64, 128, 2048, 8192])
def test_2xtf32_holds_the_tolerance(K, form, splits, positive):
    """The float32 forms' arithmetic, emulated, within int8_gemm_tolerance
    (2^-24 of the output plus 2^-16 of the sum of the terms' magnitudes)
    at the tiny preset's and the 1b's K, on random and all-positive x."""
    x, q, s = _operands(4, K, 48, seed=K + splits, positive=positive)
    assert _excess(emulate(x, q, s, form, splits), x, q, s) <= 0


def test_one_tf32_product_fails_the_tolerance():
    """The control: hi alone (one TF32 product, 2^-10 of x dropped) is
    far outside the tolerance at K = 2,048, on random x and all-positive
    x."""
    for positive in (False, True):
        x, q, s = _operands(4, 2048, 48, seed=5, positive=positive)
        assert _excess(emulate(x, q, s, "small_m", lo=False), x, q, s) > 0
        assert _excess(emulate(x, q, s, "wgmma", lo=False), x, q, s) > 0


def test_stage_sums_keep_one_signed_products_within_the_tolerance():
    """Where every product has one sign (x and q positive), a chain of
    2,048 adds rounded toward zero (K = 8,192 unsplit) passes the
    tolerance; the stage and chunk sums keep it within."""
    x, q, s = _operands(4, 8192, 48, seed=6, positive=True, positive_q=True)
    assert _excess(emulate(x, q, s, "wgmma", stage_sums=False), x, q, s) > 0
    assert _excess(emulate(x, q, s, "wgmma"), x, q, s) <= 0
    assert _excess(emulate(x, q, s, "small_m"), x, q, s) <= 0


# ------------------------------------------------------------------ plans

# Llama-3.2-1B's and the 8B model's projections (K, N)
SHAPES_1B = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
             (2048, 128256)]
SHAPES_8B = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
             (4096, 128256)]


@pytest.mark.parametrize("K,N", SHAPES_1B + SHAPES_8B)
def test_f32_plans_take_the_float32_forms(K, N):
    """Every row count from 1 to 4,096 has a plan on the float32 forms:
    small_m (n8 tiles of tokens, at most SMALL_M_ROWS_F32 rows) at and
    below the float32 crossover, wgmma (16 to 128 tokens a tile) above
    it; never another route."""
    for M in range(1, 4097):
        plan = int8_gemm.int8_gemm_plan(M, N, K, H100_SMS, torch.float32)
        small = int8_gemm.small_m_takes(M, N, torch.float32)
        assert small == any(M <= r and N <= n
                            for r, n in int8_gemm.SMALL_M_TAKES_F32)
        if small:
            assert plan.route == "small_m"
            assert M <= 8 * plan.tile <= int8_gemm.SMALL_M_ROWS_F32
            assert plan.grid == -(-N // 64) * plan.splits
        else:
            assert plan.route == "wgmma"
            assert plan.tile in int8_gemm.WG_TOKENS_F32
            assert plan.grid % plan.splits == 0
            tiles = -(-M // plan.tile) * -(-N // 128)
            assert plan.grid // plan.splits <= tiles


def test_f32_launch_keys_and_work():
    """A float32 call counts under its route's ``_f32`` key, and its
    bound is two TF32 products an operation (or the bytes), with the
    FFMA bound beside it."""
    assert int8_gemm.launch_key("small_m", torch.float32) == "small_m_f32"
    assert int8_gemm.launch_key("wgmma", torch.float32) == "wgmma_f32"
    assert set(int8_gemm.INT8_GEMM_LAUNCHES) == {
        "small_m", "wgmma", "small_m_f16", "wgmma_f16", "small_m_f32",
        "wgmma_f32"}
    w = int8_gemm.int8_gemm_work(512, 2048, 128256, torch.float32)
    assert w["bound_by"] == "operations"
    assert w["bound_ms"] == pytest.approx(
        2 * 2 * 512 * 2048 * 128256 / 494.7e12 * 1e3)
    assert w["bound_ffma_ms"] == pytest.approx(
        2 * 512 * 2048 * 128256 / 67e12 * 1e3)
    w4 = int8_gemm.int8_gemm_work(4, 2048, 2048, torch.float32)
    assert w4["bound_by"] == "bytes"
    assert w4["bytes"] == 2048 * 2048 + 4 * 2048 + 4 * 4 * 2048 * 2


# ----------------------------------------------------------------- engine

ECFG = dict(page_size=8, num_pages=64, max_batch=4, prefill_chunk=16,
            prefill_buckets=(16,), batch_buckets=(1, 2, 4), page_buckets=(8,),
            decode_steps=4)
# the 1b's head geometry (head_dim 64, four query heads a kv head) at two
# narrow layers
GEOMETRY = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                num_layers=2, num_heads=4, num_kv_heads=1, head_dim=64,
                dtype="float32")


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


def test_f32_int8_engine_greedy_tokens_match_jax_engine():
    """Seed-0 JAX params at the 1b's head geometry (carried over by
    params_from_numpy), each engine quantizing the same float32 weights
    with quant="int8": greedy on a 40-token prompt prefilled in three
    chunks, the port's tokens equal JaxEngine's."""
    jcfg = JaxModelConfig.tiny(**GEOMETRY)
    tcfg = ModelConfig.tiny(**GEOMETRY)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    jeng = JaxEngine(jcfg, JaxEngineConfig(**ECFG), params=jparams,
                     quant="int8")
    teng = TorchEngine(tcfg, EngineConfig(**ECFG), params=params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, tcfg, device="cpu"),
        device="cpu", quant="int8")
    assert teng.params["embed"].dtype == torch.float32
    assert isinstance(teng.params["wq"], QuantInt8)
    prompt = range(30, 70)
    jax_toks = _generate(jeng, JaxRequest, JaxStop, JaxContext, prompt, 8)
    got = _generate(teng, PreprocessedRequest, StopConditions, Context,
                    prompt, 8)
    assert len(jax_toks) == 8
    assert got == jax_toks
