"""The port's Mixtral-style MoE against the JAX package's, on the CPU:
the router's top-k (ties), the cost model that picks a strategy, the
sorted blocked dispatch and the dense sum over experts
(``dynamo_tpu_torch/models/llama.py`` ``_moe_use_blocked``,
``moe_experts_blocked``, ``_moe_mlp``), the paged paths and the engine
on MoE configs, int8 experts, the loader's expert stacking for Mixtral
and Qwen3-MoE checkpoints, and the MoE shards of tensor parallelism.
Every case runs on a tiny Mixtral (8 experts, top 2) and a tiny
Qwen3-MoE (16 experts, top 4, q/k norms, expert width 32). Inputs come
from a numpy seed or from the JAX package's init, bridged through numpy;
the checkpoints are written here with numpy and safetensors. ``_MOE_BLOCK``
is patched in both packages (pytest's monkeypatch) to put a tiny prefill
on the blocked dispatch.

Tolerances:

- float32: atol 1e-5 on MoE outputs and logits (the same float32 math;
  the two frameworks sum in other orders);
- int8 experts in float32: atol 1e-5 as well. The reference dequantizes
  each expert (``q * s`` in float32) and then multiplies; the port
  multiplies by the int8 values and applies the scale after the sum (the
  int8 GEMM's order, ``models/quant.py``), which moves each product by
  about one float32 rounding;
- bfloat16 (weights in bfloat16, or int8 experts with bfloat16
  activations, the card's form): relative L2 2e-2 against the reference.
  The reference upcasts every expert to float32; the port keeps each
  expert product in bfloat16 (float32 accumulation) and rounds the gate,
  the up projection, their product and the down projection to bfloat16,
  2^-9 relative each at most, and the int8 GEMM rounds ``x @ q`` to
  bfloat16 before its scale (one more such rounding);
- bfloat16 model logits (the paged paths in bfloat16): relative L2 0.1.
  The router's bfloat16 logits tie or nearly tie at the k-th place often
  (8 bits of mantissa; 16 experts in the Qwen3-MoE case), so a last-bit
  difference upstream (the two frameworks' attention sums in other
  orders) sends a few tokens to another expert, which moves those rows
  by an expert's share; with the same routing the rows agree within the
  2e-2 above;
- greedy tokens and top-k expert ids: identical; loaded params: bitwise.
"""

import asyncio
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from dynamo_tpu.engine.jax_engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.jax_engine import JaxEngine
from dynamo_tpu.llm.protocols.common import (PreprocessedRequest as
                                             JaxRequest)
from dynamo_tpu.llm.protocols.common import StopConditions as JaxStop
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.loader import load_params as jax_load_params
from dynamo_tpu.models.quant import QuantInt8 as JaxQuantInt8
from dynamo_tpu.models.quant import quantize_int8 as jax_quantize_int8
from dynamo_tpu.models.quant import quantize_params as jax_quantize_params
from dynamo_tpu.parallel import mesh as jmesh
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                   StopConditions)
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.loader import load_params
from dynamo_tpu_torch.models.quant import (QuantInt8, quantize_int8,
                                           synthetic_int8_params)
from dynamo_tpu_torch.parallel.mesh import MeshSpec, shard_param
from dynamo_tpu_torch.runtime.engine import Context
from torch_sync_guard import NoHostReads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGE = 8
ATOL = 1e-5
REL_L2_BF16 = 2e-2
REL_L2_BF16_LOGITS = 0.1
FAMILIES = {
    "mixtral": dict(model_type="mixtral", num_experts=8,
                    num_experts_per_tok=2),
    "qwen3_moe": dict(model_type="qwen3", qk_norm=True, num_experts=16,
                      num_experts_per_tok=4, intermediate_size=32),
}
# a block height that puts the tiny prefills ([4, 16]: 64 tokens) on the
# blocked dispatch in both families, and the default, which keeps them
# on the dense sum
BLOCKS = {"blocked": 4, "dense": 256}
ECFG = dict(page_size=8, num_pages=64, max_batch=4, prefill_chunk=16,
            prefill_buckets=(16,), batch_buckets=(1, 2, 4), page_buckets=(8,),
            decode_steps=4)
PROMPTS = [list(range(1, 6)), list(range(30, 70)),  # > prefill_chunk
           list(range(100, 117)), [7, 7, 7]]
MAX_TOKENS = [9, 12, 10, 5]


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _patch_block(monkeypatch, block: int) -> None:
    monkeypatch.setattr(jl, "_MOE_BLOCK", block)
    monkeypatch.setattr(tl, "_MOE_BLOCK", block)


def _setup(family, dtype="float32", int8=False, seed=0):
    """(JAX config, port config, JAX params, port params): the JAX init
    (int8: quantized by the JAX package), bridged."""
    kw = dict(FAMILIES[family], dtype=dtype)
    jcfg, tcfg = JaxModelConfig.tiny(**kw), ModelConfig.tiny(**kw)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(seed))
    if int8:
        jp = jax_quantize_params(jp)
    tp = params_from_numpy(jp, tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _experts(rng, E, D, I):
    """A layer's expert stacks (w_gate, w_up [E, D, I], w_down
    [E, I, D]) float32, normal / sqrt(fan_in)."""
    return [(rng.standard_normal((E, a, b)) / np.sqrt(a)).astype(np.float32)
            for a, b in ((D, I), (D, I), (I, D))]


def _port_int8(w: JaxQuantInt8) -> QuantInt8:
    return QuantInt8(_t(np.ascontiguousarray(np.swapaxes(
        np.asarray(w.q), -1, -2))), _t(np.asarray(w.s)))


# --------------------------------------------------------------- configs


def _fields(cfg) -> dict:
    import dataclasses

    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


MIXTRAL_HF = {"model_type": "mixtral", "vocab_size": 32000,
              "hidden_size": 4096, "intermediate_size": 14336,
              "num_hidden_layers": 32, "num_attention_heads": 32,
              "num_key_value_heads": 8, "rope_theta": 1e6,
              "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
              "num_local_experts": 8, "num_experts_per_tok": 2,
              "sliding_window": None}
QWEN3_MOE_HF = {"model_type": "qwen3_moe", "vocab_size": 151936,
                "hidden_size": 2048, "intermediate_size": 6144,
                "moe_intermediate_size": 768, "num_hidden_layers": 48,
                "num_attention_heads": 32, "num_key_value_heads": 4,
                "head_dim": 128, "rope_theta": 1e6, "rms_norm_eps": 1e-6,
                "tie_word_embeddings": False, "num_experts": 128,
                "num_experts_per_tok": 8, "norm_topk_prob": True,
                "decoder_sparse_step": 1, "mlp_only_layers": []}


def test_configs_parse_as_the_reference():
    """from_hf_config gives the reference's fields, one by one, for
    Mixtral-8x7B's and Qwen3-30B-A3B's config.json, and raises where the
    reference raises (Qwen3-MoE without norm_topk_prob, or with dense
    layers between the MoE ones); the mixtral_8x7b and llama3_70b presets
    are the reference's."""
    for hf in (MIXTRAL_HF, QWEN3_MOE_HF):
        assert _fields(ModelConfig.from_hf_config(hf)) == _fields(
            JaxModelConfig.from_hf_config(hf))
    for bad in ({"norm_topk_prob": False}, {"decoder_sparse_step": 2},
                {"mlp_only_layers": [0]}):
        for cls in (JaxModelConfig, ModelConfig):
            with pytest.raises(NotImplementedError):
                cls.from_hf_config({**QWEN3_MOE_HF, **bad})
    for preset in ("mixtral_8x7b", "llama3_70b"):
        assert _fields(getattr(ModelConfig, preset)()) == _fields(
            getattr(JaxModelConfig, preset)())


# ------------------------------------------------------------ cost model


@pytest.mark.parametrize("mesh_size", [None, 1, 2])
@pytest.mark.parametrize("family", FAMILIES)
def test_cost_model_decides_as_the_reference(family, mesh_size):
    """_moe_use_blocked gives the reference's answer over a grid of token
    counts, expert counts, top-k and block heights, without a mesh and
    with one of one and of two ranks; both answers occur."""
    fam = FAMILIES[family]
    jm = tm = None
    if mesh_size is not None:
        jm = jmesh.MeshSpec(model=mesh_size).build()
        tm = MeshSpec(model=mesh_size).view(0)
    seen = set()
    for N in (1, 4, 16, 64, 128, 256, 512, 1024, 2048, 4096, 8192):
        for E in (1, 2, fam["num_experts"], 64, 128):
            for k in (1, fam["num_experts_per_tok"], 8):
                for block in (4, 16, 64, 256, 512):
                    want = jl._moe_use_blocked(jm, N, E, k, block)
                    got = tl._moe_use_blocked(tm, N, E, k, block)
                    assert got == want, (N, E, k, block, mesh_size)
                    seen.add(got)
    assert seen == ({False} if mesh_size == 2 else {False, True})


# ------------------------------------------------------- blocked dispatch


@pytest.mark.parametrize("case", ["float32", "int8", "int8_bf16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_blocked_dispatch_matches_reference(family, case):
    """moe_experts_blocked against the reference's on the same routing:
    a block height (8) that leaves slack blocks past the last padded
    group, and one expert that gets no token; float32 experts, int8
    experts (the JAX package's quantization, bridged) in float32, and
    int8 experts with bfloat16 tokens."""
    fam = FAMILIES[family]
    E, k, D = fam["num_experts"], fam["num_experts_per_tok"], 64
    I = fam.get("intermediate_size", 128)
    N, block = 24, 8
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, D)).astype(np.float32)
    logits = rng.standard_normal((N, E)).astype(np.float32)
    logits[:, E - 1] = -np.inf  # the last expert gets no token
    idx = np.argsort(-logits, axis=1, kind="stable")[:, :k].astype(np.int32)
    w = np.take_along_axis(logits, idx, 1)
    weights = (np.exp(w - w.max(1, keepdims=True))
               / np.exp(w - w.max(1, keepdims=True)).sum(1, keepdims=True)
               ).astype(np.float32)
    counts = np.bincount(idx.ravel(), minlength=E)
    padded = (-(-counts // block) * block).sum()
    nb = -(-N * k // block) + E
    assert counts[E - 1] == 0 and padded < nb * block  # slack blocks
    stacks = _experts(rng, E, D, I)
    if case == "float32":
        jw = [jnp.asarray(s) for s in stacks]
        tw = [_t(s) for s in stacks]
    else:
        jw = [jax_quantize_int8(jnp.asarray(s)) for s in stacks]
        tw = [_port_int8(q) for q in jw]
        # the port quantizes a stack one expert at a time, bitwise the
        # JAX package's whole-stack quantization
        for s, q in zip(stacks, tw):
            mine = quantize_int8(_t(s))
            assert torch.equal(mine.q, q.q) and torch.equal(mine.s, q.s)
    want = np.asarray(jl.moe_experts_blocked(
        jnp.asarray(x), jnp.asarray(weights), jnp.asarray(idx), *jw,
        block=block))
    tx = _t(x).to(torch.bfloat16) if case == "int8_bf16" else _t(x)
    with NoHostReads():
        got = tl.moe_experts_blocked(tx, _t(weights), _t(idx), *tw,
                                     block=block)
    assert got.dtype == torch.float32 and got.shape == (N, D)
    if case == "int8_bf16":
        assert _rel_l2(got.numpy(), want) < REL_L2_BF16
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


# ------------------------------------------------------------------- ties


@pytest.mark.parametrize("family", FAMILIES)
def test_router_ties_pick_the_reference_experts(family):
    """Router columns equal in threes make every token's logits tie in
    threes, so ties fall at the k-th place: the port's top-k takes the
    lower expert of a tie, as lax.top_k does, and _moe_mlp picks the
    reference's experts (its output equals the reference's)."""
    fam = FAMILIES[family]
    E, k, D, I = fam["num_experts"], fam["num_experts_per_tok"], 32, 24
    rng = np.random.default_rng(2)
    cols = rng.standard_normal((D, -(-E // 3))).astype(np.float32)
    router = np.repeat(cols, 3, axis=1)[:, :E].copy()
    h = rng.standard_normal((2, 16, D)).astype(np.float32)
    logits = (h.reshape(-1, D) @ router).astype(np.float32)
    jv, ji = lax.top_k(jnp.asarray(logits), k)
    tv, ti = tl._top_k(_t(logits), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    srt = -np.sort(-logits, axis=1)
    assert (srt[:, k - 1] == srt[:, k]).any()  # a tie at the k-th place
    stacks = _experts(rng, E, D, I)
    want = np.asarray(jl._moe_mlp(jnp.asarray(h), jnp.asarray(router),
                                  *map(jnp.asarray, stacks), k))
    got = tl._moe_mlp(_t(h), _t(router), *map(_t, stacks), k)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


# ------------------------------------------------------- both strategies


@pytest.mark.parametrize("strategy", ["dense", "blocked"])
@pytest.mark.parametrize("family", FAMILIES)
def test_moe_mlp_matches_reference(family, strategy, monkeypatch):
    """_moe_mlp on [2, 20] tokens under each strategy (the block height
    patched in both packages): the cost model takes the named strategy,
    the output is the reference's, and no tensor value is read on the
    host (so it captures in a CUDA graph)."""
    _patch_block(monkeypatch, BLOCKS[strategy])
    fam = FAMILIES[family]
    E, k, D = fam["num_experts"], fam["num_experts_per_tok"], 64
    I = fam.get("intermediate_size", 128)
    assert tl._moe_use_blocked(None, 40, E, k, tl._MOE_BLOCK) == (
        strategy == "blocked")
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 20, D)).astype(np.float32)
    router = (rng.standard_normal((D, E)) / 8).astype(np.float32)
    stacks = _experts(rng, E, D, I)
    want = np.asarray(jl._moe_mlp(jnp.asarray(h), jnp.asarray(router),
                                  *map(jnp.asarray, stacks), k))
    with NoHostReads():
        got = tl._moe_mlp(_t(h), _t(router), *map(_t, stacks), k)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


# ---------------------------------------------------------- paged paths


def _prefill_inputs(B, T, P, starts, lens, pages, seed=5):
    tokens = np.zeros((B, T), np.int32)
    positions = np.full((B, T), -1, np.int32)
    slots = np.full((B, T), jl.DROP_SLOT, np.int32)
    table = np.zeros((B, P), np.int32)
    last = np.zeros(B, np.int32)
    rng = np.random.RandomState(seed)
    for b, (s, n, pg) in enumerate(zip(starts, lens, pages)):
        tokens[b, :n] = rng.randint(1, 500, n)
        positions[b, :n] = np.arange(s, s + n)
        table[b, :len(pg)] = pg
        pos = np.arange(s, s + n)
        slots[b, :n] = np.asarray(pg)[pos // PAGE] * PAGE + pos % PAGE
        last[b] = max(n - 1, 0)
    return tokens, positions, table, slots, last


def _close(got, want, weights: str, live) -> None:
    got = np.asarray(got, np.float32)[live]
    want = np.asarray(want, np.float32)[live]
    if weights == "bfloat16":
        assert _rel_l2(got, want) < REL_L2_BF16_LOGITS
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _window(mod, cfg, params, kv, table, tok, pos, rem, K):
    B = len(tok)
    fn = mod.make_decode_window_fn(cfg, True, 64)
    zeros = np.zeros(B, np.int32)
    eos = np.full((B, 2), -1, np.int32)
    if mod is jl:
        out = fn(params, jnp.asarray(tok), jnp.asarray(pos),
                 jnp.zeros(B, bool), jnp.asarray(zeros), jnp.asarray(rem),
                 jnp.array(kv[0]), jnp.array(kv[1]), jnp.asarray(table),
                 jnp.zeros(B), jnp.asarray(zeros), jnp.ones(B),
                 jnp.zeros(B, jnp.uint32), jnp.asarray(eos), k_steps=K)
    else:
        with NoHostReads():
            out = fn(params, _t(tok), _t(pos), torch.zeros(B, dtype=bool),
                     _t(zeros), _t(rem), kv[0].clone(), kv[1].clone(),
                     _t(table), np.zeros(B, np.float32), zeros,
                     np.ones(B, np.float32), np.zeros(B, np.uint32),
                     _t(eos), k_steps=K)
    toks, emitted = out[0], out[1]
    return np.asarray(toks), np.asarray(emitted)


@pytest.mark.parametrize("weights", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("strategy", ["dense", "blocked"])
@pytest.mark.parametrize("family", FAMILIES)
def test_paged_paths_match_reference(family, strategy, weights,
                                     monkeypatch):
    """2 layers at narrow widths: a [4, 16] prefill (three rows and a
    padding row; on the blocked dispatch under ``blocked``), a second
    chunk continuing a row from the pool, decode steps (T = 1, the dense
    sum), then a fused 5-step greedy window: logits within the stated
    tolerance, the window's tokens identical (float32 and int8 experts;
    in bfloat16 the logits only, where a near-tie may flip a greedy
    token). The port runs every call under NoHostReads."""
    _patch_block(monkeypatch, BLOCKS[strategy])
    dtype = "bfloat16" if weights == "bfloat16" else "float32"
    jcfg, tcfg, jp, tp = _setup(family, dtype, int8=weights == "int8")
    if weights == "int8":
        assert isinstance(tp["w_gate"], QuantInt8)
        assert tuple(tp["w_gate"].shape) == tuple(jp["w_gate"].q.shape)
    E, k = tcfg.num_experts, tcfg.num_experts_per_tok
    assert tl._moe_use_blocked(None, 64, E, k, tl._MOE_BLOCK) == (
        strategy == "blocked")
    jk, jv = jl.init_kv_cache(jcfg, jl.KVCacheSpec(32, PAGE))
    tk, tv = tl.init_kv_cache(tcfg, tl.KVCacheSpec(32, PAGE), device="cpu")
    j_pre, j_dec = jl.make_step_fns(jcfg)
    t_pre, t_dec = tl.make_step_fns(tcfg)
    B, T, P = 4, 16, 4
    pages = [[1, 2, 3], [4, 5, 6, 10], [7, 8, 9], []]
    live = [0, 1, 2]
    x = _prefill_inputs(B, T, P, [0] * 4, [12, 16, 7, 0], pages)
    jo, jk, jv = j_pre(jp, *map(jnp.asarray, x[:2]), jk, jv,
                       *map(jnp.asarray, x[2:]))
    with NoHostReads():
        to, tk, tv = t_pre(tp, *map(_t, x[:2]), tk, tv, *map(_t, x[2:]))
    _close(to, jo, weights, live)
    # row 1 continues at position 16 (its prefix in the pool)
    x2 = _prefill_inputs(1, 8, P, [16], [8], [pages[1]], seed=6)
    jo2, jk, jv = j_pre(jp, *map(jnp.asarray, x2[:2]), jk, jv,
                        *map(jnp.asarray, x2[2:]))
    with NoHostReads():
        to2, tk, tv = t_pre(tp, *map(_t, x2[:2]), tk, tv, *map(_t, x2[2:]))
    _close(to2, jo2, weights, [0])
    pos = np.array([12, 24, 7, -1], np.int32)
    tok = np.array([3, 4, 5, 0], np.int32)
    for _ in range(2):
        slots = np.array([np.asarray(pg)[p // PAGE] * PAGE + p % PAGE
                          if p >= 0 else jl.DROP_SLOT
                          for pg, p in zip(pages, pos)], np.int32)
        jd, jk, jv = j_dec(jp, jnp.asarray(tok), jnp.asarray(pos), jk, jv,
                           jnp.asarray(x[2]), jnp.asarray(slots))
        with NoHostReads():
            td, tk, tv = t_dec(tp, _t(tok), _t(pos), tk, tv, _t(x[2]),
                               _t(slots))
        _close(td, jd, weights, live)
        tok = np.asarray(jnp.argmax(jd, -1)).astype(np.int32)
        pos = np.where(pos >= 0, pos + 1, -1).astype(np.int32)
    if weights == "bfloat16":
        return
    rem = np.array([50, 3, 50, 1], np.int32)
    want = _window(jl, jcfg, jp, (jk, jv), x[2], tok, pos, rem, 5)
    got = _window(tl, tcfg, tp, (tk, tv), x[2], tok, pos, rem, 5)
    np.testing.assert_array_equal(got[0][live], want[0][live])
    np.testing.assert_array_equal(got[1], want[1])


# -------------------------------------------------------------- engines


async def _generate_all(engine, request_cls, stop_cls, ctx_cls):
    async def one(p, n, delay):
        await asyncio.sleep(delay)
        req = request_cls(token_ids=list(p), stop=stop_cls(max_tokens=n))
        toks = []
        async for out in engine.generate(req, ctx_cls()):
            toks += out.token_ids
        return toks

    try:
        return await asyncio.gather(*[
            one(p, n, 0.01 * i) for i, (p, n) in
            enumerate(zip(PROMPTS, MAX_TOKENS))])
    finally:
        await engine.stop()


@pytest.mark.parametrize("case", ["dense", "blocked", "int8"])
@pytest.mark.parametrize("family", FAMILIES)
def test_engine_greedy_tokens_match_jax_engine(family, case, monkeypatch):
    """TorchEngine and JaxEngine on the same bridged weights give
    identical greedy tokens for concurrent requests (one prefilled in
    three chunks): with the default block height (every dispatch on the
    dense sum), with the [4, 16] prefill bucket on the blocked dispatch,
    and with int8 weights (each engine quantizes the same float32
    weights itself)."""
    _patch_block(monkeypatch, BLOCKS["blocked" if case == "blocked"
                                     else "dense"])
    jcfg, tcfg, jp, tp = _setup(family, seed=3)
    quant = "int8" if case == "int8" else None
    jeng = JaxEngine(jcfg, JaxEngineConfig(**ECFG), params=jp, quant=quant)
    teng = TorchEngine(tcfg, EngineConfig(**ECFG), params=tp, device="cpu",
                       quant=quant)
    if quant:
        assert isinstance(teng.params["w_down"], QuantInt8)
        q, s = teng.params["w_down"].q, teng.params["w_down"].s
        np.testing.assert_array_equal(q.transpose(-1, -2).numpy(),
                                      np.asarray(jeng.params["w_down"].q))
        np.testing.assert_array_equal(s.numpy(),
                                      np.asarray(jeng.params["w_down"].s))
    want = asyncio.run(_generate_all(jeng, JaxRequest, JaxStop, JaxContext))
    got = asyncio.run(_generate_all(teng, PreprocessedRequest,
                                    StopConditions, Context))
    assert got == want
    assert [len(t) for t in got] == MAX_TOKENS


def test_random_and_synthetic_params_have_the_moe_shapes():
    """The port's own init (the engine's random weights) and the
    benchmark-only int8 init draw the JAX package's MoE tree: the router
    and the expert stacks at the reference's shapes; a MoE engine on the
    synthetic int8 weights serves finite tokens."""
    for family in FAMILIES:
        kw = FAMILIES[family]
        jcfg, tcfg = JaxModelConfig.tiny(**kw), ModelConfig.tiny(**kw)
        want = jl.init_params(jcfg, jax.random.PRNGKey(0))
        got = tl.init_params(tcfg, torch.Generator().manual_seed(0))
        assert set(got) == set(want)
        for name, w in want.items():
            assert tuple(got[name].shape) == w.shape, name
        syn = synthetic_int8_params(tcfg, device="cpu")
        assert tuple(syn["w_gate"].shape) == want["w_gate"].shape
        assert syn["w_gate"].q.dtype == torch.int8
        assert tuple(syn["w_router"].shape) == want["w_router"].shape
    engine = TorchEngine(tcfg, EngineConfig(**ECFG), params=syn,
                         device="cpu")

    async def go():
        req = PreprocessedRequest(token_ids=[1, 2, 3],
                                  stop=StopConditions(max_tokens=3))
        out = []
        async for d in engine.generate(req, Context()):
            out += d.token_ids
        await engine.stop()
        return out

    toks = asyncio.run(go())
    assert len(toks) == 3 and all(0 <= t < tcfg.vocab_size for t in toks)


# ---------------------------------------------- checkpoints and shards


def _hf_tensors(family: str, seed: int) -> tuple:
    """(config.json dict, {name: float32 array}) of a tiny checkpoint in
    HF's names: Mixtral's block_sparse_moe (w1/w3/w2, gate), Qwen3-MoE's
    mlp experts (gate/up/down_proj, gate) and q/k norms."""
    rng = np.random.default_rng(seed)
    D, L, H, KV, hd, V = 64, 2, 4, 2, 16, 320
    fam = FAMILIES[family]
    E, k = fam["num_experts"], fam["num_experts_per_tok"]
    I = fam.get("intermediate_size", 128)
    cfg = {"vocab_size": V, "hidden_size": D, "num_hidden_layers": L,
           "num_attention_heads": H, "num_key_value_heads": KV,
           "head_dim": hd, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
           "tie_word_embeddings": False, "max_position_embeddings": 256,
           "torch_dtype": "float32"}
    if family == "mixtral":
        cfg.update(model_type="mixtral", intermediate_size=I,
                   num_local_experts=E, num_experts_per_tok=k)
        moe, projs = "block_sparse_moe", ("w1", "w3", "w2")
    else:
        cfg.update(model_type="qwen3_moe", intermediate_size=256,
                   moe_intermediate_size=I, num_experts=E,
                   num_experts_per_tok=k, norm_topk_prob=True)
        moe, projs = "mlp", ("gate_proj", "up_proj", "down_proj")

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(
            np.float32)

    t = {"model.embed_tokens.weight": w(V, D), "lm_head.weight": w(V, D),
         "model.norm.weight": 1 + w(D)}
    for i in range(L):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = 1 + w(D)
        t[p + "post_attention_layernorm.weight"] = 1 + w(D)
        for name, out in (("q_proj", H * hd), ("k_proj", KV * hd),
                          ("v_proj", KV * hd)):
            t[p + f"self_attn.{name}.weight"] = w(out, D)
        t[p + "self_attn.o_proj.weight"] = w(D, H * hd)
        if family == "qwen3_moe":
            t[p + "self_attn.q_norm.weight"] = 1 + w(hd)
            t[p + "self_attn.k_norm.weight"] = 1 + w(hd)
        t[p + f"{moe}.gate.weight"] = w(E, D)
        for e in range(E):
            q = p + f"{moe}.experts.{e}."
            t[q + f"{projs[0]}.weight"] = w(I, D)
            t[q + f"{projs[1]}.weight"] = w(I, D)
            t[q + f"{projs[2]}.weight"] = w(D, I)
    return cfg, t


@pytest.fixture(scope="module")
def moe_ckpts(tmp_path_factory):
    """family → the directory of a tiny float32 checkpoint (written with
    numpy and safetensors; Mixtral in two shards with an index)."""
    from safetensors.numpy import save_file

    out = {}
    for seed, family in enumerate(FAMILIES):
        cfg, tensors = _hf_tensors(family, seed + 11)
        path = tmp_path_factory.mktemp(f"ckpt_{family}")
        (path / "config.json").write_text(json.dumps(cfg))
        if family == "mixtral":
            names = sorted(tensors)
            half = {n for n in names if ".layers.1." in n}
            files = {"model-00001-of-00002.safetensors":
                     [n for n in names if n not in half],
                     "model-00002-of-00002.safetensors": sorted(half)}
            for fname, keys in files.items():
                save_file({n: tensors[n] for n in keys}, str(path / fname))
            (path / "model.safetensors.index.json").write_text(json.dumps(
                {"weight_map": {n: f for f, ks in files.items()
                                for n in ks}}))
        else:
            save_file(tensors, str(path / "model.safetensors"))
        out[family] = str(path)
    return out


def _same_param(got, want, name) -> None:
    if isinstance(want, JaxQuantInt8):
        assert isinstance(got, QuantInt8), name
        np.testing.assert_array_equal(got.q.transpose(-1, -2).numpy(),
                                      np.asarray(want.q), err_msg=name)
        np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s),
                                      err_msg=name)
        assert got.q.is_contiguous() and got.s.is_contiguous(), name
        return
    assert got.is_contiguous(), name
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, name
    if got.dtype == torch.bfloat16:
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32), err_msg=name)
    else:
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


@pytest.mark.parametrize("load", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("family", FAMILIES)
def test_loader_is_bitwise_jax_loader(moe_ckpts, family, load):
    """The port's load_params and the JAX loader read the same checkpoint
    to the same keys, each bitwise equal: the router [L, D, E], the
    expert stacks [L, E, D, I] / [L, E, I, D], in float32, in bfloat16
    and with int8 projections (the expert stacks int8 too, quantized an
    expert at a time on the device, the router not quantized); the
    config parses as the reference's."""
    path = moe_ckpts[family]
    jcfg = JaxModelConfig.from_local_path(path)
    cfg = ModelConfig.from_local_path(path)
    for f in ("model_type", "num_experts", "num_experts_per_tok",
              "intermediate_size", "qk_norm", "num_layers", "head_dim"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    dtype = "bfloat16" if load == "bfloat16" else "float32"
    quant = "int8" if load == "int8" else None
    want = jax_load_params(path, jcfg, dtype=getattr(jnp, dtype),
                           quant=quant)
    got = load_params(path, cfg, "cpu", dtype=getattr(torch, dtype),
                      quant=quant)
    assert set(got) == set(want)
    assert "w_router" in got and tuple(got["w_gate"].shape) == (
        cfg.num_layers, cfg.num_experts, cfg.hidden_size,
        cfg.intermediate_size)
    for name, w in want.items():
        _same_param(got[name], w, name)
    assert not isinstance(got["w_router"], QuantInt8)


@pytest.mark.parametrize("load", ["bfloat16", "int8"])
@pytest.mark.parametrize("family", FAMILIES)
def test_tp2_loads_are_the_cut_of_the_jax_load(moe_ckpts, family, load):
    """Each tensor-parallel rank's load (rank of 2) is the rank's cut
    (shard_param) of the JAX loader's whole params, bitwise: each
    expert's gate and up over its inner width, its down over the rows
    (int8: with the scales of the whole rows), the router whole; and the
    bridge's upload of the JAX params at that rank is the same cut."""
    path = moe_ckpts[family]
    cfg = ModelConfig.from_local_path(path)
    jcfg = JaxModelConfig.from_local_path(path)
    dtype = getattr(torch, "bfloat16" if load == "bfloat16" else "float32")
    quant = "int8" if load == "int8" else None
    whole_jax = jax_load_params(path, jcfg, dtype=jnp.bfloat16 if quant is
                                None else jnp.float32, quant=quant)
    whole = params_from_numpy(whole_jax, _in_dtype(cfg, load),
                              device="cpu")
    for rank in range(2):
        mesh = MeshSpec(model=2).view(rank)
        part = load_params(path, cfg, "cpu", dtype=dtype, rank=rank,
                           size=2, quant=quant)
        bridged = params_from_numpy(whole_jax, _in_dtype(
            cfg, load), device="cpu", rank=rank, size=2)
        assert set(part) == set(whole) == set(bridged)
        for name, w in whole.items():
            cut = shard_param(name, w, cfg, mesh)
            for mine in (part[name], bridged[name]):
                if isinstance(cut, QuantInt8):
                    assert torch.equal(mine.q, cut.q), name
                    assert torch.equal(mine.s, cut.s), name
                else:
                    assert torch.equal(mine, cut), name
        inner = cfg.intermediate_size // 2
        assert part["w_gate"].shape[-1] == inner
        assert part["w_down"].shape[-2] == inner
        assert tuple(part["w_router"].shape) == tuple(whole["w_router"].shape)


def _in_dtype(cfg, load: str):
    """``cfg`` in the dtype the bridge casts the non-int8 params to."""
    import dataclasses

    return dataclasses.replace(
        cfg, dtype="bfloat16" if load == "bfloat16" else "float32")


def test_launcher_serves_a_moe_checkpoint_in_batch_mode(moe_ckpts, tmp_path):
    """``python -m dynamo_tpu_torch.run in=batch:FILE out=torch --device
    cpu --model-path DIR`` on the tiny Mixtral checkpoint (two shards and
    an index), and with ``--dtype int8``: a line a request with its
    counts, the aggregate, and the serving summary on stderr."""
    path = tmp_path / "b.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in (
        {"text": "hello there world"}, {"prompt": "one two",
                                        "max_tokens": 3})))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for extra in ([], ["--dtype", "int8"]):
        proc = subprocess.run(
            [sys.executable, "-m", "dynamo_tpu_torch.run", f"in=batch:{path}",
             "out=torch", "--device", "cpu", "--model-path",
             moe_ckpts["mixtral"], "--max-tokens", "5", "--max-batch-size",
             "4", "--no-warmup", *extra], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-3000:]
        rows = [json.loads(ln) for ln in proc.stdout.splitlines()
                if ln.startswith("{")]
        assert [r["index"] for r in rows[:-1]] == [0, 1]
        assert [r["tokens_in"] for r in rows[:-1]] == [3, 2]
        assert 0 < rows[0]["tokens_out"] <= 5
        assert 0 < rows[1]["tokens_out"] <= 3
        assert rows[-1]["aggregate"]["requests"] == 2
        assert "checkpoint loaded" in proc.stderr
        summary = json.loads(proc.stderr.split("serving summary ", 1)[1]
                             .splitlines()[0])
        assert summary["batch_dispatches_total"] > 0
