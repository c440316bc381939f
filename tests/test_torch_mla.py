"""The port's MLA model (``dynamo_tpu_torch/models/mla.py``: DeepSeek's
latent attention over paged latent pools, its two routers and segmented
MoE), the model registry and the engine's generic decode window, against
the JAX package on the CPU.

Every case runs a tiny MLA (4 heads, r 16, dn 16, dr 8, dv 16, 3 layers)
on the JAX package's weights, carried across by ``params_from_numpy``:
q LoRA off and on, DeepSeek's v2 router with and without group limiting,
and the v3 router (sigmoid scores, a nonzero selection bias, groups by
their top-2 sum, renormalised, scaled), each MoE config with one dense
first layer and shared experts. ``_MOE_BLOCK`` is patched in both
packages (pytest's monkeypatch) to put a tiny prefill on the blocked
dispatch.

Tolerances:

- float32 logits and pools: atol 1e-4 (the same float32 math; the two
  frameworks sum in other orders, ~5e-6 seen);
- int8 weights in float32: atol 1e-4 as well. The reference dequantizes
  each expert stack (``q * s``) and multiplies; the port multiplies by the
  int8 values and scales after the sum (the int8 GEMM's order), about one
  float32 rounding a product;
- router weights: atol 1e-6; greedy tokens and expert ids: identical.
"""

import asyncio
import json
import logging
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.jax_engine import JaxEngine
from dynamo_tpu.engine.jax_engine import _make_decode_multi as jax_multi
from dynamo_tpu.llm.protocols.common import (PreprocessedRequest as
                                             JaxRequest)
from dynamo_tpu.llm.protocols.common import StopConditions as JaxStop
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import mla as jm
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.quant import quantize_params as jax_quantize_params
from dynamo_tpu.parallel import mesh as jmesh
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.torch_engine import (EngineConfig, TorchEngine,
                                                  _make_decode_multi)
from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                   StopConditions)
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models import mla as tm
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.quant import QuantInt8, synthetic_int8_params
from dynamo_tpu_torch.models.registry import get_model_module
from dynamo_tpu_torch.parallel.mesh import kv_cache_pspec, param_pspecs
from dynamo_tpu_torch.runtime.engine import Context
from torch_sync_guard import NoHostReads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGE = 8
ATOL = 1e-4
BASE = dict(model_type="deepseek_v2", vocab_size=512, hidden_size=64,
            intermediate_size=128, num_layers=3, num_heads=4,
            num_kv_heads=4, kv_lora_rank=16, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, q_lora_rank=0,
            rope_theta=10000.0, dtype="float32")
MOE = dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
           n_shared_experts=2, first_k_dense_replace=1)
CONFIGS = {
    "dense": {},
    "q_lora": dict(q_lora_rank=24),
    "v2": dict(MOE, moe_router="deepseek_v2", routed_scaling_factor=1.5),
    "v2_grouped": dict(MOE, moe_router="deepseek_v2", n_group=4,
                       topk_group=2, routed_scaling_factor=1.5,
                       q_lora_rank=24),
    "v3": dict(MOE, model_type="deepseek_v3", moe_router="deepseek_v3",
               n_shared_experts=1, n_group=4, topk_group=2,
               norm_topk_prob=True, routed_scaling_factor=2.0,
               q_lora_rank=24),
}
ROUTERS = ("v2", "v2_grouped", "v3")
# a block height that puts the [4, 16] prefill (64 tokens, 8 experts, top
# 2) on the blocked dispatch, and the default, which keeps it dense
BLOCKS = {"blocked": 4, "dense": 256}
ECFG = dict(page_size=8, num_pages=64, max_batch=4, prefill_chunk=16,
            prefill_buckets=(16,), batch_buckets=(1, 2, 4), page_buckets=(8,),
            decode_steps=4)
PROMPTS = [list(range(1, 6)), list(range(30, 70)),  # > prefill_chunk
           list(range(100, 117)), [7, 7, 7]]
MAX_TOKENS = [9, 12, 10, 5]


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(name: str, **over):
    kw = dict(BASE, **CONFIGS[name], **over)
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _setup(name: str, int8: bool = False, seed: int = 0):
    """(JAX config, port config, JAX params, port params): the JAX init
    (v3: a nonzero selection bias; int8: quantized by the JAX package),
    bridged through numpy."""
    jcfg, tcfg = _cfgs(name)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    if "router_bias" in jp:
        jp["router_bias"] = jax.random.uniform(
            jax.random.PRNGKey(seed + 100), jp["router_bias"].shape,
            minval=-0.5, maxval=0.5)
    if int8:
        jp = jax_quantize_params(jp)
    return jcfg, tcfg, jp, params_from_numpy(jp, tcfg, device="cpu")


def _patch_block(monkeypatch, block: int) -> None:
    monkeypatch.setattr(jl, "_MOE_BLOCK", block)
    monkeypatch.setattr(tl, "_MOE_BLOCK", block)


def _fields(cfg) -> dict:
    import dataclasses

    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


# --------------------------------------------------------------- configs


YARN = {"type": "yarn", "factor": 40, "original_max_position_embeddings":
        4096, "beta_fast": 32, "beta_slow": 1}
# deepseek-ai/DeepSeek-V2-Lite's and deepseek-ai/DeepSeek-V3's config.json
DEEPSEEK_V2_LITE = {
    "model_type": "deepseek_v2", "hidden_size": 2048,
    "intermediate_size": 10944, "num_hidden_layers": 27,
    "num_attention_heads": 16, "num_key_value_heads": 16,
    "q_lora_rank": None, "kv_lora_rank": 512, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "n_routed_experts": 64,
    "num_experts_per_tok": 6, "n_shared_experts": 2,
    "moe_intermediate_size": 1408, "first_k_dense_replace": 1,
    "routed_scaling_factor": 1.0, "topk_method": "greedy", "n_group": 1,
    "topk_group": 1, "norm_topk_prob": False, "scoring_func": "softmax",
    "vocab_size": 102400, "rms_norm_eps": 1e-6, "rope_theta": 10000,
    "tie_word_embeddings": False, "max_position_embeddings": 163840,
    "rope_scaling": dict(YARN, mscale=0.707, mscale_all_dim=0.707)}
DEEPSEEK_V3 = {
    "model_type": "deepseek_v3", "hidden_size": 7168,
    "intermediate_size": 18432, "num_hidden_layers": 61,
    "num_attention_heads": 128, "num_key_value_heads": 128,
    "q_lora_rank": 1536, "kv_lora_rank": 512, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "n_routed_experts": 256,
    "num_experts_per_tok": 8, "n_shared_experts": 1,
    "moe_intermediate_size": 2048, "first_k_dense_replace": 3,
    "routed_scaling_factor": 2.5, "topk_method": "noaux_tc", "n_group": 8,
    "topk_group": 4, "norm_topk_prob": True, "scoring_func": "sigmoid",
    "vocab_size": 129280, "rms_norm_eps": 1e-6, "rope_theta": 10000,
    "tie_word_embeddings": False, "max_position_embeddings": 163840,
    "rope_scaling": dict(YARN, mscale=1.0, mscale_all_dim=1.0)}


def test_deepseek_configs_parse_as_the_reference():
    """from_hf_config gives the reference's fields, one by one, for
    DeepSeek-V2-Lite's and DeepSeek-V3's published config.json: MLA on,
    V2-Lite's softmax router without group limiting (topk_method greedy),
    V3's sigmoid router with its groups; YaRN kept as given and ignored by
    both (ROADMAP.md note D)."""
    for hf in (DEEPSEEK_V2_LITE, DEEPSEEK_V3):
        got = ModelConfig.from_hf_config(hf)
        assert _fields(got) == _fields(JaxModelConfig.from_hf_config(hf))
        assert got.is_mla and got.rope_interleave
        assert get_model_module(got) is tm
    lite = ModelConfig.from_hf_config(DEEPSEEK_V2_LITE)
    assert (lite.moe_router, lite.n_group, lite.num_experts,
            lite.q_lora_rank) == ("deepseek_v2", 0, 64, 0)
    v3 = ModelConfig.from_hf_config(DEEPSEEK_V3)
    assert (v3.moe_router, v3.n_group, v3.topk_group, v3.norm_topk_prob) \
        == ("deepseek_v3", 8, 4, True)
    # YaRN leaves the rope frequencies as they are, in both packages
    want = np.asarray(jl.rope_freqs(JaxModelConfig.from_hf_config(
        DEEPSEEK_V2_LITE), dim=64))
    np.testing.assert_array_equal(tl.rope_freqs(lite, dim=64).numpy(), want)


def test_registry_picks_the_module_and_llama_refuses_mla():
    """get_model_module gives mla for an MLA config and llama otherwise,
    as the reference's registry does; models/llama.py's entry points
    keep refusing MLA."""
    jcfg, tcfg = _cfgs("v3")
    assert get_model_module(tcfg) is tm
    assert get_model_module(ModelConfig.tiny()) is tl
    from dynamo_tpu.models.registry import get_model_module as jax_registry

    assert jax_registry(jcfg) is jm
    with pytest.raises(NotImplementedError, match="models/mla.py"):
        tl.init_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="models/mla.py"):
        tl.check_supported(tcfg)


@pytest.mark.parametrize("name", CONFIGS)
def test_params_pools_and_specs_have_the_reference_shapes(name):
    """The port's own init draws the JAX package's tree (keys and shapes;
    v3's router_bias zeros), the pools are the reference's [L, pages, 1,
    ps, r] and [L, pages, 1, ps, dr], and the tensor-parallel specs are
    the reference's with its ``expert`` axis at 1, the pools replicated.
    The benchmark-only int8 init takes the MLA shapes too."""
    jcfg, tcfg = _cfgs(name)
    want = jm.init_params(jcfg, jax.random.PRNGKey(0))
    got = tm.init_params(tcfg, torch.Generator().manual_seed(0))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
    if "router_bias" in got:
        assert not got["router_bias"].any()
    spec = tl.KVCacheSpec(16, PAGE)
    assert tm.cache_shapes(tcfg, spec) == jm.cache_shapes(jcfg, spec)
    kc, kr = tm.init_kv_cache(tcfg, spec, device="cpu")
    assert (tuple(kc.shape), tuple(kr.shape)) == jm.cache_shapes(jcfg, spec)
    jspecs, tspecs = jmesh.param_pspecs(jcfg), param_pspecs(tcfg)
    for k in want:
        if k in jspecs:
            ref = tuple(None if a == "expert" else a for a in jspecs[k])
            assert tspecs[k] == ref, k
    assert kv_cache_pspec(tcfg) == (None,) * 5
    syn = synthetic_int8_params(tcfg, device="cpu")
    assert set(syn) == set(want)
    for k, w in want.items():
        assert tuple(syn[k].shape) == w.shape, k


# ------------------------------------------------------------- reference


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_forward_matches_jax(name):
    """The non-absorbed oracle (per-head K/V materialised) against the
    JAX package's on [2, 16] tokens."""
    jcfg, tcfg, jp, tp = _setup(name, seed=1)
    tokens = np.random.RandomState(0).randint(1, 500, (2, 16)).astype(
        np.int32)
    want = np.asarray(jm.reference_forward(jp, jcfg, jnp.asarray(tokens)))
    got = tm.reference_forward(tp, tcfg, _t(tokens))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


# ---------------------------------------------------------------- routers


def _tied_logits(rng, N: int, E: int) -> np.ndarray:
    """[N, E] router logits from three values, so that experts tie within
    a row, groups tie on their max, and v3's groups on their top-2 sums."""
    return (rng.integers(0, 3, (N, E)) / 2.0).astype(np.float32)


@pytest.mark.parametrize("name", ROUTERS)
def test_gate_ties_pick_the_reference_experts(name):
    """_deepseek_gate on logits full of exact ties (an identity x, so the
    logits are the router matrix itself): the expert ids are the JAX
    package's, ties to the lower expert in the expert top-k, the group
    top-k and v3's top-2 group sums, and the weights agree; v3 with a
    selection bias that ties too."""
    jcfg, tcfg = _cfgs(name)
    E = tcfg.num_experts
    rng = np.random.default_rng(7)
    N = 64
    x = np.eye(N, dtype=np.float32)
    w_router = _tied_logits(rng, N, E)
    bias = (rng.integers(-1, 2, E) / 4.0).astype(np.float32)
    if name != "v3":
        bias = None
    jw, ji = jm._deepseek_gate(jnp.asarray(x), jnp.asarray(w_router),
                               None if bias is None else jnp.asarray(bias),
                               jcfg)
    with NoHostReads():
        tw, ti = tm._deepseek_gate(_t(x), _t(w_router),
                                   None if bias is None else _t(bias), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6,
                               rtol=0)
    # the ties were real: some row picks among equal selection scores
    choice = w_router if bias is None else 1 / (1 + np.exp(-w_router)) + bias
    kth = np.sort(choice, 1)[:, ::-1][:, tcfg.num_experts_per_tok - 1]
    assert ((choice == kth[:, None]).sum(1) > 1).any()


@pytest.mark.parametrize("name", ROUTERS)
def test_moe_mlp_dispatches_match_reference(name, monkeypatch):
    """_deepseek_moe_mlp on [2, 20] tokens of a MoE layer's params, by the
    dense sum (default block) and by the blocked dispatch (block 4): each
    the reference's under the same patch, and the two the same function;
    no tensor value read on the host."""
    jcfg, tcfg, jp, tp = _setup(name, seed=2)
    h = np.random.default_rng(3).standard_normal((2, 20, 64)).astype(
        np.float32)
    jlp = {k: v[0] for k, v in jm._moe_layer_params(jcfg, jp).items()}
    tlp = {k: v[0] for k, v in tm._moe_layer_params(tcfg, tp).items()}
    got = {}
    for strategy, block in BLOCKS.items():
        _patch_block(monkeypatch, block)
        assert tl._moe_use_blocked(None, 40, 8, 2, tl._MOE_BLOCK) == (
            strategy == "blocked")
        want = np.asarray(jm._deepseek_moe_mlp(jnp.asarray(h), jlp, jcfg))
        with NoHostReads():
            got[strategy] = tm._deepseek_moe_mlp(_t(h), tlp, tcfg)
        np.testing.assert_allclose(got[strategy].numpy(), want, atol=1e-5,
                                   rtol=0)
    np.testing.assert_allclose(got["blocked"].numpy(),
                               got["dense"].numpy(), atol=1e-5, rtol=0)


# ------------------------------------------------------------ paged paths


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


def _window_args(B, tok, pos, rem, table):
    zeros = np.zeros(B, np.int32)
    eos = np.full((B, 2), -1, np.int32)
    jax_args = (jnp.asarray(tok), jnp.asarray(pos), jnp.zeros(B, bool),
                jnp.asarray(zeros), jnp.asarray(rem))
    jax_tail = (jnp.asarray(table), jnp.zeros(B), jnp.asarray(zeros),
                jnp.ones(B), jnp.zeros(B, jnp.uint32), jnp.asarray(eos))
    port_args = (_t(tok), _t(pos), torch.zeros(B, dtype=torch.bool),
                 _t(zeros), _t(rem))
    port_tail = (_t(table), np.zeros(B, np.float32), zeros,
                 np.ones(B, np.float32), np.zeros(B, np.uint32), _t(eos))
    return jax_args, jax_tail, port_args, port_tail


def _close_pools(tk, tv, jk, jv) -> None:
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)


PAGED_CASES = {"dense": ("dense", "dense", False),
               "q_lora": ("q_lora", "dense", False),
               "v2": ("v2", "dense", False),
               "v2_blocked": ("v2", "blocked", False),
               "v2_grouped": ("v2_grouped", "dense", False),
               "v3": ("v3", "dense", False),
               "v3_blocked": ("v3", "blocked", False),
               "q_lora_int8": ("q_lora", "dense", True),
               "v3_int8": ("v3", "blocked", True)}


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_paths_match_reference(case, monkeypatch):
    """3 layers at narrow widths: a [4, 16] prefill (three rows and a
    padding row; on the blocked dispatch where the case says so), a
    second chunk continuing a row from the pool, two teacher-forced
    decode steps (T = 1), then the engine's generic 5-step greedy window
    (``_make_decode_multi``) against the JAX engine's: logits and both
    pools (the padding row wrote nothing) within 1e-4, the window's
    tokens and emitted counts identical; int8 params (the JAX package's
    quantization, bridged) too. The port runs every call under
    NoHostReads."""
    name, strategy, int8 = PAGED_CASES[case]
    _patch_block(monkeypatch, BLOCKS[strategy])
    jcfg, tcfg, jp, tp = _setup(name, int8=int8, seed=3)
    if int8:
        assert isinstance(tp["w_uk"], QuantInt8)
        assert tuple(tp["w_uk"].shape) == tuple(jp["w_uk"].q.shape)
    if tcfg.num_experts:
        assert tl._moe_use_blocked(None, 64, 8, 2, tl._MOE_BLOCK) == (
            strategy == "blocked")
    jk, jv = jm.init_kv_cache(jcfg, jl.KVCacheSpec(32, PAGE))
    tk, tv = tm.init_kv_cache(tcfg, tl.KVCacheSpec(32, PAGE), device="cpu")
    j_pre, j_dec = jm.make_step_fns(jcfg)
    t_pre, t_dec = tm.make_step_fns(tcfg)
    B, T, P = 4, 16, 4
    pages = [[1, 2, 3], [4, 5, 6, 10], [7, 8, 9], []]
    live = [0, 1, 2]
    x = _prefill_inputs(B, T, P, [0] * 4, [12, 16, 7, 0], pages)
    jo, jk, jv = j_pre(jp, *map(jnp.asarray, x[:2]), jk, jv,
                       *map(jnp.asarray, x[2:]))
    with NoHostReads():
        to, tk, tv = t_pre(tp, *map(_t, x[:2]), tk, tv, *map(_t, x[2:]))
    np.testing.assert_allclose(to.numpy()[live], np.asarray(jo)[live],
                               atol=ATOL, rtol=0)
    _close_pools(tk, tv, jk, jv)
    assert not tk[:, 0].any() and not tk[:, 11:].any()  # pages untouched
    # row 1 continues at position 16 (its prefix in the pool)
    x2 = _prefill_inputs(1, 8, P, [16], [8], [pages[1]], seed=6)
    jo2, jk, jv = j_pre(jp, *map(jnp.asarray, x2[:2]), jk, jv,
                        *map(jnp.asarray, x2[2:]))
    with NoHostReads():
        to2, tk, tv = t_pre(tp, *map(_t, x2[:2]), tk, tv, *map(_t, x2[2:]))
    np.testing.assert_allclose(to2.numpy(), np.asarray(jo2), atol=ATOL,
                               rtol=0)
    pos = np.array([12, 24, 7, -1], np.int32)
    tok = np.array([3, 4, 5, 0], np.int32)
    for _ in range(2):  # teacher-forced by the reference's greedy tokens
        slots = np.array([np.asarray(pg)[p // PAGE] * PAGE + p % PAGE
                          if p >= 0 else jl.DROP_SLOT
                          for pg, p in zip(pages, pos)], np.int32)
        jd, jk, jv = j_dec(jp, jnp.asarray(tok), jnp.asarray(pos), jk, jv,
                           jnp.asarray(x[2]), jnp.asarray(slots))
        with NoHostReads():
            td, tk, tv = t_dec(tp, _t(tok), _t(pos), tk, tv, _t(x[2]),
                               _t(slots))
        np.testing.assert_allclose(td.numpy()[live], np.asarray(jd)[live],
                                   atol=ATOL, rtol=0)
        tok = np.asarray(jnp.argmax(jd, -1)).astype(np.int32)
        pos = np.where(pos >= 0, pos + 1, -1).astype(np.int32)
    _close_pools(tk, tv, jk, jv)
    rem = np.array([50, 3, 50, 1], np.int32)
    ja, jt, pa, pt = _window_args(B, tok, pos, rem, x[2])
    jwin = jax_multi(jm, jcfg, 64)
    j_out = jwin(jp, *ja, jk, jv, *jt, k_steps=5)
    twin = _make_decode_multi(tm, tcfg, 64)
    with NoHostReads():
        t_out = twin(tp, *pa, tk, tv, *pt, k_steps=5)
    np.testing.assert_array_equal(t_out[0].numpy()[live],
                                  np.asarray(j_out[0])[live])
    np.testing.assert_array_equal(t_out[1].numpy(), np.asarray(j_out[1]))
    assert t_out[1].tolist() == [5, 3, 5, 0]
    for a, b in zip(t_out[2], j_out[2]):
        np.testing.assert_array_equal(a.numpy()[live], np.asarray(b)[live])
    _close_pools(t_out[3], t_out[4], j_out[3], j_out[4])


# ---------------------------------------------------------------- engines


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


ARMS = {"window": {}, "blocked": {}, "int8": {},
        "single_step": dict(decode_steps=1),
        "budgeted": dict(prefill_token_budget=8),
        "spec_decode": dict(spec_decode=True, spec_tokens=3)}


@pytest.mark.parametrize("arm", ARMS)
def test_engine_greedy_tokens_match_jax_engine(arm, monkeypatch, caplog):
    """TorchEngine and JaxEngine on the same bridged weights of the tiny
    v3 MLA MoE give identical greedy tokens for concurrent requests (one
    prefilled in three chunks): the generic window (K = 4), the window
    with the prefill bucket on the blocked dispatch, int8 weights (each
    engine quantizes the same float32 weights itself), the synchronous
    single-step arm, budgeted prefill mixing, and spec_decode, which
    warns as the JAX engine does and keeps the standard path (no verify
    graphs)."""
    _patch_block(monkeypatch, BLOCKS["blocked" if arm == "blocked"
                                     else "dense"])
    jcfg, tcfg, jp, tp = _setup("v3", seed=4)
    ecfg = dict(ECFG, **ARMS[arm])
    quant = "int8" if arm == "int8" else None
    jeng = JaxEngine(jcfg, JaxEngineConfig(**ecfg), params=jp, quant=quant)
    with caplog.at_level(logging.WARNING, logger="dynamo_tpu_torch.engine"):
        teng = TorchEngine(tcfg, EngineConfig(**ecfg), params=tp,
                           device="cpu", quant=quant)
    assert teng.model is tm
    if arm == "spec_decode":
        assert teng.verify_fn is None and teng.verify_graphs is None
        assert "no make_verify_fn; speculation disabled" in caplog.text
    if quant:
        assert isinstance(teng.params["w_down_e"], QuantInt8)
        np.testing.assert_array_equal(
            teng.params["w_down_e"].q.transpose(-1, -2).numpy(),
            np.asarray(jeng.params["w_down_e"].q))
    want = asyncio.run(_generate_all(jeng, JaxRequest, JaxStop, JaxContext))
    got = asyncio.run(_generate_all(teng, PreprocessedRequest,
                                    StopConditions, Context))
    assert got == want
    assert [len(t) for t in got] == MAX_TOKENS
    stats = teng.stats()
    assert stats["spec_decode_steps"] == 0
    if arm == "budgeted":
        assert teng.mixed_dispatches > 0


def test_disagg_plane_raises_on_mla():
    """The page-transfer plane refuses an MLA engine before touching the
    pools: one transfer shape cannot carry the latent and rope pools
    (ROADMAP.md note E)."""
    _, tcfg, _, tp = _setup("dense")
    engine = TorchEngine(tcfg, EngineConfig(**ECFG), params=tp,
                         device="cpu")

    async def chunked():
        async for _ in engine.extract_pages_chunked([1, 2], 1):
            pass

    req = PreprocessedRequest(token_ids=[1, 2, 3],
                              stop=StopConditions(max_tokens=2))
    calls = {"extract_pages": engine.extract_pages([1]),
             "extract_pages_chunked": chunked(),
             "inject_pages": engine.inject_pages(
                 [1], torch.zeros(3, 1, 1, PAGE, 16),
                 torch.zeros(3, 1, 1, PAGE, 8)),
             "prefill_only": engine.prefill_only(req, Context())}
    for what, coro in calls.items():
        with pytest.raises(NotImplementedError, match="note E"):
            asyncio.run(coro)
    assert not engine.kv_k.any()
    asyncio.run(engine.stop())


def test_random_and_synthetic_int8_engines_serve():
    """An MLA engine on its own random weights (drawn through the
    registry) and one on the benchmark-only synthetic int8 weights each
    serve finite greedy tokens through the generic window."""
    _, tcfg = _cfgs("v3")
    for params in (None, synthetic_int8_params(tcfg, device="cpu")):
        engine = TorchEngine(tcfg, EngineConfig(**ECFG), params=params,
                             device="cpu")

        async def go():
            req = PreprocessedRequest(token_ids=[1, 2, 3],
                                      stop=StopConditions(max_tokens=6))
            out = []
            async for d in engine.generate(req, Context()):
                out += d.token_ids
            await engine.stop()
            return out

        toks = asyncio.run(go())
        assert len(toks) == 6 and all(0 <= t < tcfg.vocab_size
                                      for t in toks)


# ------------------------------------------------------- tensor parallel


TP_WORKER = textwrap.dedent('''
    import json, os, sys
    import numpy as np
    import torch

    from dynamo_tpu_torch.engine.torch_engine import _make_decode_multi
    from dynamo_tpu_torch.models import mla
    from dynamo_tpu_torch.models.bridge import params_from_numpy
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.models.llama import KVCacheSpec
    from dynamo_tpu_torch.parallel.mesh import (MeshSpec, initialize_multihost,
                                                leave_process_groups)

    rank, size, store, data = sys.argv[1:5]
    rank, size = int(rank), int(size)
    initialize_multihost("file://" + store, size, rank)
    mesh = MeshSpec(model=size).build("cpu")
    cfg = ModelConfig(**json.load(open(os.path.join(data, "cfg.json"))))
    npz = np.load(os.path.join(data, "params.npz"))
    params = params_from_numpy({k: npz[k] for k in npz.files}, cfg,
                               device="cpu", rank=rank, size=size)
    x = np.load(os.path.join(data, "inputs.npz"))
    t = {k: torch.from_numpy(x[k]) for k in x.files}
    kk, vv = mla.init_kv_cache(cfg, KVCacheSpec(32, 8), device="cpu",
                               mesh=mesh)
    pre, _ = mla.make_step_fns(cfg, mesh=mesh)
    logits, kk, vv = pre(params, t["tokens"], t["positions"], kk, vv,
                         t["table"], t["slots"], t["last"])
    win = _make_decode_multi(mla, cfg, 64, mesh=mesh)
    B = t["tok"].shape[0]
    toks, emitted, carry, kk, vv = win(
        params, t["tok"], t["pos"], torch.zeros(B, dtype=torch.bool),
        torch.zeros(B, dtype=torch.int32), t["rem"], kk, vv, t["table"],
        np.zeros(B, np.float32), np.zeros(B, np.int32),
        np.ones(B, np.float32), np.zeros(B, np.uint32), t["eos"], k_steps=3)
    np.savez(os.path.join(data, f"out{rank}.npz"), prefill=logits.numpy(),
             toks=toks.numpy(), emitted=emitted.numpy(), kk=kk.numpy(),
             vv=vv.numpy())
    leave_process_groups(mesh)
    print("RESULT ok", flush=True)
''')


def test_two_ranks_of_an_mla_moe_model_match_tp1(tmp_path):
    """Two gloo ranks at model=2 on the tiny v3 MLA MoE (each rank its
    two heads of the up-projections, its rows of w_o, its cut of the
    dense-first, shared and expert MLPs; the latent pools whole): the
    prefill logits, the generic window's greedy tokens, emitted counts
    and both pools equal tp=1's, and the ranks' pools equal each
    other's."""
    jcfg, tcfg, jp, tp1 = _setup("v3", seed=6)
    (tmp_path / "cfg.json").write_text(json.dumps(dict(BASE,
                                                       **CONFIGS["v3"])))
    np.savez(tmp_path / "params.npz",
             **{k: np.asarray(v) for k, v in jp.items()})
    B = 4
    x = _prefill_inputs(B, 16, 4, [0] * 4, [12, 16, 7, 0],
                        [[1, 2, 3], [4, 5, 6], [7, 8, 9], []])
    inputs = dict(zip(("tokens", "positions", "table", "slots", "last"), x))
    kk, vv = tm.init_kv_cache(tcfg, tl.KVCacheSpec(32, PAGE), device="cpu")
    logits, kk, vv = tm.make_step_fns(tcfg)[0](tp1, *map(_t, x[:2]), kk, vv,
                                               *map(_t, x[2:]))
    tok = torch.argmax(logits, -1).to(torch.int32).numpy()
    tok[3] = 0
    inputs.update(tok=tok, pos=np.array([12, 16, 7, -1], np.int32),
                  rem=np.array([50, 2, 50, 1], np.int32),
                  eos=np.full((B, 2), -1, np.int32))
    np.savez(tmp_path / "inputs.npz", **inputs)
    win = _make_decode_multi(tm, tcfg, 64)
    _, _, pa, pt = _window_args(B, tok, inputs["pos"], inputs["rem"], x[2])
    ref = win(tp1, *pa, kk, vv, *pt, k_steps=3)

    script = tmp_path / "mla_rank.py"
    script.write_text(TP_WORKER)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    logs = [tmp_path / f"rank{r}.log" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), "2", str(tmp_path / "store"),
         str(tmp_path)], env=env, cwd=REPO, stdout=open(logs[r], "w"),
        stderr=subprocess.STDOUT) for r in range(2)]
    try:
        deadline = time.monotonic() + 240
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.read_text()[-4000:]
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    live = [0, 1, 2]
    for out in outs:
        np.testing.assert_allclose(out["prefill"][live],
                                   logits.numpy()[live], atol=ATOL, rtol=0)
        np.testing.assert_array_equal(out["toks"][live],
                                      ref[0].numpy()[live])
        np.testing.assert_array_equal(out["emitted"], ref[1].numpy())
        np.testing.assert_allclose(out["kk"], ref[3].numpy(), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(out["vv"], ref[4].numpy(), atol=ATOL,
                                   rtol=0)
    np.testing.assert_array_equal(outs[0]["kk"], outs[1]["kk"])
    np.testing.assert_array_equal(outs[0]["vv"], outs[1]["vv"])
