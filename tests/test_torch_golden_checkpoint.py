"""The port's weights loader (dynamo_tpu_torch/models/loader.py) on real
HF checkpoints written locally by ``transformers`` in float32 (offline):
Llama untied and tied, Qwen2 with q/k/v biases, Qwen3 with q/k norms,
Gemma-2 with sandwich norms and softcaps, and a Llama in two shards with
its index file. Modelled on tests/test_golden_checkpoint.py and
tests/test_loader.py:

- the loaded params equal the JAX loader's bitwise, key by key;
- the port's forward matches ``transformers`` logits (rtol = atol = 2e-4);
- TorchEngine's greedy tokens equal ``transformers.generate``'s and
  JaxEngine's on the same checkpoint;
- a BF16 checkpoint read by the port's own reader is bitwise what
  ``safetensors.torch.load_file`` reads;
- a tensor-parallel rank's load is exactly ``shard_param`` of the whole;
- a Mixtral checkpoint (MoE) and a DeepSeek-V2 one (MLA) load, in
  float32 and in int8, as the JAX loader loads them; the launcher serves
  ``--model-path``;
- DeepSeek checkpoints (V2 dense with and without q LoRA, V2 MoE with
  group-limited routing, V3 MoE with a nonzero selection bias, all with
  interleaved rope) load bitwise as the JAX loader loads them, in float32
  and int8; the port's MLA logits match transformers' at the reference's
  tolerance (rtol = atol = 3e-4, tests/test_golden_checkpoint.py); the
  launcher serves the V2 MoE checkpoint greedily to transformers'
  tokens."""

import asyncio
import dataclasses
import json

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
from dynamo_tpu.models.loader import load_params as jax_load_params
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                   StopConditions)
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.loader import SafetensorsFile, load_params
from dynamo_tpu_torch.parallel.mesh import MeshSpec, shard_param
from dynamo_tpu_torch.runtime.engine import Context

transformers = pytest.importorskip("transformers")

LOGIT_TOL = 2e-4
# the JAX golden test's engine config
ECFG = dict(page_size=4, num_pages=64, max_batch=4, prefill_chunk=16,
            prefill_buckets=(16,), batch_buckets=(4,), page_buckets=(16,),
            decode_steps=4)
COMMON = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=16,
              max_position_embeddings=256, rope_theta=10000.0,
              torch_dtype="float32")


def _make(kind: str):
    """(transformers model, save_pretrained kwargs) of one family."""
    from transformers import (Gemma2Config, Gemma2ForCausalLM, LlamaConfig,
                              LlamaForCausalLM, Qwen2Config,
                              Qwen2ForCausalLM, Qwen3Config,
                              Qwen3ForCausalLM)

    save = {}
    if kind in ("llama", "llama_tied", "llama_sharded"):
        cfg = LlamaConfig(vocab_size=512, rms_norm_eps=1e-5,
                          tie_word_embeddings=kind == "llama_tied",
                          attention_bias=False, **COMMON)
        cls, seed = LlamaForCausalLM, 7
        if kind == "llama_sharded":
            save = {"max_shard_size": "200KB"}
    elif kind == "qwen2":
        cfg = Qwen2Config(vocab_size=160, rms_norm_eps=1e-6,
                          tie_word_embeddings=False, **COMMON)
        cls, seed = Qwen2ForCausalLM, 19
    elif kind == "qwen3":
        cfg = Qwen3Config(vocab_size=160, rms_norm_eps=1e-6,
                          tie_word_embeddings=False,
                          attn_implementation="eager", **COMMON)
        cls, seed = Qwen3ForCausalLM, 17
    elif kind == "gemma2":
        cfg = Gemma2Config(vocab_size=160, rms_norm_eps=1e-6,
                           tie_word_embeddings=True,
                           hidden_activation="gelu_pytorch_tanh",
                           query_pre_attn_scalar=16, sliding_window=8,
                           attn_logit_softcapping=30.0,
                           final_logit_softcapping=20.0,
                           attn_implementation="eager", **COMMON)
        cls, seed = Gemma2ForCausalLM, 13
    else:
        raise ValueError(kind)
    torch.manual_seed(seed)
    return cls(cfg).eval(), save


KINDS = ["llama", "llama_tied", "qwen2", "qwen3", "gemma2", "llama_sharded"]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Every family's checkpoint, written once: kind → (path, model)."""
    out = {}
    for kind in KINDS:
        model, save = _make(kind)
        path = tmp_path_factory.mktemp(f"ckpt_{kind}") / "ckpt"
        model.save_pretrained(path, safe_serialization=True, **save)
        out[kind] = (str(path), model)
    return out


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def test_checkpoints_have_the_layouts_under_test(checkpoints):
    """The fixtures are what the cases claim: two shards and an index,
    a tied head without lm_head, the family switches."""
    import os

    path, _ = checkpoints["llama_sharded"]
    with open(os.path.join(path, "model.safetensors.index.json")) as f:
        files = set(json.load(f)["weight_map"].values())
    assert len(files) >= 2
    cfg = ModelConfig.from_local_path(checkpoints["llama_tied"][0])
    assert cfg.tie_word_embeddings
    assert ModelConfig.from_local_path(checkpoints["qwen2"][0]).attn_bias
    assert ModelConfig.from_local_path(checkpoints["qwen3"][0]).qk_norm
    g = ModelConfig.from_local_path(checkpoints["gemma2"][0])
    assert g.sandwich_norms and g.final_logit_softcap == 20.0


@pytest.mark.parametrize("kind", KINDS)
def test_loader_equals_jax_loader_bitwise(checkpoints, kind):
    """The same keys as the JAX loader's, each tensor bitwise equal to
    the JAX loader's float32 array (transposes, stacking, tied head,
    biases, q/k norms, sandwich norms)."""
    path, _ = checkpoints[kind]
    want = jax_load_params(path, JaxModelConfig.from_local_path(path),
                           dtype=jnp.float32)
    got = load_params(path, device="cpu", dtype=torch.float32)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    assert ("lm_head" in got) == (kind not in ("llama_tied", "gemma2"))


def _port_logits(params, cfg, tokens: np.ndarray) -> np.ndarray:
    """Logits at every position of ``tokens`` [B, T] from one prefill
    forward of the port's model over a paged pool (kernel wrappers, their
    plain versions on the CPU)."""
    B, T = tokens.shape
    ps = 4
    npg = -(-T // ps)
    kv_k, kv_v = tl.init_kv_cache(cfg, tl.KVCacheSpec(B * npg + 1, ps),
                                  device="cpu")
    table = 1 + np.arange(B * npg).reshape(B, npg)
    pos = np.arange(T)
    slots = table[:, pos // ps] * ps + pos % ps
    h, _, _ = tl.forward(
        params, cfg, torch.from_numpy(tokens.astype(np.int32)),
        torch.from_numpy(np.tile(pos, (B, 1)).astype(np.int32)),
        kv_k, kv_v, torch.from_numpy(table.astype(np.int32)),
        torch.from_numpy(slots.astype(np.int32)))
    return tl.project_logits(params, cfg, h).numpy()


@pytest.mark.parametrize("kind", KINDS[:5])
def test_logits_match_transformers(checkpoints, kind):
    """The port's forward on the loaded weights equals transformers'
    logits position by position (24 tokens: past Gemma-2's window of
    8)."""
    path, hf = checkpoints[kind]
    cfg = _f32(ModelConfig.from_local_path(path))
    params = load_params(path, cfg, "cpu")
    V = cfg.vocab_size
    tokens = np.random.RandomState(2).randint(1, V, size=(2, 24))
    ours = _port_logits(params, cfg, tokens)
    with torch.no_grad():
        theirs = hf(torch.tensor(tokens, dtype=torch.long)).logits.numpy()
    np.testing.assert_allclose(ours, theirs, rtol=LOGIT_TOL, atol=LOGIT_TOL)


async def _greedy(engine, req, ctx, n):
    toks = []
    try:
        async for out in engine.generate(req, ctx):
            toks.extend(out.token_ids)
            if out.finish_reason:
                break
    finally:
        await engine.stop()
    return toks[:n]


@pytest.mark.parametrize("kind", KINDS)
def test_engine_greedy_matches_transformers_and_jax_engine(checkpoints,
                                                           kind):
    """The serving path (paged prefill chunks, pipelined fused windows)
    on the loaded weights greedy-generates what transformers.generate
    and JaxEngine generate on the same checkpoint."""
    path, hf = checkpoints[kind]
    cfg = _f32(ModelConfig.from_local_path(path))
    jcfg = _f32(JaxModelConfig.from_local_path(path))
    N = 10
    prompt = [(i * 17) % (cfg.vocab_size - 10) + 1 for i in range(18)]
    with torch.no_grad():
        want = hf.generate(torch.tensor([prompt], dtype=torch.long),
                           max_new_tokens=N, do_sample=False,
                           pad_token_id=0)[0, len(prompt):].tolist()
    teng = TorchEngine(cfg, EngineConfig(**ECFG),
                       params=load_params(path, cfg, "cpu"), device="cpu")
    got = asyncio.run(_greedy(teng, PreprocessedRequest(
        token_ids=prompt, stop=StopConditions(max_tokens=N,
                                              ignore_eos=True)),
        Context(), N))
    jeng = JaxEngine(jcfg, JaxEngineConfig(**ECFG),
                     params=jax_load_params(path, jcfg, dtype=jnp.float32))
    jax_toks = asyncio.run(_greedy(jeng, JaxRequest(
        token_ids=prompt, stop=JaxStop(max_tokens=N, ignore_eos=True),
        eos_token_ids=[]), JaxContext(), N))
    assert got == want == jax_toks, (got, want, jax_toks)


def test_bf16_reader_is_bitwise_safetensors(checkpoints, tmp_path):
    """A BF16 checkpoint (what published Llama-3 checkpoints hold) read
    by the port's reader is bitwise what safetensors.torch.load_file
    reads, and load_params keeps it in bfloat16 with no float32 step:
    each param equals the file's tensor, transposed where the loader
    transposes."""
    from safetensors.torch import load_file

    _, hf = checkpoints["llama"]
    path = tmp_path / "bf16"
    hf.to(torch.bfloat16).save_pretrained(path, safe_serialization=True)
    hf.to(torch.float32)
    want = load_file(str(path / "model.safetensors"))
    f = SafetensorsFile(str(path / "model.safetensors"))
    assert set(f.keys()) == set(want)
    for k, w in want.items():
        got = f.get(k)
        assert got.dtype == torch.bfloat16 and got.shape == w.shape, k
        assert torch.equal(got.view(torch.int16), w.view(torch.int16)), k
    p = load_params(str(path), device="cpu")
    assert p["wq"].dtype == torch.bfloat16
    assert torch.equal(
        p["wq"][1], want["model.layers.1.self_attn.q_proj.weight"].T)
    assert torch.equal(p["embed"], want["model.embed_tokens.weight"])


@pytest.mark.parametrize("kind", ["llama", "qwen2"])
def test_rank_loading_is_shard_param_of_the_whole(checkpoints, kind):
    """Each tensor-parallel rank's load (rank/size) is exactly
    shard_param of the whole param, for every key: the column-parallel
    projections and biases, the row-parallel wo and w_down, the vocab
    shards of the embedding and the head, the replicated norms."""
    path, _ = checkpoints[kind]
    cfg = ModelConfig.from_local_path(path)
    whole = load_params(path, cfg, "cpu", dtype=torch.float32)
    for rank in range(2):
        part = load_params(path, cfg, "cpu", dtype=torch.float32, rank=rank,
                           size=2)
        mesh = MeshSpec(model=2).view(rank)
        assert set(part) == set(whole)
        for k, w in whole.items():
            assert torch.equal(part[k], shard_param(k, w, cfg, mesh)), k
    assert part["wo"].shape[1] == whole["wo"].shape[1] // 2


def _write_config(path, **hf):
    path.mkdir(parents=True, exist_ok=True)
    base = {"vocab_size": 64, "hidden_size": 16, "intermediate_size": 32,
            "num_hidden_layers": 1, "num_attention_heads": 2}
    (path / "config.json").write_text(json.dumps({**base, **hf}))
    return str(path)


def _same_params(got, want) -> None:
    """The port's params equal the JAX loader's key by key, bitwise (an
    int8 weight: its q, in the port's [..., out, in] layout, and s)."""
    from dynamo_tpu.models.quant import QuantInt8 as JaxQuantInt8

    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, JaxQuantInt8):
            np.testing.assert_array_equal(
                got[k].q.transpose(-1, -2).numpy(), np.asarray(w.q),
                err_msg=k)
            np.testing.assert_array_equal(got[k].s.numpy(),
                                          np.asarray(w.s), err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w),
                                          err_msg=k)


def test_moe_and_mla_load_and_unknown_quant_raises(checkpoints, tmp_path):
    """A Mixtral checkpoint written by transformers loads, in float32 and
    with int8 projections, to the JAX loader's keys and values (the
    router [L, D, E], the experts stacked [L, E, in, out]; more cases in
    tests/test_torch_moe.py). An MLA checkpoint (DeepSeek-V2) loads too,
    with or without int8, to the JAX loader's values, and runs: its
    logits are finite (more cases below and in tests/test_torch_mla.py).
    An unknown quant mode is a ValueError."""
    from transformers import MixtralConfig, MixtralForCausalLM

    from dynamo_tpu_torch.models import mla as tm

    torch.manual_seed(23)
    hf = MixtralForCausalLM(MixtralConfig(
        vocab_size=512, rms_norm_eps=1e-5, tie_word_embeddings=False,
        num_local_experts=4, num_experts_per_tok=2, **COMMON))
    mixtral = tmp_path / "mixtral"
    hf.save_pretrained(mixtral, safe_serialization=True)
    cfg = ModelConfig.from_local_path(str(mixtral))
    assert (cfg.num_experts, cfg.num_experts_per_tok) == (4, 2)
    for quant in (None, "int8"):
        want = jax_load_params(str(mixtral),
                               JaxModelConfig.from_local_path(str(mixtral)),
                               dtype=jnp.float32, quant=quant)
        got = load_params(str(mixtral), device="cpu", dtype=torch.float32,
                          quant=quant)
        assert "w_router" in got
        _same_params(got, want)
        assert tuple(got["w_down"].shape) == (2, 4, 128, 64)
    mla = tmp_path / "mla"
    _deepseek_model("v2_dense").save_pretrained(mla, safe_serialization=True)
    mcfg = _f32(ModelConfig.from_local_path(str(mla)))
    assert mcfg.is_mla
    for quant in (None, "int8"):
        got = load_params(str(mla), mcfg, "cpu", quant=quant)
        _same_params(got, jax_load_params(
            str(mla), JaxModelConfig.from_local_path(str(mla)),
            dtype=jnp.float32, quant=quant))
        logits = tm.reference_forward(got, mcfg, torch.tensor([[1, 2, 3]]))
        assert logits.shape == (1, 3, 160)
        assert bool(torch.isfinite(logits).all())
    path, _ = checkpoints["llama"]
    with pytest.raises(ValueError, match="unknown quant"):
        load_params(path, device="cpu", quant="int4")


# ------------------------------------------------------------ DeepSeek (MLA)


DEEPSEEK_KINDS = ["v2_dense", "v2_dense_q_lora", "v2_moe", "v3_moe"]
# the reference's tolerance for its DeepSeek logits against transformers
# (tests/test_golden_checkpoint.py)
DEEPSEEK_TOL = 3e-4


def _deepseek_model(kind: str):
    """A tiny DeepSeek model of ``kind`` built by transformers (float32,
    eager attention, interleaved rope): the reference's golden configs
    (tests/test_golden_checkpoint.py), V3's with its selection bias drawn
    nonzero, so that the bias-against-weight distinction carries."""
    from transformers import (DeepseekV2Config, DeepseekV2ForCausalLM,
                              DeepseekV3Config, DeepseekV3ForCausalLM)

    common = dict(vocab_size=160, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=3, num_attention_heads=4,
                  num_key_value_heads=4, kv_lora_rank=16,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                  head_dim=8, max_position_embeddings=256,
                  rms_norm_eps=1e-6, rope_theta=10000.0,
                  tie_word_embeddings=False, rope_interleave=True,
                  torch_dtype="float32", attn_implementation="eager")
    if kind == "v3_moe":
        torch.manual_seed(31)
        model = DeepseekV3ForCausalLM(DeepseekV3Config(
            q_lora_rank=24, n_routed_experts=8, num_experts_per_tok=2,
            moe_intermediate_size=32, n_shared_experts=1,
            first_k_dense_replace=1, n_group=4, topk_group=2,
            routed_scaling_factor=2.0, norm_topk_prob=True,
            **common)).eval()
        with torch.no_grad():
            for layer in model.model.layers[1:]:
                layer.mlp.gate.e_score_correction_bias.uniform_(-0.5, 0.5)
        return model
    kw = dict(q_lora_rank=None, n_routed_experts=None,
              # HF builds a MoE block for every layer from
              # first_k_dense_replace on, even without experts: an
              # all-dense model needs it past the last layer
              first_k_dense_replace=99)
    seed = 23
    if kind == "v2_dense_q_lora":
        kw["q_lora_rank"], seed = 24, 37
    elif kind == "v2_moe":
        kw.update(n_routed_experts=8, num_experts_per_tok=2,
                  moe_intermediate_size=32, n_shared_experts=2,
                  first_k_dense_replace=1, moe_layer_freq=1,
                  topk_method="group_limited_greedy", n_group=4,
                  topk_group=2, routed_scaling_factor=1.5,
                  norm_topk_prob=False, aux_loss_alpha=0.0, seq_aux=False)
        seed = 29
    torch.manual_seed(seed)
    return DeepseekV2ForCausalLM(DeepseekV2Config(**common, **kw)).eval()


@pytest.fixture(scope="module")
def deepseek_checkpoints(tmp_path_factory):
    """Every DeepSeek kind's checkpoint, written once: kind → (path,
    model)."""
    out = {}
    for kind in DEEPSEEK_KINDS:
        model = _deepseek_model(kind)
        path = tmp_path_factory.mktemp(f"ckpt_{kind}") / "ckpt"
        model.save_pretrained(path, safe_serialization=True)
        out[kind] = (str(path), model)
    return out


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("kind", DEEPSEEK_KINDS)
def test_deepseek_loader_is_bitwise_jax_loader(deepseek_checkpoints, kind,
                                               quant):
    """The port's loader on a transformers-written DeepSeek checkpoint:
    the JAX loader's keys and values, bitwise, in float32 and with int8
    projections (kv_b_proj split into w_uk / w_uv, the rope columns of
    w_dkv and of each head's q block permuted, the MoE segments, the
    router and V3's selection bias); the configs parse as the
    reference's."""
    path, _ = deepseek_checkpoints[kind]
    cfg = ModelConfig.from_local_path(path)
    jcfg = JaxModelConfig.from_local_path(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.is_mla and cfg.rope_interleave
    got = load_params(path, cfg, "cpu", dtype=torch.float32, quant=quant)
    _same_params(got, jax_load_params(path, jcfg, dtype=jnp.float32,
                                      quant=quant))
    assert ("w_uq" in got) == (cfg.q_lora_rank > 0)
    assert ("router_bias" in got) == (kind == "v3_moe")
    if kind == "v3_moe" and quant is None:
        assert bool(got["router_bias"].abs().gt(0).all())


def _mla_port_logits(params, cfg, tokens: np.ndarray) -> np.ndarray:
    """Logits at every position of ``tokens`` [B, T] from one prefill
    forward of the port's MLA model over paged latent pools."""
    from dynamo_tpu_torch.models import mla as tm

    B, T = tokens.shape
    ps = 4
    npg = -(-T // ps)
    kv_k, kv_v = tm.init_kv_cache(cfg, tl.KVCacheSpec(B * npg + 1, ps),
                                  device="cpu")
    table = 1 + np.arange(B * npg).reshape(B, npg)
    pos = np.arange(T)
    slots = table[:, pos // ps] * ps + pos % ps
    h, _, _ = tm.forward(
        params, cfg, torch.from_numpy(tokens.astype(np.int32)),
        torch.from_numpy(np.tile(pos, (B, 1)).astype(np.int32)),
        kv_k, kv_v, torch.from_numpy(table.astype(np.int32)),
        torch.from_numpy(slots.astype(np.int32)))
    return tl.project_logits(params, cfg, h).numpy()


@pytest.mark.parametrize("kind", DEEPSEEK_KINDS)
def test_deepseek_logits_match_transformers(deepseek_checkpoints, kind):
    """The port's paged, absorbed forward and its non-absorbed oracle on
    the loaded weights both equal transformers' logits position by
    position, at the reference's tolerance."""
    from dynamo_tpu_torch.models import mla as tm

    path, hf = deepseek_checkpoints[kind]
    cfg = _f32(ModelConfig.from_local_path(path))
    params = load_params(path, cfg, "cpu")
    tokens = np.random.RandomState(9).randint(1, 160, size=(2, 12))
    with torch.no_grad():
        theirs = hf(torch.tensor(tokens, dtype=torch.long)).logits.numpy()
    ours = _mla_port_logits(params, cfg, tokens)
    np.testing.assert_allclose(ours, theirs, rtol=DEEPSEEK_TOL,
                               atol=DEEPSEEK_TOL)
    oracle = tm.reference_forward(params, cfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(oracle.numpy(), theirs, rtol=DEEPSEEK_TOL,
                               atol=DEEPSEEK_TOL)


def test_launcher_serves_a_deepseek_checkpoint(deepseek_checkpoints):
    """``--model-path DIR`` on the DeepSeek-V2 MoE checkpoint: the
    launcher builds the MLA engine through the registry, serves it in
    bfloat16 (its default) to transformers' float32 greedy tokens, and
    answers over HTTP; with ``--dtype int8`` the MLA keys are int8 and it
    serves finite tokens."""
    import aiohttp

    from dynamo_tpu_torch.models import mla as tm
    from dynamo_tpu_torch.models.quant import QuantInt8
    from dynamo_tpu_torch.run import build_engine, parse_args, serve_http

    path, hf = deepseek_checkpoints["v2_moe"]
    N = 8
    prompt = [(i * 7) % 150 + 1 for i in range(11)]
    with torch.no_grad():
        want = hf.generate(torch.tensor([prompt], dtype=torch.long),
                           max_new_tokens=N, do_sample=False,
                           pad_token_id=0)[0, len(prompt):].tolist()
    for dtype in ("bf16", "int8"):
        engine, mdc, _ = build_engine(parse_args([
            "in=http", "out=torch", "--model-path", path, "--device",
            "cpu", "--no-warmup", "--dtype", dtype]))
        assert engine.model is tm and engine.cfg.num_experts == 8
        assert engine.cfg.dtype == "bfloat16"
        assert isinstance(engine.params["w_gate_e"], QuantInt8) == (
            dtype == "int8")
        got = asyncio.run(_greedy(engine, PreprocessedRequest(
            token_ids=prompt, stop=StopConditions(max_tokens=N,
                                                  ignore_eos=True)),
            Context(), N))
        if dtype == "bf16":
            assert got == want
        assert len(got) == N and all(0 <= t < 160 for t in got)
    engine, mdc, _ = build_engine(parse_args([
        "in=http", "out=torch", "--model-path", path, "--device", "cpu",
        "--no-warmup"]))

    async def main():
        svc = await serve_http(engine, mdc, "127.0.0.1", 0)
        try:
            async with aiohttp.ClientSession(
                    timeout=aiohttp.ClientTimeout(total=120)) as http:
                async with http.post(
                        f"http://127.0.0.1:{svc.port}/v1/completions",
                        json={"model": mdc.name, "prompt": prompt,
                              "max_tokens": 4}) as r:
                    return r.status, await r.json()
        finally:
            await svc.stop()
            await engine.stop()

    status, body = asyncio.run(main())
    assert status == 200, body
    assert body["choices"][0]["finish_reason"] == "length"


def test_launcher_serves_model_path(checkpoints, tmp_path):
    """``--model-path DIR`` is accepted; the launcher builds the
    checkpoint's config, card (byte tokenizer: no tokenizer files), the
    default EngineConfig and its loaded weights, and serves them over
    HTTP; a directory with no weights raises."""
    import aiohttp

    from dynamo_tpu_torch.run import build_engine, parse_args, serve_http

    path, _ = checkpoints["llama"]
    args = parse_args(["in=http", "out=torch", "--model-path", path,
                       "--device", "cpu", "--no-warmup"])
    engine, mdc, _ = build_engine(args)
    # the engine resolves the host tier's None-means-env fields in place,
    # as the JAX engine does; every other field is the default's
    assert dataclasses.replace(engine.ecfg, host_tier_int8=None,
                               evict_policy=None,
                               restore_overlap=None) == EngineConfig()
    assert mdc.name == "ckpt" and mdc.tokenizer_kind == "byte"
    assert mdc.context_length == 256
    want = load_params(path, device="cpu")
    assert all(torch.equal(engine.params[k], want[k]) for k in want)

    async def main():
        svc = await serve_http(engine, mdc, "127.0.0.1", 0)
        try:
            async with aiohttp.ClientSession() as http:
                async with http.post(
                        f"http://127.0.0.1:{svc.port}/v1/completions",
                        json={"model": "ckpt", "prompt": [5, 6, 7, 8],
                              "max_tokens": 5}) as r:
                    return r.status, await r.json()
        finally:
            await svc.stop()
            await engine.stop()

    status, body = asyncio.run(main())
    assert status == 200, body
    assert body["choices"][0]["finish_reason"] == "length"
    assert isinstance(body["choices"][0]["text"], str)
    empty = _write_config(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no safetensors"):
        build_engine(parse_args(["in=http", "out=torch", "--model-path",
                                 empty, "--device", "cpu"]))
