"""Weight-only int8 in the port (dynamo_tpu_torch/models/quant.py, the
int8 GEMM's plain version, the loader's quant="int8", the engine's
quant="int8", the int8 shards of tensor parallelism and the launcher's
--dtype) against the JAX package's models/quant.py, on the CPU, case by
case after tests/test_quant.py. Inputs are made from a seed with numpy
or by the JAX package and bridged through numpy.

Tolerances: the int8 values and scales are bitwise the JAX package's
(the same float32 arithmetic, round half to even); the post-scale
product equals the dequantized one within 1e-6 (float32, the scale is
constant along the contraction); the tiny forward matches JAX's
reference_forward on the same int8 params within atol = rtol = 1e-4
(float32 end to end, another summation order); greedy tokens are
identical to JaxEngine(quant="int8")'s."""

import asyncio
import json
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
from dynamo_tpu.llm.protocols.common import (PreprocessedRequest as
                                             JaxRequest)
from dynamo_tpu.llm.protocols.common import StopConditions as JaxStop
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.loader import load_params as jax_load_params
from dynamo_tpu.models.quant import QuantInt8 as JaxQuantInt8
from dynamo_tpu.models.quant import quantize_int8 as jax_quantize_int8
from dynamo_tpu.models.quant import quantize_int8_np
from dynamo_tpu.models.quant import quantize_params as jax_quantize_params
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                   StopConditions)
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.loader import load_params
from dynamo_tpu_torch.models.quant import (QUANT_KEYS, QuantInt8,
                                           quantize_int8,
                                           synthetic_int8_params)
from dynamo_tpu_torch.ops.int8_gemm import (int8_gemm_plan, int8_gemm_work,
                                            int8_matmul, int8_matmul_plain)
from dynamo_tpu_torch.parallel.mesh import MeshSpec, shard_param
from dynamo_tpu_torch.runtime.engine import Context

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
ECFG = dict(page_size=8, num_pages=64, max_batch=4, prefill_chunk=16,
            prefill_buckets=(16,), batch_buckets=(1, 2, 4), page_buckets=(8,),
            decode_steps=4)
PROMPTS = [list(range(1, 6)), list(range(30, 70)),  # > prefill_chunk
           list(range(100, 117)), [7, 7, 7]]
MAX_TOKENS = [9, 12, 10, 5]


def _jax_layout(qw: QuantInt8):
    """The port's (q [..., out, in], s) as the JAX package's (q [..., in,
    out], s) numpy arrays."""
    return qw.q.transpose(-1, -2).numpy(), qw.s.numpy()


def _assert_same_int8(got: QuantInt8, want, name=""):
    q, s = _jax_layout(got)
    np.testing.assert_array_equal(q, np.asarray(want.q), err_msg=name)
    np.testing.assert_array_equal(s, np.asarray(want.s), err_msg=name)
    assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32
    assert got.q.is_contiguous() and got.s.is_contiguous()


def _numpy_tree(params):
    """The JAX params for params_from_numpy: arrays as numpy, int8
    weights as they are (their q and s go through numpy there)."""
    return {k: v if isinstance(v, JaxQuantInt8) else np.asarray(v)
            for k, v in params.items()}


# ------------------------------------------------------------ the scheme


@pytest.mark.parametrize("case", ["float32", "bfloat16", "zero_column"])
def test_quantize_int8_is_bitwise_jax(case):
    """quantize_int8 gives quantize_int8_np's (and the JAX quantize_int8's)
    int8 values and scales bitwise, from float32 and bfloat16 weights; a
    column of zeros gets the 1e-12 floor and zeros; |w - q s| <= s / 2."""
    rng = np.random.RandomState(0)
    w = (rng.randn(3, 32, 16) * 0.07).astype(np.float32)
    if case == "zero_column":
        w[:, :, 5] = 0.0
    jw = jnp.asarray(w, jnp.bfloat16 if case == "bfloat16" else jnp.float32)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32)))
    if case == "bfloat16":
        tw = tw.to(torch.bfloat16)
    got = quantize_int8(tw)
    assert tuple(got.shape) == w.shape
    assert tuple(got.q.shape) == (3, 16, 32) and tuple(got.s.shape) == (3, 1, 16)
    for want in (quantize_int8_np(np.asarray(jw)), jax_quantize_int8(jw)):
        _assert_same_int8(got, want)
    err = np.abs(got.dequant().numpy() - tw.float().numpy())
    assert (err <= got.s.numpy() / 2 + 1e-7).all()
    if case == "zero_column":
        assert (got.s.numpy()[..., 5] == np.float32(1e-12)).all()
        assert not got.q[:, 5].any()


def test_post_scale_matmul_matches_dequant_and_jax():
    """x @ QuantInt8 computes (x @ q) * s: equal to dequantize-then-matmul
    in float32 (rtol = atol = 1e-6), and to the JAX QuantInt8's product;
    the plain flag and the wrapper take the same plain version on the
    CPU, over leading dimensions too."""
    rng = np.random.RandomState(1)
    w = (rng.randn(24, 12) * 0.1).astype(np.float32)
    x = rng.randn(5, 24).astype(np.float32)
    qw = quantize_int8(torch.from_numpy(w))
    tx = torch.from_numpy(x)
    got = tx @ qw
    np.testing.assert_allclose(got.numpy(),
                               (tx @ qw.dequant(torch.float32)).numpy(),
                               rtol=1e-6, atol=1e-6)
    jgot = jnp.asarray(x) @ jax_quantize_int8(jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(tx @ qw.as_plain(), got)
    assert torch.equal(int8_matmul(tx, qw.q, qw.s),
                       int8_matmul_plain(tx, qw.q, qw.s))
    x3 = torch.from_numpy(rng.randn(2, 3, 24).astype(np.float32))
    assert tuple((x3 @ qw).shape) == (2, 3, 12)
    np.testing.assert_allclose((x3 @ qw).numpy()[1], (x3[1] @ qw).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_getitem_slices_the_layer_axis():
    """qw[l] is layer l's weight (q and s share the leading axis), in the
    JAX package's shapes; the plain flag carries over."""
    w = (np.random.RandomState(2).randn(4, 8, 6) * 0.1).astype(np.float32)
    qw = quantize_int8(torch.from_numpy(w))
    one = qw[1]
    assert tuple(one.shape) == (8, 6) and one.ndim == 2
    assert tuple(one.q.shape) == (6, 8) and tuple(one.s.shape) == (1, 6)
    np.testing.assert_allclose(one.dequant().numpy(), qw.dequant().numpy()[1],
                               rtol=1e-6)
    _assert_same_int8(one, quantize_int8_np(w[1]))
    seg = qw[:2]
    assert seg.q.shape[0] == 2 and seg.s.shape[0] == 2
    assert qw.as_plain()[3].plain and not qw[3].plain
    assert qw.nbytes == 4 * 8 * 6 + 4 * 4 * 6
    assert torch.equal(qw.astype(torch.float32), qw.dequant())
    assert tuple(qw.reshape(4, 48).shape) == (4, 48)


def test_wrapper_checks_shapes_and_plan():
    """The wrapper refuses mismatched operands on any device; the launch
    plan and the bound are the shape arithmetic the kernel and
    chip_smoke.py use (the served 8B shapes on 132 SMs)."""
    q = torch.zeros(8, 32, dtype=torch.int8)
    s = torch.ones(8)
    with pytest.raises(ValueError, match="last dimension"):
        int8_matmul(torch.zeros(2, 16), q, s)
    with pytest.raises(ValueError, match="int8"):
        int8_matmul(torch.zeros(2, 32), q.float(), s)
    with pytest.raises(ValueError, match="float32 scales"):
        int8_matmul(torch.zeros(2, 32), q, s[:4])
    # (route, tile, splits, grid): small_m's m16 tiles and K splits of
    # 64-channel tiles; wgmma's tokens a tile, K splits and persistent grid
    assert int8_gemm_plan(4, 1024, 4096, 132) == \
        ("small_m", 1, 6, 96)                                   # wk, wv
    assert int8_gemm_plan(4, 4096, 4096, 132) == \
        ("small_m", 1, 2, 128)                                  # wq, wo
    assert int8_gemm_plan(64, 14336, 4096, 132) == \
        ("wgmma", 64, 1, 112)                                   # gate, up
    assert int8_gemm_plan(4, 14336, 4096, 132) == \
        ("small_m", 1, 1, 224)                                  # at 4 rows
    assert int8_gemm_plan(32, 4096, 14336, 132) == \
        ("small_m", 2, 2, 128)                                  # down
    assert int8_gemm_plan(4, 128256, 4096, 132) == \
        ("small_m", 1, 1, 2004)                                 # lm_head
    assert int8_gemm_plan(4, 64, 32, 132) == \
        ("small_m", 1, 1, 1)                                    # short K
    assert int8_gemm_plan(512, 4096, 4096, 132) == \
        ("wgmma", 256, 2, 128)                                  # a chunk
    assert int8_gemm_plan(4, 64, 32, 132, torch.float32) == \
        ("small_m", 1, 1, 1)                                    # float32
    w = int8_gemm_work(4, 4096, 1024)
    assert w["bytes"] == 4096 * 1024 + 4 * 1024 + 2 * 4 * 4096 + 2 * 4 * 1024
    assert w["flops"] == 2 * 4 * 4096 * 1024 and w["bound_by"] == "bytes"
    assert int8_gemm_work(4096, 4096, 4096)["bound_by"] == "operations"
    w = int8_gemm_work(4, 64, 64, torch.float32)  # float32 x and y
    assert w["bytes"] == 64 * 64 + 4 * 64 + 4 * 4 * 64 + 4 * 4 * 64


# -------------------------------------------------------- model, engine


def test_llama_forward_int8_matches_jax_reference():
    """The tiny Llama with the JAX package's int8 params, bridged (the
    same int8 values and scales): the port's paged forward over the whole
    prompt gives JAX's reference_forward logits on those params (atol =
    rtol = 1e-4, float32)."""
    jcfg, tcfg = JaxModelConfig.tiny(), ModelConfig.tiny()
    jparams = jax_quantize_params(jl.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0,
                                           500), np.int32)
    want = np.asarray(jl.reference_forward(jparams, jcfg,
                                           jnp.asarray(tokens)))
    tparams = params_from_numpy(_numpy_tree(jparams), tcfg, device="cpu")
    assert set(tparams) == set(jparams)
    for k in set(jparams) & QUANT_KEYS:
        assert isinstance(tparams[k], QuantInt8), k
        _assert_same_int8(tparams[k], jparams[k], k)
    B, T = tokens.shape
    ps, npg = 8, 2
    kk, vv = tl.init_kv_cache(tcfg, tl.KVCacheSpec(B * npg + 1, ps),
                              device="cpu")
    table = 1 + np.arange(B * npg).reshape(B, npg)
    pos = np.arange(T)
    slots = table[:, pos // ps] * ps + pos % ps
    h, _, _ = tl.forward(
        tparams, tcfg, torch.from_numpy(tokens),
        torch.from_numpy(np.tile(pos, (B, 1)).astype(np.int32)), kk, vv,
        torch.from_numpy(table.astype(np.int32)),
        torch.from_numpy(slots.astype(np.int32)))
    got = tl.project_logits(tparams, tcfg, h).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


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


def test_engine_int8_greedy_tokens_match_jax_engine():
    """TorchEngine(quant="int8") and JaxEngine(quant="int8") on the same
    float32 weights (each quantizes them itself): identical greedy
    tokens for concurrent requests, one of them prefilled in three
    chunks; the port's weights are int8."""
    jcfg, tcfg = JaxModelConfig.tiny(), ModelConfig.tiny()
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(3))
    jeng = JaxEngine(jcfg, JaxEngineConfig(**ECFG), params=jparams,
                     quant="int8")
    teng = TorchEngine(tcfg, EngineConfig(**ECFG), params=params_from_numpy(
        _numpy_tree(jparams), tcfg, device="cpu"), device="cpu",
        quant="int8")
    assert isinstance(teng.params["wq"], QuantInt8)
    assert teng.params["w_down"].q.dtype == torch.int8
    _assert_same_int8(teng.params["w_up"], jeng.params["w_up"])
    want = asyncio.run(_generate_all(jeng, JaxRequest, JaxStop, JaxContext))
    got = asyncio.run(_generate_all(teng, PreprocessedRequest,
                                    StopConditions, Context))
    assert got == want
    assert [len(t) for t in got] == MAX_TOKENS


def test_synthetic_int8_params_serve():
    """The benchmark-only init: the tree of init_params, int8 projections
    with fan-in scales, finite tokens through the engine."""
    cfg = ModelConfig.tiny()
    params = synthetic_int8_params(cfg, device="cpu")
    ref = tl.init_params(cfg, torch.Generator().manual_seed(0))
    assert set(params) == set(ref)
    for k, v in params.items():
        if isinstance(v, QuantInt8):
            assert k in QUANT_KEYS and v.q.dtype == torch.int8
            assert tuple(v.shape) == tuple(ref[k].shape)
        else:
            assert tuple(v.shape) == tuple(ref[k].shape)
    engine = TorchEngine(cfg, EngineConfig(**ECFG), params=params,
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
    assert len(toks) == 3 and all(0 <= t < cfg.vocab_size for t in toks)


# ------------------------------------------------ loader, tensor parallel


@pytest.fixture(scope="module")
def llama_ckpt(tmp_path_factory):
    """A tiny untied Llama checkpoint, float32, written by transformers
    (tests/test_torch_golden_checkpoint.py's writer)."""
    pytest.importorskip("transformers")
    from test_torch_golden_checkpoint import _make

    model, save = _make("llama")
    path = tmp_path_factory.mktemp("ckpt_int8") / "ckpt"
    model.save_pretrained(path, safe_serialization=True, **save)
    return str(path)


def test_loader_int8_is_bitwise_jax_loader(llama_ckpt):
    """load_params(quant="int8") gives the JAX loader's int8 values and
    scales bitwise (quantized from the file's values in float32), and
    its other params as the float32 load does."""
    want = jax_load_params(llama_ckpt,
                           JaxModelConfig.from_local_path(llama_ckpt),
                           dtype=jnp.float32, quant="int8")
    got = load_params(llama_ckpt, device="cpu", dtype=torch.float32,
                      quant="int8")
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, JaxQuantInt8):
            assert isinstance(got[k], QuantInt8), k
            _assert_same_int8(got[k], w, k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w),
                                          err_msg=k)
    with pytest.raises(ValueError, match="unknown quant"):
        load_params(llama_ckpt, device="cpu", quant="fp4")


def _assert_cut(part: QuantInt8, whole: QuantInt8, k, cfg, mesh):
    cut = shard_param(k, whole, cfg, mesh)
    assert torch.equal(part.q, cut.q) and torch.equal(part.s, cut.s), k
    assert part.q.is_contiguous() and part.s.is_contiguous(), k


def test_tp2_int8_shards_are_the_cut_of_tp1(llama_ckpt):
    """At model=2, each rank's int8 weights, from the loader, from
    params_from_numpy(rank=, size=) of the JAX int8 params and from the
    engine's random init, are bitwise the cut of tp=1's; the
    column-parallel scales are cut along out, the row-parallel ones (wo,
    w_down) whole."""
    cfg = ModelConfig.from_local_path(llama_ckpt)
    whole = load_params(llama_ckpt, cfg, "cpu", dtype=torch.float32,
                        quant="int8")
    jcfg, tcfg = JaxModelConfig.tiny(), ModelConfig.tiny()
    jparams = jax_quantize_params(jl.init_params(jcfg, jax.random.PRNGKey(4)))
    bridged = params_from_numpy(_numpy_tree(jparams), tcfg, device="cpu")
    ecfg = EngineConfig(**ECFG)
    drawn = TorchEngine(tcfg, ecfg, seed=5, device="cpu", quant="int8").params
    for rank in range(2):
        mesh = MeshSpec(model=2).view(rank, "cpu")
        part = load_params(llama_ckpt, cfg, "cpu", dtype=torch.float32,
                           rank=rank, size=2, quant="int8")
        bpart = params_from_numpy(_numpy_tree(jparams), tcfg, device="cpu",
                                  rank=rank, size=2)
        dpart = TorchEngine(tcfg, ecfg, seed=5, device="cpu", mesh=mesh,
                            quant="int8").params
        for got, ref, c in ((part, whole, cfg), (bpart, bridged, tcfg),
                            (dpart, drawn, tcfg)):
            assert set(got) == set(ref)
            for k in set(ref) & QUANT_KEYS:
                _assert_cut(got[k], ref[k], k, c, mesh)
            for k in ("wo", "w_down"):
                assert torch.equal(got[k].s, ref[k].s), k
                assert got[k].shape[-2] == ref[k].shape[-2] // 2, k
            for k in ("wq", "w_up", "lm_head"):
                assert got[k].s.shape[-1] == ref[k].s.shape[-1] // 2, k


WORKER = textwrap.dedent('''
    import os, sys
    import numpy as np
    import torch

    from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.models.bridge import params_from_numpy
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.models.quant import QuantInt8
    from dynamo_tpu_torch.parallel.mesh import (MeshSpec, initialize_multihost,
                                                leave_process_groups)

    rank, store, data = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    initialize_multihost("file://" + store, 2, rank)
    mesh = MeshSpec(model=2).build("cpu")
    cfg = ModelConfig.tiny()
    npz = np.load(os.path.join(data, "params.npz"))
    params = params_from_numpy({k: npz[k] for k in npz.files}, cfg,
                               device="cpu", rank=rank, size=2)
    engine = TorchEngine(cfg, EngineConfig(page_size=8, num_pages=16,
                                           max_batch=4),
                         params=params, mesh=mesh, quant="int8")
    out = {}
    for k, v in engine.params.items():
        if isinstance(v, QuantInt8):
            out[k + ".q"], out[k + ".s"] = v.q.numpy(), v.s.numpy()
    np.savez(os.path.join(data, f"int8_rank{rank}.npz"), **out)
    leave_process_groups(mesh)
    print("RESULT ok", flush=True)
''')


def test_tp2_engine_quantizes_given_shards_to_whole_scales(tmp_path):
    """Two gloo ranks, each given its float32 shard of the same weights
    with quant="int8": the row-parallel shards take the scales of the
    whole rows (the ranks' amax all-reduced with MAX), so every rank's
    int8 weights are bitwise the cut of quantizing the whole weights."""
    jcfg, tcfg = JaxModelConfig.tiny(), ModelConfig.tiny()
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(6))
    np.savez(tmp_path / "params.npz",
             **{k: np.asarray(v) for k, v in jparams.items()})
    whole = params_from_numpy(_numpy_tree(jax_quantize_params(jparams)), tcfg,
                              device="cpu")
    script = tmp_path / "int8_rank.py"
    script.write_text(WORKER)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    logs = [tmp_path / f"rank{r}.log" for r in range(2)]
    procs = []
    try:
        for r in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(r), str(tmp_path / "store"),
                 str(tmp_path)], env=env, cwd=REPO, stdout=open(logs[r], "w"),
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + 240
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log.read_text()[-4000:]}"
        got = np.load(tmp_path / f"int8_rank{r}.npz")
        mesh = MeshSpec(model=2).view(r, "cpu")
        for k in set(whole) & QUANT_KEYS:
            cut = shard_param(k, whole[k], tcfg, mesh)
            np.testing.assert_array_equal(got[k + ".q"], cut.q.numpy(), k)
            np.testing.assert_array_equal(got[k + ".s"], cut.s.numpy(), k)


def test_launcher_dtype_int8(llama_ckpt):
    """--dtype int8 serves int8 projections for a preset (random weights
    quantized as drawn, as TorchEngine(quant="int8") draws them) and for
    --model-path (the loader's int8 weights); the serving summary counts
    the int8 GEMM's calls by route."""
    from dynamo_tpu_torch.run import (build_engine, parse_args,
                                      serve_http, serving_summary)

    args = parse_args(["in=http", "out=torch", "--model", "tiny", "--device",
                       "cpu", "--dtype", "int8", "--no-warmup"])
    engine, mdc, _ = build_engine(args)
    want = TorchEngine(ModelConfig.tiny(), EngineConfig(**ECFG), seed=0,
                       device="cpu", quant="int8").params
    assert isinstance(engine.params["wq"], QuantInt8)
    for k in set(want) & QUANT_KEYS:
        assert torch.equal(engine.params[k].q, want[k].q), k
        assert torch.equal(engine.params[k].s, want[k].s), k
    summary = serving_summary(engine)
    assert summary["int8_gemm_launches"] == {
        "small_m": 0, "wgmma": 0, "small_m_f16": 0, "wgmma_f16": 0,
        "small_m_f32": 0, "wgmma_f32": 0}

    args = parse_args(["in=http", "out=torch", "--model-path", llama_ckpt,
                       "--device", "cpu", "--dtype", "int8", "--no-warmup"])
    engine, mdc, _ = build_engine(args)
    loaded = load_params(llama_ckpt, device="cpu", quant="int8")
    for k, v in loaded.items():
        if isinstance(v, QuantInt8):
            assert torch.equal(engine.params[k].q, v.q), k
            assert torch.equal(engine.params[k].s, v.s), k

    async def main():
        import aiohttp

        svc = await serve_http(engine, mdc, "127.0.0.1", 0)
        try:
            async with aiohttp.ClientSession() as http:
                async with http.post(
                        f"http://127.0.0.1:{svc.port}/v1/completions",
                        json={"model": mdc.name, "prompt": [5, 6, 7, 8],
                              "max_tokens": 5}) as r:
                    return r.status, await r.json()
        finally:
            await svc.stop()
            await engine.stop()

    status, body = asyncio.run(main())
    assert status == 200, json.dumps(body)
    assert body["choices"][0]["finish_reason"] == "length"
