"""The port's engine and serving chain against the JAX package's, on the
CPU at ModelConfig.tiny() in float32, with the same (bridged) weights:
greedy tokens through TorchEngine and JaxEngine must be identical (both
pipelined, the JAX default, and with pipeline_decode=False), and the
port's HTTP server must return the text the JAX LocalChatChain produces.
The pipeline's own rules: deferred page release, finishes on cancel and
stop, the carry merge, the warmed grid, the decode-graph buckets and the
capture fence. Plus the port's isolation (it imports neither jax nor
dynamo_tpu) and its refusal to fall back to the CPU."""

import asyncio
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.jax_engine import JaxEngine
from dynamo_tpu.engine.jax_engine import _merge_carry as jax_merge_carry
from dynamo_tpu.llm.engines import LocalChatChain as JaxChatChain
from dynamo_tpu.llm.model_card import ModelDeploymentCard as JaxCard
from dynamo_tpu.llm.protocols.common import (PreprocessedRequest as
                                             JaxRequest)
from dynamo_tpu.llm.protocols.common import StopConditions as JaxStop
from dynamo_tpu.llm.protocols.openai import (ChatCompletionRequest as
                                             JaxChatRequest)
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.jit_fence import PostWarmupCompileError
from dynamo_tpu_torch.engine.torch_engine import (EngineConfig, TorchEngine,
                                                  _merge_carry)
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                   StopConditions)
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.run import serve_http
from dynamo_tpu_torch.runtime.engine import Context

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ECFG = dict(page_size=8, num_pages=64, max_batch=4, prefill_chunk=16,
            prefill_buckets=(16,), batch_buckets=(1, 2, 4), page_buckets=(8,),
            decode_steps=4)


def _engines(**torch_ecfg):
    """(JaxEngine, TorchEngine) with the same weights; ``torch_ecfg``
    overrides the port's EngineConfig only."""
    jcfg, tcfg = JaxModelConfig.tiny(), ModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 jparams.items()}, tcfg, device="cpu")
    jeng = JaxEngine(jcfg, JaxEngineConfig(**ECFG), params=jparams)
    teng = TorchEngine(tcfg, EngineConfig(**{**ECFG, **torch_ecfg}),
                       params=tparams, device="cpu")
    return jeng, teng


PROMPTS = [list(range(1, 6)), list(range(30, 70)),  # > prefill_chunk
           list(range(100, 117)), [7, 7, 7]]


async def _generate_all(engine, request_cls, stop_cls, ctx_cls,
                        max_tokens=(9, 12, 10, 5), eos=None):
    async def one(p, n, delay):
        await asyncio.sleep(delay)
        req = request_cls(token_ids=list(p),
                          stop=stop_cls(max_tokens=n),
                          eos_token_ids=list(eos or []))
        toks, fin = [], None
        async for out in engine.generate(req, ctx_cls()):
            toks += out.token_ids
            fin = out.finish_reason or fin
        return toks, fin

    try:
        return await asyncio.gather(*[
            one(p, n, 0.01 * i) for i, (p, n) in
            enumerate(zip(PROMPTS, max_tokens))])
    finally:
        await engine.stop()


def test_greedy_tokens_match_jax_engine():
    """Concurrent greedy requests (one longer than prefill_chunk, so it
    prefills in two chunks): token-identical to JaxEngine."""
    jeng, teng = _engines()
    want = asyncio.run(_generate_all(jeng, JaxRequest, JaxStop, JaxContext))
    got = asyncio.run(_generate_all(teng, PreprocessedRequest,
                                    StopConditions, Context))
    assert got == want
    assert [len(t) for t, _ in got] == [9, 12, 10, 5]
    assert all(f == "length" for _, f in got)


def test_device_stop_matches_jax_engine():
    """A stop id the model actually samples ends the row on device with
    finish 'eos' in both engines, at the same token."""
    jeng, teng = _engines()
    free = asyncio.run(_generate_all(teng, PreprocessedRequest,
                                     StopConditions, Context))
    eos = [free[0][0][3]]
    jeng, teng = _engines()
    want = asyncio.run(_generate_all(jeng, JaxRequest, JaxStop, JaxContext,
                                     eos=eos))
    got = asyncio.run(_generate_all(teng, PreprocessedRequest,
                                    StopConditions, Context, eos=eos))
    assert got == want
    assert got[0][1] == "eos" and got[0][0][-1] == eos[0]


def test_preemption_resumes_token_identical(caplog):
    """A pool too small for every row forces preemption (the pipeline is
    flushed first, so 16 pages: at 20 the flush frees enough) + resume;
    the tokens still match an unconstrained run and the JAX engine's."""
    jeng, teng = _engines()
    want = asyncio.run(_generate_all(teng, PreprocessedRequest,
                                     StopConditions, Context,
                                     max_tokens=(20, 20, 20, 20)))
    tcfg = ModelConfig.tiny()
    small = TorchEngine(tcfg, EngineConfig(**{**ECFG, "num_pages": 16,
                                              "watermark_pages": 1}),
                        params=teng.params, device="cpu")
    with caplog.at_level("WARNING", logger="dynamo_tpu_torch.engine"):
        got = asyncio.run(_generate_all(small, PreprocessedRequest,
                                        StopConditions, Context,
                                        max_tokens=(20, 20, 20, 20)))
    assert got == want
    assert any("preempting" in r.getMessage() for r in caplog.records)
    jax_want = asyncio.run(_generate_all(jeng, JaxRequest, JaxStop,
                                         JaxContext,
                                         max_tokens=(20, 20, 20, 20)))
    assert got == jax_want


def test_warmup_writes_nothing_and_keeps_tokens():
    """warmup() runs padding rows only: the pools stay zero and later
    greedy tokens are unchanged."""
    _, teng = _engines()
    want = asyncio.run(_generate_all(teng, PreprocessedRequest,
                                     StopConditions, Context))
    _, teng = _engines()
    teng.warmup()
    assert not teng.kv_k.any() and not teng.kv_v.any()
    got = asyncio.run(_generate_all(teng, PreprocessedRequest,
                                    StopConditions, Context))
    assert got == want


@pytest.mark.parametrize("scenario", ["greedy", "device_stop",
                                      "preemption"])
def test_unpipelined_tokens_match_jax_engine(scenario):
    """pipeline_decode=False (each window read back before the next
    dispatch) gives the JAX engine's tokens in the greedy, device-stop
    and preemption scenarios."""
    jeng, teng = _engines(pipeline_decode=False)
    kw, eos = {}, None
    if scenario == "device_stop":
        # a stop id the model samples mid-run (as in the pipelined test)
        free = asyncio.run(_generate_all(_engines()[1], PreprocessedRequest,
                                         StopConditions, Context))
        eos = [free[0][0][3]]
    if scenario == "preemption":
        kw = dict(max_tokens=(20, 20, 20, 20))
        teng = TorchEngine(ModelConfig.tiny(), EngineConfig(**{
            **ECFG, "num_pages": 16, "watermark_pages": 1,
            "pipeline_decode": False}), params=teng.params, device="cpu")
    want = asyncio.run(_generate_all(jeng, JaxRequest, JaxStop, JaxContext,
                                     eos=eos, **kw))
    got = asyncio.run(_generate_all(teng, PreprocessedRequest,
                                    StopConditions, Context, eos=eos, **kw))
    assert got == want
    if scenario == "device_stop":
        assert got[0][1] == "eos" and got[0][0][-1] == eos[0]


@pytest.mark.parametrize("toggle", ["admit_in_step", "overlap_idle_prefill",
                                    "cache_sampler_params"])
def test_hot_path_toggles_keep_jax_tokens(toggle):
    """Each of the JAX engine's hot-path toggles, turned off in the port,
    moves where host work lands, never the tokens."""
    jeng, teng = _engines(**{toggle: False})
    want = asyncio.run(_generate_all(jeng, JaxRequest, JaxStop, JaxContext))
    got = asyncio.run(_generate_all(teng, PreprocessedRequest,
                                    StopConditions, Context))
    assert got == want


PREFIX = list(range(200, 220))  # 20 tokens: two full pages of 8


async def _stop_then_prefix_hit(engine, request_cls, stop_cls, ctx_cls):
    """Request A stops after 6 tokens (in its second decode window, so a
    third window holding it is in flight when the host learns of it);
    request B then continues A's prompt and tokens and hits A's pages."""
    async def run(tokens, n):
        req = request_cls(token_ids=list(tokens), stop=stop_cls(max_tokens=n),
                          eos_token_ids=[])
        toks, fin = [], None
        async for out in engine.generate(req, ctx_cls()):
            toks += out.token_ids
            fin = out.finish_reason or fin
        return toks, fin

    async def long_row():
        return await run([3, 1, 4, 1, 5], 24)

    try:
        other = asyncio.ensure_future(long_row())
        a = await run(PREFIX, 6)
        b = await run(PREFIX + a[0][:5], 7)
        c = await other
    finally:
        await engine.stop()
    return [a, b, c], engine.stats()["prefix_hit_tokens_total"]


def test_row_stopping_mid_pipeline_defers_release_and_prefix_hit():
    """A row that finishes in window N while window N+1 (holding it) is in
    flight: its pages are released, and its finish emitted, only once no
    window in flight holds it. A later request that prefix-hits those
    pages gets the JAX engine's tokens."""
    jeng, teng = _engines()
    deferred, early = [], []
    orig_defer, orig_release = teng._release_or_defer, teng._release

    def spy_defer(seq):
        if any(id(seq) in w.index for w in teng._inflight):
            deferred.append(seq)
        orig_defer(seq)

    def spy_release(seq):
        if seq.pages and any(id(seq) in w.index for w in teng._inflight):
            early.append(seq)
        orig_release(seq)

    teng._release_or_defer, teng._release = spy_defer, spy_release
    want, want_hits = asyncio.run(_stop_then_prefix_hit(
        jeng, JaxRequest, JaxStop, JaxContext))
    got, hits = asyncio.run(_stop_then_prefix_hit(
        teng, PreprocessedRequest, StopConditions, Context))
    assert got == want
    assert [f for _, f in got] == ["length"] * 3
    assert deferred and not early
    assert hits == want_hits and hits >= 16
    assert not teng._deferred_free and not teng._inflight


@pytest.mark.parametrize("pipeline", [True, False])
def test_cancel_and_stop_in_flight_finish_every_client(pipeline):
    """One request is cancelled while its windows are in flight, then
    stop() lands while the others still decode: every client's stream
    ends with a finish_reason, and nothing stays in flight."""
    _, teng = _engines(pipeline_decode=pipeline,
                       page_buckets=(8,), num_pages=64)
    ctxs = [Context() for _ in range(3)]
    stopper = []

    async def one(i):
        req = PreprocessedRequest(token_ids=[5 + i, 6, 7, 8, 9],
                                  stop=StopConditions(max_tokens=50),
                                  eos_token_ids=[])
        chunks, fin = 0, None
        async for out in teng.generate(req, ctxs[i]):
            chunks += bool(out.token_ids)
            if i == 0 and chunks == 2:
                ctxs[0].stop_generating()
            if i == 1 and chunks == 3 and not stopper:
                stopper.append(asyncio.ensure_future(teng.stop()))
            fin = out.finish_reason or fin
        return fin

    async def main():
        fins = await asyncio.wait_for(
            asyncio.gather(*[one(i) for i in range(3)]), 120)
        await stopper[0]
        return fins

    fins = asyncio.run(main())
    assert fins[0] == "cancelled"
    assert all(f in ("cancelled", "length") for f in fins[1:]), fins
    assert not teng._inflight and teng._pending_prefill is None
    assert not teng.running and not teng._deferred_free


def test_merge_carry_matches_jax():
    """The port's _merge_carry equals the JAX one on seeded random
    carries (out-of-range src clamps), returned or written in place."""
    rng = np.random.RandomState(8)
    for Bp, Bn in ((5, 7), (4, 4), (8, 2)):
        c = (rng.randint(0, 500, Bp), rng.randint(-1, 300, Bp),
             rng.rand(Bp) < 0.5, rng.randint(0, 40, Bp),
             rng.randint(0, 9, Bp))
        c = tuple(a.astype(bool if a.dtype == bool else np.int32) for a in c)
        src = rng.randint(-2, Bp + 2, Bn).astype(np.int32)
        fc = rng.rand(Bn) < 0.6
        n = tuple(rng.randint(-1, 100, Bn).astype(np.int32) for _ in range(4))
        want = jax_merge_carry(*c, src, fc, *n)
        t = [torch.from_numpy(np.asarray(a)) for a in (*c, src, fc, *n)]
        got = _merge_carry(*t)
        out = (torch.zeros(Bn, dtype=torch.int32),
               torch.zeros(Bn, dtype=torch.int32),
               torch.ones(Bn, dtype=torch.bool),
               torch.zeros(Bn, dtype=torch.int32),
               torch.zeros(Bn, dtype=torch.int32))
        _merge_carry(*t, out=out)
        for w, g, o in zip(want, got, out):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(o.numpy(), np.asarray(w))


@pytest.mark.parametrize("cfg", [
    {}, ECFG,
    # prefill_chunk above the largest prefill bucket, max_batch outside
    # the batch buckets, a pool smaller than the largest page bucket
    dict(prefill_chunk=1024, max_batch=48, num_pages=40),
    dict(page_size=16, prefill_chunk=96, prefill_buckets=(32,),
         batch_buckets=(3, 5), max_batch=7, max_prefill_batch=2,
         page_buckets=(2, 4), num_pages=300)])
def test_warmed_grid_matches_jax(cfg):
    assert EngineConfig(**cfg).warmed_grid() == \
        JaxEngineConfig(**cfg).warmed_grid()


def test_warmup_captures_the_decode_grid_and_serving_captures_none():
    """warmup() makes one decode bucket per (batch, page) of the warmed
    grid and arms the fence; serving then captures nothing. A bucket
    outside the grid counts in post_warmup_compiles_total, and raises
    under DYN_JIT_FENCE=raise."""
    _, teng = _engines()
    teng.warmup()
    grid = teng.ecfg.warmed_grid()
    assert set(teng.graphs.buckets) == {
        (B, P) for B in grid["decode_batches"] for P in grid["page_buckets"]}
    assert teng.fence.armed
    asyncio.run(_generate_all(teng, PreprocessedRequest, StopConditions,
                              Context))
    assert teng.stats()["post_warmup_compiles_total"] == 0
    teng.graphs.bucket(3, 8)
    assert teng.stats()["post_warmup_compiles_total"] == 1
    os.environ["DYN_JIT_FENCE"] = "raise"
    try:
        with pytest.raises(PostWarmupCompileError, match="B=2, P=16"):
            teng.graphs.bucket(2, 16)
    finally:
        del os.environ["DYN_JIT_FENCE"]
    assert teng.stats()["post_warmup_compiles_total"] == 2
    assert (2, 16) not in teng.graphs.buckets


def test_decode_buckets_pad_rows_and_copy_out():
    """Three running rows take the batch bucket of 4: the fourth row of
    the static inputs is padding (position -1, page table 0). Each
    window's host copy, read one iteration later, holds what its launch
    left in the static outputs, though later launches overwrite them."""
    _, teng = _engines()
    launched, read = [], []
    orig_launch, orig_process = teng.graphs.launch, teng._process_window

    def spy_launch(bk):
        orig_launch(bk)
        launched.append((bk.B, bk.P, bk.pos.clone(), bk.table.clone(),
                         bk.toks.clone(), bk.emitted.clone()))

    def spy_process(pend):
        if not pend.processed:
            read.append((pend.host[0].clone(), pend.host[1].clone()))
        orig_process(pend)

    teng.graphs.launch, teng._process_window = spy_launch, spy_process
    asyncio.run(_generate_all(teng, PreprocessedRequest, StopConditions,
                              Context, max_tokens=(9, 12, 10)))
    three = [x for x in launched if int((x[2] >= 0).sum()) == 3]
    assert three and all(B == 4 and P == 8 for B, P, *_ in three)
    for _, _, pos, table, _, _ in three:
        assert int(pos[3]) == -1 and not table[3].any()
    assert len(read) == len(launched) >= 3
    for (toks, n), x in zip(read, launched):
        assert torch.equal(toks, x[4]) and torch.equal(n, x[5])


def test_warmup_captures_the_prefill_grid_and_a_miss_counts():
    """warmup() makes one prefill bucket per (prefill batch, chunk length,
    page) of the warmed grid, in the serving form of its length (page
    commit when a multiple of the page size), as the JAX engine warms it;
    serving captures none. A chunk outside the grid (another form) is
    captured on the spot and counts in post_warmup_compiles_total, and
    raises under DYN_JIT_FENCE=raise."""
    _, teng = _engines(prefill_buckets=(4, 16), page_buckets=(4, 8))
    teng.warmup()
    grid = teng.ecfg.warmed_grid()
    assert set(teng.prefill_graphs.buckets) == {
        (B, T, P, T % 8 == 0) for B in grid["prefill_batches"]
        for T in grid["prefill_lens"] for P in grid["page_buckets"]}
    assert (1, 4, 8, False) in teng.prefill_graphs.buckets
    asyncio.run(_generate_all(teng, PreprocessedRequest, StopConditions,
                              Context))
    assert teng.stats()["post_warmup_compiles_total"] == 0
    teng.prefill_graphs.bucket(1, 16, 8, False)
    assert teng.stats()["post_warmup_compiles_total"] == 1
    os.environ["DYN_JIT_FENCE"] = "raise"
    try:
        with pytest.raises(PostWarmupCompileError,
                           match="B=4, T=16, P=8, row scatter"):
            teng.prefill_graphs.bucket(4, 16, 8, False)
    finally:
        del os.environ["DYN_JIT_FENCE"]
    assert (4, 16, 8, False) not in teng.prefill_graphs.buckets


def test_prefill_bucket_packs_every_input_in_one_buffer():
    """A prefill bucket's inputs are views of one int32 buffer: a blank
    host image holds padding rows (position -1, dropped slots and pages,
    greedy sampler), and one upload of a filled image sets every view to
    the host values, dtypes included."""
    from dynamo_tpu_torch.engine.cuda_graphs import upload
    from dynamo_tpu_torch.models.llama import DROP_SLOT

    _, teng = _engines()
    bk = teng.prefill_graphs.bucket(4, 16, 8, True)
    img, f = bk.host_inputs()
    assert (f["positions"] == -1).all() and (f["slots"] == DROP_SLOT).all()
    assert (f["pslots"] == 64).all() and (f["top_p"] == 1.0).all()
    assert f["pslots"].shape == (4, 2) and f["seeds"].dtype == np.int64
    rng = np.random.RandomState(0)
    for name, a in f.items():
        a[...] = (rng.rand(*a.shape) if a.dtype == np.float32 else
                  rng.randint(-5, 1 << 20, a.shape))
    f["seeds"][0] = (1 << 40) + 3
    upload(bk.packed, img)
    for name, a in f.items():
        got = bk.inputs[name]
        assert got.shape == a.shape and got.numpy().dtype == a.dtype, name
        np.testing.assert_array_equal(got.numpy(), a)
    a, b = bk.spans["positions"][:2]
    assert (bk.blank[a:b] == -1).all()  # each image is a fresh copy


def test_graph_pool_bytes_count_the_pools_own_segments(monkeypatch):
    """The graph-pool figure sums the allocator segments of the graph
    pool on the engine's device only: blocks the eager warm calls leave
    cached in the default pool, and other pools or devices, do not
    count."""
    from dynamo_tpu_torch.engine import cuda_graphs

    segments = [
        {"device": 0, "segment_pool_id": (0, 0), "total_size": 1 << 30},
        {"device": 0, "segment_pool_id": (7, 2), "total_size": 3 << 20},
        {"device": 0, "segment_pool_id": [7, 2], "total_size": 2 << 20},
        {"device": 1, "segment_pool_id": (7, 2), "total_size": 5 << 20},
        {"device": 0, "segment_pool_id": (8, 2), "total_size": 9 << 20},
    ]
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: segments)
    got = cuda_graphs.pool_segment_bytes((7, 2), torch.device("cuda", 0))
    assert got == 5 << 20


def test_prefill_graphs_match_jax_engine_at_every_chunk_length():
    """Prompts of mixed lengths through the prefill graphs, hitting chunk
    lengths 16 (row scatter: shorter than a page), 64 and 512 (page
    commit) and a prompt of two chunks: greedy tokens identical to
    JaxEngine's."""
    cfg = dict(page_size=32, num_pages=96, max_batch=8, prefill_chunk=512,
               prefill_buckets=(16, 64, 512), batch_buckets=(1, 2, 4, 8),
               page_buckets=(8, 32), decode_steps=4)
    jcfg, tcfg = JaxModelConfig.tiny(), ModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(5))
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 jparams.items()}, tcfg, device="cpu")
    jeng = JaxEngine(jcfg, JaxEngineConfig(**cfg), params=jparams)
    teng = TorchEngine(tcfg, EngineConfig(**cfg), params=tparams,
                       device="cpu")
    keys = []
    launch = teng.prefill_graphs.launch

    def spy(bk):
        keys.append(bk.key)
        launch(bk)

    teng.prefill_graphs.launch = spy
    rng = np.random.RandomState(4)
    prompts = [list(rng.randint(1, 500, n)) for n in (9, 50, 300, 600)]

    async def run(engine, req_cls, stop_cls, ctx_cls):
        async def one(p, delay):
            await asyncio.sleep(delay)
            req = req_cls(token_ids=[int(t) for t in p],
                          stop=stop_cls(max_tokens=6))
            toks = []
            async for out in engine.generate(req, ctx_cls()):
                toks += out.token_ids
            return toks

        try:
            return await asyncio.gather(*[
                one(p, 0.05 * i) for i, p in enumerate(prompts)])
        finally:
            await engine.stop()

    want = asyncio.run(run(jeng, JaxRequest, JaxStop, JaxContext))
    got = asyncio.run(run(teng, PreprocessedRequest, StopConditions,
                          Context))
    assert got == want and all(len(t) == 6 for t in got)
    assert {T for _, T, _, _ in keys} == {16, 64, 512}
    assert {(T, paged) for _, T, _, paged in keys} >= {
        (16, False), (64, True), (512, True)}


def test_model_path_is_refused(tmp_path, capsys):
    """--model-path is served now (tests/test_torch_golden_checkpoint.py),
    but a path that holds no weights is still refused, before any work,
    instead of serving random weights under the checkpoint's name."""
    from dynamo_tpu_torch.run import build_engine, parse_args

    (tmp_path / "config.json").write_text(json.dumps(
        {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
         "num_hidden_layers": 2, "num_attention_heads": 4}))
    args = parse_args(["in=http", "out=torch", "--model-path", str(tmp_path),
                       "--device", "cpu"])
    assert args.model_path == str(tmp_path)
    with pytest.raises(FileNotFoundError, match="no safetensors"):
        build_engine(args)
    with pytest.raises(FileNotFoundError, match="config.json"):
        build_engine(parse_args(["in=http", "out=torch", "--model-path",
                                 str(tmp_path / "missing"),
                                 "--device", "cpu"]))
    assert parse_args(["in=http", "out=torch", "--model", "8b"]).model == "8b"


@pytest.mark.parametrize("fields,served", [
    ({"repetition_penalty": 1.0}, True),
    ({"frequency_penalty": 0, "presence_penalty": 0.0}, True),
    ({"logit_bias": {}, "logprobs": False, "top_logprobs": 0}, True),
    ({"repetition_penalty": 1.2}, False),
    ({"presence_penalty": 0.5}, False),
    ({"frequency_penalty": -0.1}, False),
    ({"logit_bias": {"5": 10}}, False),
    ({"logprobs": True}, False),
])
def test_neutral_sampling_values_are_served(fields, served):
    """Penalty, bias and logprob fields are no longer refused as
    unsupported: the port's preprocessor gives what the JAX package's
    gives. ``served`` marks the cases at their neutral value (as the JAX
    package's SamplingBatch.build maps it), which ask for nothing: the
    neutral sampler and no logprobs. One of them, top_logprobs without
    logprobs=true, is a 400 under the JAX package's OpenAI validation,
    on both sides."""
    from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as JaxPre
    from dynamo_tpu_torch.engine.sampling import SamplingBatch
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest

    pre = OpenAIPreprocessor(ModelDeploymentCard(name="tiny"))
    req = ChatCompletionRequest(**{**_chat_body(False), **fields})
    if "top_logprobs" in fields and fields.get("logprobs") is not True:
        for p in (pre, JaxPre(JaxCard(name="tiny"))):
            with pytest.raises(ValueError, match="requires logprobs"):
                p.preprocess_chat(req)
        return
    got = pre.preprocess_chat(req)[0]
    assert got.token_ids
    sb = SamplingBatch.build([got.sampling], 1)
    neutral = (not sb.has_penalties and not got.sampling.logit_bias
               and got.output.logprobs is None)
    assert neutral == served
    want = JaxPre(JaxCard(name="tiny")).preprocess_chat(
        JaxChatRequest(**{**_chat_body(False), **fields}))[0]
    assert got.sampling.to_dict() == want.sampling.to_dict()
    assert got.output.logprobs == want.output.logprobs


def test_stop_ids_are_built_once_per_sequence():
    """The eos/stop ids a sequence checks every token are built on first
    use and reused, as the JAX engine caches them."""
    from dynamo_tpu_torch.engine.torch_engine import Sequence

    req = PreprocessedRequest(token_ids=[1, 2],
                              stop=StopConditions(stop_token_ids=[9, 4]),
                              eos_token_ids=[4, 7])
    seq = Sequence(req=req, context=Context(), out=None, tokens=[1, 2],
                   num_prompt=2)
    assert seq.stop_set is seq.stop_set
    assert seq.stop_ids is seq.stop_ids
    assert seq.stop_set == {4, 7, 9} and seq.stop_ids == [4, 7, 9, 4]
    req.stop.ignore_eos = True
    ignoring = Sequence(req=req, context=Context(), out=None, tokens=[1],
                        num_prompt=1)
    assert ignoring.stop_set == {9, 4} and ignoring.stop_ids == [9, 4]


def test_stats_keys_are_jax_engine_keys():
    jeng, teng = _engines()
    assert set(teng.stats()) <= set(jeng.stats())
    assert {"latency_hist", "bucket_cost", "device_time_fraction",
            "profiled_steps_total", "memory"} <= set(teng.stats())


def _chat_body(stream: bool):
    return {"model": "tiny", "stream": stream, "max_tokens": 12,
            "messages": [{"role": "user", "content": "hello there"}]}


async def _jax_chat_text(engine) -> str:
    chain = JaxChatChain(JaxCard(name="tiny"), engine)
    text = []
    try:
        async for chunk in chain(JaxChatRequest(**_chat_body(True)),
                                 JaxContext()):
            for c in chunk.model_dump(exclude_none=True).get("choices", []):
                text.append((c.get("delta") or {}).get("content") or "")
    finally:
        await engine.stop()
    return "".join(text)


async def _http_round_trip(engine):
    import aiohttp

    svc = await serve_http(engine, ModelDeploymentCard(name="tiny"),
                           "127.0.0.1", 0)
    base = f"http://127.0.0.1:{svc.port}"
    try:
        async with aiohttp.ClientSession() as s:
            async with s.get(f"{base}/health") as r:
                assert r.status == 200
            async with s.get(f"{base}/v1/models") as r:
                assert [m["id"] for m in (await r.json())["data"]] == ["tiny"]
            async with s.post(f"{base}/v1/chat/completions",
                              json=_chat_body(False)) as r:
                assert r.status == 200
                unary = await r.json()
            chunks = []
            async with s.post(f"{base}/v1/chat/completions",
                              json=_chat_body(True)) as r:
                assert r.headers["Content-Type"].startswith(
                    "text/event-stream")
                async for line in r.content:
                    line = line.decode().strip()
                    if line.startswith("data: "):
                        chunks.append(line[6:])
            async with s.post(f"{base}/v1/completions", json={
                    "model": "tiny", "prompt": "abc",
                    "max_tokens": 4}) as r:
                completion = await r.json()
            async with s.post(f"{base}/v1/chat/completions", json={
                    "model": "nope", "messages": []}) as r:
                missing = r.status
            async with s.post(f"{base}/v1/chat/completions", json={
                    **_chat_body(False), "top_logprobs": 2}) as r:
                unsupported = r.status
    finally:
        await svc.stop()
        await engine.stop()
    return unary, chunks, completion, missing, unsupported


def test_http_round_trip_matches_jax_chat_chain():
    jeng, teng = _engines()
    want = asyncio.run(_jax_chat_text(jeng))
    unary, chunks, completion, missing, unsupported = asyncio.run(
        _http_round_trip(teng))
    assert unary["object"] == "chat.completion"
    assert unary["choices"][0]["message"]["content"] == want
    assert unary["choices"][0]["finish_reason"] == "length"
    assert chunks[-1] == "[DONE]"
    parsed = [json.loads(c) for c in chunks[:-1]]
    assert all(p["object"] == "chat.completion.chunk" for p in parsed)
    streamed = "".join((c["delta"].get("content") or "")
                       for p in parsed for c in p["choices"])
    assert streamed == want
    assert completion["object"] == "text_completion"
    assert completion["choices"][0]["finish_reason"] == "length"
    assert missing == 404 and unsupported == 400


def test_port_imports_neither_jax_nor_dynamo_tpu():
    """Importing every module of the port (the weights loader and the
    sampler included) and chip_smoke.py pulls in no jax, no dynamo_tpu
    module and no safetensors (the loader reads the format itself)."""
    code = """
import importlib, pkgutil, sys
import dynamo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dynamo_tpu_torch.__path__,
                                               "dynamo_tpu_torch.")]
for n in names + ["chip_smoke"]:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "dynamo_tpu" or m.startswith("dynamo_tpu.")
             or m == "safetensors" or m.startswith("safetensors."))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 20, names
assert {"dynamo_tpu_torch.models.loader",
        "dynamo_tpu_torch.engine.sampling",
        "dynamo_tpu_torch.models.mla",
        "dynamo_tpu_torch.models.registry",
        "dynamo_tpu_torch.models.hub",
        "dynamo_tpu_torch.runtime.tracing",
        "dynamo_tpu_torch.runtime.logging",
        "dynamo_tpu_torch.runtime.profiling",
        "dynamo_tpu_torch.runtime.blackbox",
        "dynamo_tpu_torch.runtime.revive",
        "dynamo_tpu_torch.llm.http.metrics"} <= set(names), names
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_raises_without_gpu():
    """Entry points default to CUDA and never carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from dynamo_tpu_torch.models.llama import KVCacheSpec, init_kv_cache
    from dynamo_tpu_torch.run import build_engine, parse_args

    cfg = ModelConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        TorchEngine(cfg, EngineConfig(**ECFG))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        init_kv_cache(cfg, KVCacheSpec(4, 8))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        params_from_numpy({}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        build_engine(parse_args(["in=http", "out=torch", "--model", "tiny"]))
