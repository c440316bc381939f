"""The port's mid-stream failover and graceful drain
(``dynamo_tpu_torch/runtime/revive.py``, the processor's resume loop, the
worker's SIGTERM), on the CPU, against the reference's cases
(``tests/test_revive.py``).

The journal and the session against the reference's on the same inputs;
a ``worker.kill`` rule turns a served handle into a wedged process; a
worker killed mid-decode behind the port's KV router, Processor and HTTP
service leaves a greedy SSE stream that completes on its sibling with
the tokens of an unfaulted control, no error chunk, ``resumed_attempts``
on the finish's cost block, an empty journal and no capture after warmup
on the survivor, under ``DYN_PROTO_VALIDATE=1``; the same with a JAX
worker as the one that dies and a port worker as the survivor (the JAX
package's weights through ``params_from_numpy``); the drain finishes the
stream in flight and refuses new work typed, and a SIGTERM'd launcher
worker does the same as a process. Tiny float32 engines; every await of
a remote event is bounded.
"""

import asyncio
import json
import os
import random
import signal
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from dynamo_tpu.runtime import guard as ref_guard
from dynamo_tpu.runtime import revive as ref_revive
from dynamo_tpu_torch.runtime import guard, profiling, revive
from dynamo_tpu_torch.runtime.engine import Context
from torch_dcp_wait import wait_for_dcp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT = 30.0  # seconds: the bound on every await of a remote event
PS = 8
ECFG = dict(page_size=PS, num_pages=64, max_batch=4, prefill_chunk=32,
            batch_buckets=(1, 2, 4), prefill_buckets=(8, 32),
            page_buckets=(8,), watermark_pages=2, decode_steps=2)


@pytest.fixture(autouse=True)
def _fresh_revive():
    """Chaos and the failover journal never leak between tests."""
    for mod in (guard, ref_guard):
        mod.set_chaos(None)
    revive.reset_journal()
    yield
    for mod in (guard, ref_guard):
        mod.set_chaos(None)
    revive.reset_journal()


# ------------------------------------------------------------------ journal


def test_journal_open_record_close_and_bound():
    ring = revive.ReviveJournal(capacity=4, max_tokens=6)
    e = ring.open("r1", prompt_tokens=10)
    e.record([1, 2, 3])
    e.record([4, 5])
    assert e.tokens == [1, 2, 3, 4, 5] and e.resumable
    # overflowing the bound marks non-resumable instead of truncating
    e.record([6, 7])
    assert e.tokens == [1, 2, 3, 4, 5] and not e.resumable
    assert len(ring) == 1
    ring.close("r1")
    assert len(ring) == 0 and ring.get("r1") is None


def test_journal_ring_eviction_costs_resumability_only():
    ring = revive.ReviveJournal(capacity=2, max_tokens=100)
    a = ring.open("a", 1)
    ring.open("b", 1)
    ring.open("c", 1)  # evicts a
    assert len(ring) == 2 and ring.get("a") is None
    assert not a.resumable
    assert ring.evicted_total == 1
    snap = ring.snapshot()
    assert snap["inflight"] == 2 and snap["opened_total"] == 3


def test_journal_reads_its_bounds_from_env(monkeypatch):
    monkeypatch.setenv("DYN_REVIVE_RING", "7")
    monkeypatch.setenv("DYN_REVIVE_JOURNAL_TOKENS", "11")
    monkeypatch.setenv("DYN_REVIVE_MAX", "3")
    ring = revive.reset_journal()
    assert (ring.capacity, ring.max_tokens) == (7, 11)
    assert revive.max_resumes() == 3
    assert ring.snapshot() == ref_revive.ReviveJournal().snapshot()


# ------------------------------------------------------------------ session


def _pre(tokens, max_tokens=8, min_tokens=None, echo=False, pkg=None):
    if pkg == "ref":
        from dynamo_tpu.llm.protocols import common
    else:
        from dynamo_tpu_torch.llm.protocols import common
    return common.PreprocessedRequest(
        token_ids=list(tokens), sampling=common.SamplingOptions(),
        stop=common.StopConditions(max_tokens=max_tokens,
                                   min_tokens=min_tokens),
        output=common.OutputOptions(echo_prompt=echo))


def _out(ids, finish=None, pkg=None):
    if pkg == "ref":
        from dynamo_tpu.llm.protocols.common import EngineOutput
    else:
        from dynamo_tpu_torch.llm.protocols.common import EngineOutput
    return EngineOutput(token_ids=list(ids), finish_reason=finish)


def test_session_resume_request_dedupes_overlap():
    """The resume prompt is prompt + emitted with the stop budget
    decremented and echo cleared: the overlap dedupe that makes greedy
    resumes token-identical."""
    s = revive.ReviveSession(_pre([1, 2, 3], max_tokens=8, min_tokens=4,
                                  echo=True), Context("rid-1"), limit=2)
    s.observe(_out([10, 11]))
    s.observe(_out([12]))
    r = s.resume_request()
    assert r.token_ids == [1, 2, 3, 10, 11, 12]
    assert r.stop.max_tokens == 5            # 8 - 3 emitted
    assert r.stop.min_tokens == 1            # 4 - 3 emitted
    assert r.output.echo_prompt is False     # echo already streamed once
    assert s.base.token_ids == [1, 2, 3]
    assert s.base.stop.max_tokens == 8 and s.base.output.echo_prompt
    s.close()


@pytest.mark.parametrize("case", [
    ([1, 2, 3], 8, 4, True, [[10, 11], [12]]),
    ([5], None, None, False, [[7], [8, 9, 10]]),
    (list(range(40)), 12, 0, False, [[1] * 5, [2] * 6]),
    ([9, 9], 3, 5, True, [[4]]),
])
def test_session_resume_request_equals_reference(case):
    """The same observed chunks give the reference's resume request,
    field for field."""
    prompt, mt, mnt, echo, chunks = case
    mine = revive.ReviveSession(_pre(prompt, mt, mnt, echo),
                                Context("eq"), limit=2,
                                ring=revive.ReviveJournal())
    from dynamo_tpu.runtime.engine import Context as RefContext

    theirs = ref_revive.ReviveSession(_pre(prompt, mt, mnt, echo, "ref"),
                                      RefContext("eq"), limit=2,
                                      ring=ref_revive.ReviveJournal())
    for c in chunks:
        mine.observe(_out(c))
        theirs.observe(_out(c, pkg="ref"))
    assert mine.resume_request().to_dict() == \
        theirs.resume_request().to_dict()
    assert mine.budget_spent() == theirs.budget_spent()
    assert mine.synthetic_finish().to_dict() == \
        theirs.synthetic_finish().to_dict()


def test_session_should_resume_matrix():
    s = revive.ReviveSession(_pre([1], max_tokens=8), Context("rid-2"),
                             limit=1)
    assert s.should_resume(RuntimeError("worker died"))
    assert s.should_resume(ConnectionResetError("severed"))
    # typed budget / capacity / client errors never resume
    assert not s.should_resume(guard.DeadlineExceeded("spent"))
    assert not s.should_resume(guard.NoCapacity("all broken"))
    assert not s.should_resume(ValueError("bad request"))
    # a finished stream never resumes
    s.observe(_out([5], finish="stop"))
    assert not s.should_resume(RuntimeError("late failure"))
    s.close()

    s2 = revive.ReviveSession(_pre([1], max_tokens=8), Context("rid-3"),
                              limit=1)
    s2.mark_resume()
    assert not s2.should_resume(RuntimeError("x"))  # limit spent
    s2.close()

    ctx3 = Context("rid-4")
    s3 = revive.ReviveSession(_pre([1], max_tokens=8), ctx3, limit=2)
    ctx3.kill()  # client gone: nothing to save
    assert not s3.should_resume(RuntimeError("x"))
    s3.close()


def test_session_budget_spent_synthesizes_length_finish():
    """The worker died between the last budgeted token and its finish
    chunk: the session synthesizes the lost finish instead of a
    zero-token resume."""
    s = revive.ReviveSession(_pre([1, 2], max_tokens=3), Context("rid-5"),
                             limit=2)
    s.observe(_out([7, 8, 9]))
    assert s.budget_spent()
    fin = s.synthetic_finish()
    assert fin.finish_reason == "length"
    assert fin.completion_tokens == 3 and fin.prompt_tokens == 2
    s.close()


def test_mark_resume_trips_the_failover_trigger():
    """A resume counts and trips the flight recorder's failover_resume
    trigger (the recorder the port's service arms)."""
    from dynamo_tpu_torch.runtime import blackbox

    rec = blackbox.configure(window_s=30.0, cooldown_s=0.0)
    try:
        before = guard.counter_value("dyn_revive_resumes_total")
        s = revive.ReviveSession(_pre([1], max_tokens=8), Context("rid-6"),
                                 limit=2)
        s.mark_resume()
        assert guard.counter_value("dyn_revive_resumes_total") == before + 1
        assert revive.journal().resumed_total == 1
        (inc,) = rec.incidents_summary()
        assert inc["trigger"] == "failover_resume"
        s.close()
    finally:
        blackbox.reset()


# --------------------------------------------- worker.kill on an endpoint


def test_worker_kill_makes_handle_a_wedged_process(run_async):
    """A fired worker.kill rule: the client sees a raw connection drop
    (typed, fast), the discovery record and lease stay behind, the stats
    plane answers errors: the crashed-but-leased shape."""

    async def main():
        from dynamo_tpu_torch.runtime.component import instance_key
        from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

        drt = await DistributedRuntime.detached()
        try:
            async def handler(request, ctx):
                for i in range(50):
                    yield {"i": i}
                    await asyncio.sleep(0.005)

            ep = drt.namespace("kill").component("w").endpoint("gen")
            handle = await ep.serve(handler)
            client = await ep.client()
            guard.set_chaos("seed=9;sever:worker.kill@nth=3")
            stream = await client.round_robin({"x": 1})
            got = []
            t0 = time.monotonic()
            with pytest.raises(RuntimeError, match="disconnected"):
                async for env in stream:
                    got.append(env.data)
            assert time.monotonic() - t0 < 10.0
            assert len(got) == 2                  # died under frame 3
            assert handle._dead
            key = instance_key("kill", "w", "gen",
                               handle.instance.instance_id)
            assert await drt.dcp.kv_get(key) is not None
            with pytest.raises(Exception):
                await drt.dcp.request(
                    f"stats.{handle.instance.subject}", b"", timeout=2.0)
            await handle.stop()
            await client.close()
        finally:
            await drt.shutdown()

    run_async(main())


# ------------------------------------------ the failover, end to end


def tiny(cls):
    # the byte tokenizer's ids (BOS 256, EOS 257) lie inside the vocab
    return cls.tiny(num_heads=4, num_kv_heads=2, head_dim=8,
                    hidden_size=32, vocab_size=300)


def make_params(seed):
    from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
    from dynamo_tpu.models.llama import init_params as jax_init_params
    from dynamo_tpu_torch.models.bridge import params_from_numpy
    from dynamo_tpu_torch.models.config import ModelConfig

    jparams = jax_init_params(tiny(JaxModelConfig), jax.random.PRNGKey(seed))
    return jparams, params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, tiny(ModelConfig),
        device="cpu")


def port_engine(tparams, warm=True):
    from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.models.config import ModelConfig

    eng = TorchEngine(tiny(ModelConfig), EngineConfig(**ECFG),
                      params=tparams, device="cpu")
    if warm:
        eng.warmup()
    return eng


def jax_engine(jparams):
    from dynamo_tpu.engine.jax_engine import EngineConfig, JaxEngine
    from dynamo_tpu.models.config import ModelConfig as JaxModelConfig

    return JaxEngine(tiny(JaxModelConfig), EngineConfig(**ECFG),
                     params=jparams)


async def collect(engine, req, ctx):
    toks = []

    async def run():
        async for out in engine.generate(req, ctx):
            toks.extend(out.token_ids)
            if out.finish_reason is not None:
                return out.finish_reason

    return toks, await asyncio.wait_for(run(), LIMIT)


def control_request(tokens, n, pkg=None):
    if pkg == "ref":
        from dynamo_tpu.llm.protocols.common import (PreprocessedRequest,
                                                     StopConditions)
    else:
        from dynamo_tpu_torch.llm.protocols.common import (
            PreprocessedRequest, StopConditions)
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    return PreprocessedRequest(token_ids=list(tokens),
                               stop=StopConditions(max_tokens=n),
                               eos_token_ids=[ByteTokenizer.EOS])


async def sse_completion(port, rid, prompt, n):
    """One streaming completion: its texts, finishes and whether an
    error event came."""
    import aiohttp

    text, finishes, saw_error = [], [], False
    async with aiohttp.ClientSession() as http:
        async with http.post(
                f"http://127.0.0.1:{port}/v1/completions",
                json={"model": "m", "prompt": prompt, "stream": True,
                      "max_tokens": n},
                headers={"X-Request-Id": rid}) as resp:
            assert resp.status == 200
            async for raw in resp.content:
                line = raw.strip()
                if line == b"data: [DONE]":
                    break
                if line.startswith(b"event: error"):
                    saw_error = True
                if not line.startswith(b"data: "):
                    continue
                for c in json.loads(line[6:]).get("choices", []):
                    text.append(c.get("text") or "")
                    if c.get("finish_reason"):
                        finishes.append(c["finish_reason"])
        async with http.get(
                f"http://127.0.0.1:{port}/v1/traces/{rid}") as tresp:
            trace = await tresp.json()
    return "".join(text), finishes, saw_error, trace


def observed_tokens(monkeypatch):
    """Request id -> the token ids the processor's session observed, in
    order, with the resume count at each chunk."""
    seen = {}
    real = revive.ReviveSession.observe

    def observe(self, out):
        seen.setdefault(self.entry.request_id, []).append(
            (self.resumes, list(out.token_ids or [])))
        return real(self, out)

    monkeypatch.setattr(revive.ReviveSession, "observe", observe)
    return seen


async def _front(drt, mdc, namespace):
    from dynamo_tpu_torch.llm.http.service import HttpService
    from dynamo_tpu_torch.llm.kv_router.router import KvRouter
    from dynamo_tpu_torch.llm.processor import Processor

    kvr = KvRouter(drt, namespace, "w", block_size=PS, seed=0)
    await kvr.start(run_loop=False)
    await kvr.scrape_once()
    client = await drt.namespace(namespace).component("w") \
        .endpoint("generate_tokens").client()
    service = HttpService()
    service.manager.add_completions_model(
        "m", Processor(mdc, client, kvr).completion)
    await service.start(host="127.0.0.1", port=0)
    return kvr, client, service


PROMPT = "resume me please now!!!"   # BOS + 23 bytes = 3 pages
MAX_TOKENS = 12


def test_worker_kill_mid_decode_resumes_token_identical(run_async,
                                                        monkeypatch):
    """worker.kill mid-decode on two port replicas: the client's greedy
    SSE stream completes token-identical to an unfaulted control (which
    is JaxEngine's on the same weights), no error chunk, one resume
    named on the finish's cost block, no journal entry left, no capture
    after warmup on the survivor, the route fallback counter unchanged,
    the dead engine's pages freed; every proto anchor validated."""
    monkeypatch.setenv("DYN_PROTO_VALIDATE", "1")
    seen = observed_tokens(monkeypatch)

    async def main():
        from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
        from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
        from dynamo_tpu_torch.llm.worker import serve_token_model
        from dynamo_tpu_torch.runtime.runtime import DistributedRuntime
        from dynamo_tpu.runtime.engine import Context as RefContext

        jparams, tparams = make_params(11)
        tokens = ByteTokenizer().encode(PROMPT)
        jeng = jax_engine(jparams)
        want, _ = await collect(jeng, control_request(tokens, MAX_TOKENS,
                                                      "ref"),
                                RefContext("ctrl"))
        await jeng.stop()

        drt = await DistributedRuntime.detached()
        drt2 = await DistributedRuntime.attach(drt.dcp.address)
        service = None
        try:
            eng_a, eng_b = port_engine(tparams), port_engine(tparams)
            # both replicas hold the prompt's pages: whichever survives
            # has the warm prefix the resume should hit
            for i, e in enumerate((eng_a, eng_b)):
                got, _ = await collect(
                    e, control_request(tokens, MAX_TOKENS), Context(f"w{i}"))
                assert got == want
            mdc = ModelDeploymentCard(name="m", tokenizer_kind="byte",
                                      kv_block_size=PS,
                                      model_type="completions")
            h_a, pub_a = await serve_token_model(
                drt, mdc, eng_a, namespace="rev", component="w")
            h_b, pub_b = await serve_token_model(
                drt2, mdc, eng_b, namespace="rev", component="w")
            await pub_a.flush()
            await pub_b.flush()
            kvr, client, service = await _front(drt, mdc, "rev")
            fallback0 = sum(
                guard.counter_value("dyn_llm_route_fallback_total",
                                    reason=r)
                for r in ("RuntimeError", "NoRespondersError",
                          "SchedulerSaturated"))
            guard.set_chaos("seed=3;sever:worker.kill@nth=3")
            rid = "revive-e2e-1"
            text, finishes, saw_error, trace = await asyncio.wait_for(
                sse_completion(service.port, rid, PROMPT, MAX_TOKENS), LIMIT)
            guard.set_chaos(None)

            dead = [h for h in (h_a, h_b) if h._dead]
            assert len(dead) == 1, "chaos should kill exactly one"
            survivor, gone = (eng_b, eng_a) if dead[0] is h_a \
                else (eng_a, eng_b)
            assert not saw_error
            delivered = [t for _, ids in seen[rid] for t in ids]
            assert delivered == want
            assert text == ByteTokenizer().decode(want)
            assert finishes and finishes[-1] == "length"
            assert {r for r, _ in seen[rid]} == {0, 1}
            assert revive.journal().resumed_total == 1
            assert len(revive.journal()) == 0
            assert survivor.stats()["post_warmup_compiles_total"] == 0
            cost = profiling.request_attribution(rid)
            assert cost is not None and cost["resumed_attempts"] == 1
            assert trace["cost"]["resumed_attempts"] == 1
            # the resume's prefix was warm on the survivor
            assert cost["device_hit_blocks"] > 0
            assert sum(
                guard.counter_value("dyn_llm_route_fallback_total",
                                    reason=r)
                for r in ("RuntimeError", "NoRespondersError",
                          "SchedulerSaturated")) == fallback0
            t0 = time.monotonic()
            while gone.stats()["kv_active_blocks"] != 0:
                assert time.monotonic() - t0 < 10.0
                await asyncio.sleep(0.02)

            await kvr.stop()
            await client.close()
            for pub in (pub_a, pub_b):
                await pub.stop()
            for h in (h_a, h_b):
                await h.stop()
            await eng_a.stop()
            await eng_b.stop()
        finally:
            if service is not None:
                await service.stop()
            await drt2.shutdown()
            await drt.shutdown()

    run_async(main())


def test_jax_worker_killed_mid_stream_resumes_on_port_worker(
        run_async, monkeypatch):
    """Across packages: a JAX worker (the reference's serve_token_model
    and JaxEngine) killed mid-decode by the JAX package's worker.kill rule
    behind the port's Processor; the stream resumes on a port worker with
    the same weights and completes with the JAX control's tokens, no
    error chunk, resumed_attempts 1, an empty journal and no capture
    after warmup on the port survivor."""
    seen = observed_tokens(monkeypatch)

    async def main():
        from dynamo_tpu.llm.model_card import \
            ModelDeploymentCard as RefCard
        from dynamo_tpu.llm.worker import \
            serve_token_model as ref_serve_token_model
        from dynamo_tpu.runtime.engine import Context as RefContext
        from dynamo_tpu.runtime.runtime import \
            DistributedRuntime as RefRuntime
        from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
        from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
        from dynamo_tpu_torch.llm.worker import serve_token_model
        from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

        jparams, tparams = make_params(12)
        tokens = ByteTokenizer().encode(PROMPT)
        jeng = jax_engine(jparams)
        # the control, which also leaves the prompt's pages on the JAX
        # worker only: the router's overlap sends the request there
        want, _ = await collect(jeng, control_request(tokens, MAX_TOKENS,
                                                      "ref"),
                                RefContext("ctrl"))
        drt = await DistributedRuntime.detached()
        jdrt = await RefRuntime.attach(drt.dcp.address)
        service = None
        try:
            teng = port_engine(tparams)
            jh, jpub = await ref_serve_token_model(
                jdrt, RefCard(name="m", tokenizer_kind="byte",
                              kv_block_size=PS, model_type="completions"),
                jeng, namespace="xrev", component="w")
            mdc = ModelDeploymentCard(name="m", tokenizer_kind="byte",
                                      kv_block_size=PS,
                                      model_type="completions")
            th, tpub = await serve_token_model(drt, mdc, teng,
                                               namespace="xrev",
                                               component="w")
            kvr, client, service = await _front(drt, mdc, "xrev")
            t0 = time.monotonic()
            while kvr.overlap_for(tokens, jdrt.instance_id) < 2:
                assert time.monotonic() - t0 < 10.0, "no JAX events"
                await asyncio.sleep(0.05)
            ref_guard.set_chaos("seed=3;sever:worker.kill@nth=3")
            rid = "xrevive-1"
            text, finishes, saw_error, trace = await asyncio.wait_for(
                sse_completion(service.port, rid, PROMPT, MAX_TOKENS), LIMIT)
            ref_guard.set_chaos(None)
            assert jh._dead and not th._dead
            assert not saw_error
            delivered = [t for _, ids in seen[rid] for t in ids]
            assert delivered == want
            assert text == ByteTokenizer().decode(want)
            assert finishes and finishes[-1] == "length"
            assert {r for r, _ in seen[rid]} == {0, 1}
            assert trace["cost"]["resumed_attempts"] == 1
            assert len(revive.journal()) == 0
            assert teng.stats()["post_warmup_compiles_total"] == 0

            await kvr.stop()
            await client.close()
            await tpub.stop()
            await jpub.stop()
            await th.stop()
            await jh.stop()
            await teng.stop()
        finally:
            if service is not None:
                await service.stop()
            await jeng.stop()
            await jdrt.shutdown()
            await drt.shutdown()

    run_async(main())


# ------------------------------------------------------------------ drain


def test_drain_finishes_inflight_refuses_new_and_router_avoids(run_async):
    """A drain during active decode: the stream in flight completes its
    whole budget, the discovery record goes, the engine refuses new
    admissions typed, and the drain reports clean."""

    async def main():
        from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
        from dynamo_tpu_torch.llm.protocols.common import (
            PreprocessedRequest, StopConditions)
        from dynamo_tpu_torch.llm.worker import serve_token_model
        from dynamo_tpu_torch.runtime.component import instance_key
        from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

        _, tparams = make_params(6)
        drt = await DistributedRuntime.detached()
        try:
            engine = port_engine(tparams)
            mdc = ModelDeploymentCard(name="m", tokenizer_kind="byte",
                                      kv_block_size=PS,
                                      model_type="completions")
            handle, pub = await serve_token_model(
                drt, mdc, engine, namespace="drain", component="w")
            client = await drt.namespace("drain").component("w") \
                .endpoint("generate_tokens").client()
            await client.wait_for_instances(timeout=5)
            guard.set_chaos("seed=1;delay:engine.stall@ms=5")
            stream = await client.round_robin(PreprocessedRequest(
                token_ids=list(range(1, 20)),
                stop=StopConditions(max_tokens=24)).to_dict())
            got, fins = [], []

            async def consume():
                async for env in stream:
                    if env.data is not None:
                        got.extend(env.data.get("token_ids", []))
                        if env.data.get("finish_reason"):
                            fins.append(env.data["finish_reason"])

            consumer = asyncio.ensure_future(consume())
            t0 = time.monotonic()
            while not got:
                assert time.monotonic() - t0 < LIMIT
                await asyncio.sleep(0.01)
            drained = await revive.drain_worker(
                handle, engine=engine, publisher=pub, timeout_s=15.0)
            await asyncio.wait_for(consumer, LIMIT)
            assert drained is True
            assert fins == ["length"] and len(got) == 24
            key = instance_key("drain", "w", "generate_tokens",
                               handle.instance.instance_id)
            assert await drt.dcp.kv_get(key) is None
            with pytest.raises(guard.NoCapacity):
                async for _ in engine.generate(PreprocessedRequest(
                        token_ids=[1, 2, 3]), Context()):
                    pass
            assert guard.counter_value("dyn_revive_drains_total",
                                       outcome="clean") >= 1
            await client.close()
            await engine.stop()
        finally:
            await drt.shutdown()

    run_async(main())


def test_drain_nacks_new_requests_typed(run_async):
    """A draining handle answers new dispatches with accepted=False (the
    Client maps it to a retryable rejection, never a hang), and its
    stats plane still answers, flagged draining."""

    async def main():
        from dynamo_tpu_torch.runtime import wire
        from dynamo_tpu_torch.runtime.dcp_client import unpack
        from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

        drt = await DistributedRuntime.detached()
        try:
            async def handler(request, ctx):
                yield {"ok": True}

            ep = drt.namespace("nack").component("w").endpoint("gen")
            handle = await ep.serve(handler)
            client = await ep.client()
            await client.wait_for_instances(timeout=5)
            wid = client.instance_ids()[0]
            await handle.begin_drain()
            client.retry = guard.RetryPolicy(max_attempts=2, base_s=0.01,
                                             cap_s=0.02)
            with pytest.raises(Exception) as ei:
                await client.direct({"x": 1}, wid, timeout=2.0)
            assert "rejected" in str(ei.value) or "not found" in \
                str(ei.value) or "circuit-broken" in str(ei.value)
            reply = wire.decoded(wire.DCP_STATS_REPLY, unpack(
                await drt.dcp.request(f"stats.{handle.instance.subject}",
                                      b"", timeout=2.0)))
            assert reply["data"]["draining"] == 1
            assert await handle.wait_idle(2.0)
            await handle.stop()
            await client.close()
        finally:
            await drt.shutdown()

    run_async(main())


def test_scheduler_skips_draining_workers():
    from dynamo_tpu_torch.llm.kv_router.indexer import OverlapScores
    from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics
    from dynamo_tpu_torch.llm.kv_router.scheduler import KvScheduler

    sched = KvScheduler(block_size=8, rng=random.Random(0))
    sched.update_metrics({
        1: ForwardPassMetrics(request_total_slots=8, kv_total_blocks=64),
        2: ForwardPassMetrics(request_total_slots=8, kv_total_blocks=64,
                              draining=1),
    })
    for _ in range(8):
        assert sched.schedule(16, OverlapScores()) == 1
    sched.update_metrics({
        1: ForwardPassMetrics(request_total_slots=8, kv_total_blocks=64),
        2: ForwardPassMetrics(request_total_slots=8, kv_total_blocks=64),
        3: ForwardPassMetrics(request_total_slots=8, kv_total_blocks=64,
                              draining=1),
    })
    for _ in range(4):
        assert sched.schedule(16, OverlapScores(), exclude={1}) == 2
    with pytest.raises(RuntimeError):
        sched.schedule(16, OverlapScores(), exclude={1, 2})


# ----------------------------------------------- SIGTERM on a launcher


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sigterm_worker_drains_its_stream(tmp_path, run_async):
    """A launcher worker (``in=dyn://... out=torch --model tiny --device
    cpu``, its loop slowed by a DYN_CHAOS engine stall) takes SIGTERM
    after a streaming request's first chunk: the stream still finishes
    its whole budget, the instance record leaves discovery, a new direct
    request is then refused typed, and the worker exits 0 with one
    clean drain."""
    dcp_port = _free_port()
    dcp = f"127.0.0.1:{dcp_port}"
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
    wenv = {**env, "DYN_CHAOS": "seed=1;delay:engine.stall@ms=50",
            "DYN_PROTO_VALIDATE": "1"}
    logs = {n: open(tmp_path / f"{n}.log", "w") for n in ("dcp", "worker")}
    procs = {}

    async def main():
        from dynamo_tpu_torch.runtime.component import instance_key
        from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

        drt = await DistributedRuntime.attach(dcp)
        try:
            client = await drt.namespace("dynamo").component("tiny") \
                .endpoint("gen").client()
            t0 = time.monotonic()
            while not client.instance_ids():
                assert procs["worker"].poll() is None, \
                    (tmp_path / "worker.log").read_text()[-2000:]
                assert time.monotonic() - t0 < 120
                await asyncio.sleep(0.2)
            wid = client.instance_ids()[0]
            key = instance_key("dynamo", "tiny", "gen", wid)
            stream = await client.direct({
                "model": "tiny", "stream": True, "max_tokens": 40,
                "messages": [{"role": "user", "content": "drain me"}]}, wid)
            chunks, fins = [], []
            it = stream.__aiter__()
            first = await asyncio.wait_for(it.__anext__(), LIMIT)
            chunks.append(first.data)
            procs["worker"].send_signal(signal.SIGTERM)

            async def rest():
                async for env in it:
                    if env.data is not None:
                        chunks.append(env.data)

            consumer = asyncio.ensure_future(rest())
            t0 = time.monotonic()
            while await drt.dcp.kv_get(key) is not None:
                assert time.monotonic() - t0 < 10.0
                await asyncio.sleep(0.02)
            refused = None
            if not consumer.done():
                client.retry = guard.RetryPolicy(max_attempts=1)
                try:
                    await client.direct({"model": "tiny", "max_tokens": 2,
                                         "messages": [{"role": "user",
                                                       "content": "x"}]},
                                        wid, timeout=5.0)
                except Exception as e:  # noqa: BLE001 — inspected below
                    refused = e
            await asyncio.wait_for(consumer, LIMIT)
            for c in chunks:
                for ch in c.get("choices", []):
                    if ch.get("finish_reason"):
                        fins.append(ch["finish_reason"])
            await client.close()
            return chunks, fins, refused
        finally:
            await drt.shutdown()

    try:
        procs["dcp"] = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.runtime.dcp_server",
             "--port", str(dcp_port)], cwd=REPO, env=env,
            stdout=logs["dcp"], stderr=subprocess.STDOUT)
        wait_for_dcp(procs["dcp"], tmp_path / "dcp.log")
        procs["worker"] = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.run",
             "in=dyn://dynamo.tiny.gen", "out=torch", "--model", "tiny",
             "--device", "cpu", "--dcp", dcp, "--max-batch-size", "4"],
            cwd=REPO, env=wenv, stdout=logs["worker"],
            stderr=subprocess.STDOUT)
        chunks, fins, refused = run_async(main())
        assert fins == ["length"]
        usage = [c for c in chunks if c.get("choices") and any(
            ch.get("delta", {}).get("content") is not None
            or ch.get("finish_reason") for ch in c["choices"])]
        assert usage, chunks
        # the stalled loop keeps the stream in flight for over a second:
        # the record went first, then the new request was refused
        assert refused is not None
        msg = str(refused)
        assert "rejected" in msg or "not found" in msg, msg
        assert procs["worker"].wait(timeout=30) == 0
        out = (tmp_path / "worker.log").read_text()
        assert "drained (clean)" in out, out[-2000:]
        assert "serving summary " in out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs.values():
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
        for f in logs.values():
            f.close()
