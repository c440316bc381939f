"""The port's tracing spans across the runtime plane, on the CPU, against
the reference's cases (``tests/test_tracing.py``).

The span-tree cases of the tracer core, the wire parenting of the
request envelope and of the prefill queue, the whole disaggregated
request in one trace (``http.request`` -> ``preprocess`` ->
``route.disagg`` -> ``prefill.remote`` -> ``prefill.forward`` ->
``kv_transfer.send`` and its stages -> ``kv_transfer.inject`` ->
``decode``) on two tiny TorchEngines at the JAX package's weights, the
KV-routed graph's tree (``http.request`` -> ``preprocess``, ``route``,
``serve.generate_tokens``), sampling 0 as a total no-op end to end, and
two cross-package runs: a JAX frontend's trace parents a port worker's
``serve.*`` span, and the reverse. Every await of a remote event is
bounded.
"""

import asyncio

import jax
import msgpack
import numpy as np
import pytest

from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.runtime import tracing as ref_tracing
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.disagg import DisaggRouter, PrefillWorker
from dynamo_tpu_torch.llm.disagg.decode import build_disagg_decode
from dynamo_tpu_torch.llm.disagg.protocols import RemotePrefillRequest
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime import codec, tracing
from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

PS = 8
LIMIT = 30.0  # seconds: the bound on every await of a remote event
ECFG = dict(page_size=PS, num_pages=64, max_batch=4, prefill_chunk=32,
            batch_buckets=(1, 2, 4), prefill_buckets=(8, 32),
            page_buckets=(8,), watermark_pages=2)


@pytest.fixture(autouse=True)
def fresh_tracer():
    """Every test gets its own tracers (full sampling), in both
    packages: the cross-package cases run both in one process."""
    tracer = tracing.configure(sample=1.0, ring=4096)
    ref_tracing.configure(sample=1.0, ring=4096)
    yield tracer
    tracing.configure(sample=1.0, ring=4096)
    ref_tracing.configure(sample=1.0, ring=4096)


def tiny(cls):
    # the byte tokenizer's ids (BOS 256, EOS 257) lie inside the vocab
    return cls.tiny(num_heads=4, num_kv_heads=2, head_dim=8, hidden_size=32,
                    vocab_size=300)


def make_params(seed):
    jparams = jax_init_params(tiny(JaxModelConfig), jax.random.PRNGKey(seed))
    return jparams, params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, tiny(ModelConfig),
        device="cpu")


def port_engine(tparams):
    return TorchEngine(tiny(ModelConfig), EngineConfig(**ECFG),
                       params=tparams, device="cpu")


def chat_body(stream=False):
    return {"model": "m", "stream": stream, "max_tokens": 6,
            "temperature": 0.0,
            "messages": [{"role": "user", "content": "hi there"}]}


# ------------------------------------------------------------- tracer core


def test_span_tree_and_ring(fresh_tracer):
    t = fresh_tracer
    with t.start_span("root", request_id="r1") as root:
        with t.start_span("child") as child:
            child.set_attribute("k", 1)
        assert child.trace_id == root.trace_id
        assert child.parent_id == root.span_id
    spans = t.snapshot()
    assert [s.name for s in spans] == ["child", "root"]  # end order
    assert all(s.end_time is not None for s in spans)
    tr = t.get_request_trace("r1")
    assert tr is not None and tr["trace_id"] == root.trace_id
    assert {s["name"] for s in tr["spans"]} == {"root", "child"}
    assert set(tr["stages"]) == {"root", "child"}


def test_wire_ctx_parenting(fresh_tracer):
    t = fresh_tracer
    with t.start_span("upstream") as up:
        ctx = t.current_trace_ctx()
    assert ctx == {"trace_id": up.trace_id, "span_id": up.span_id}
    with t.start_span("downstream", parent=ctx) as down:
        assert down.trace_id == up.trace_id
        assert down.parent_id == up.span_id


def test_record_span_synthesizes_duration(fresh_tracer):
    t = fresh_tracer
    with t.start_span("parent") as p:
        t.record_span("stage", 0.25, parent=p, attributes={"x": 1})
    stage = [s for s in t.snapshot() if s.name == "stage"][0]
    assert stage.parent_id == p.span_id
    assert 0.2 < stage.duration_s < 0.3


def test_sampling_zero_is_total_noop():
    """Sample 0: no span records, no context propagates, and the prefill
    queue's job carries no ``trace_ctx`` key."""
    t = tracing.configure(sample=0.0)
    with t.start_span("root", request_id="r") as root:
        assert not root.recording
        assert t.current_trace_ctx() is None
        with t.start_span("child") as child:
            assert not child.recording
    assert t.spans_recorded == 0
    assert t.snapshot() == []
    assert t.get_request_trace("r") is None
    req = RemotePrefillRequest(request_id="r", token_ids=[1],
                               trace_ctx=t.current_trace_ctx())
    assert "trace_ctx" not in req.to_dict()


def test_codec_roundtrip_with_and_without_trace_ctx():
    """The two-part frame and the msgpack envelope carry the trace field
    transparently; peers without it interoperate (absent = None)."""
    ctx = {"trace_id": "a" * 32, "span_id": "b" * 16}
    chunk = {"kind": "chunk", "request_id": "r", "chunk_idx": 0,
             "n_chunks": 1, "page_ids": [1], "shape": [1], "dtype": "f",
             "k_len": 1}
    with_trace = codec.encode(codec.TwoPartMessage(
        {**chunk, "trace": ctx}, b"kv"))
    without = codec.encode(codec.TwoPartMessage(dict(chunk), b"kv"))
    msg1, rest1 = codec.decode_buffer(with_trace)
    msg2, rest2 = codec.decode_buffer(without)
    assert rest1 == b"" and rest2 == b""
    assert msg1.header["trace"] == ctx and msg1.body == b"kv"
    assert msg2.header.get("trace") is None
    env = {"req_id": "r", "conn": {"address": "h:1", "subject": "s"},
           "payload": b"p"}
    assert msgpack.unpackb(msgpack.packb(env, use_bin_type=True),
                           raw=False).get("trace") is None
    env["trace"] = ctx
    assert msgpack.unpackb(msgpack.packb(env, use_bin_type=True),
                           raw=False)["trace"] == ctx


def test_prefill_queue_carries_trace_ctx(run_async):
    """RemotePrefillRequest round-trips trace_ctx over the real queue;
    an absent field stays absent."""

    async def main():
        from dynamo_tpu_torch.llm.disagg import PrefillQueue

        drt = await DistributedRuntime.detached()
        try:
            q = PrefillQueue(drt.dcp, "tq")
            ctx = {"trace_id": "c" * 32, "span_id": "d" * 16}
            await q.put(RemotePrefillRequest(request_id="a", token_ids=[1],
                                             trace_ctx=ctx))
            await q.put(RemotePrefillRequest(request_id="b", token_ids=[2]))
            got_a = await asyncio.wait_for(q.pull(timeout=1.0), LIMIT)
            got_b = await asyncio.wait_for(q.pull(timeout=1.0), LIMIT)
            assert got_a.trace_ctx == ctx
            assert got_b.trace_ctx is None
        finally:
            await drt.shutdown()

    run_async(main())


# ------------------------------------------------------- end-to-end disagg


async def _disagg_http(tparams, drt):
    """HTTP frontend -> LocalChatChain -> DisaggDecodeEngine and a remote
    prefill worker, in one process over the real DCP and TCP planes."""
    from dynamo_tpu_torch.llm.engines import LocalChatChain
    from dynamo_tpu_torch.llm.http.service import HttpService
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    decode_eng, prefill_eng = port_engine(tparams), port_engine(tparams)
    disagg = await build_disagg_decode(
        drt, decode_eng, namespace="trace",
        router=DisaggRouter(max_local_prefill_length=4),  # force remote
        watch_config=False)
    pw = PrefillWorker(drt, prefill_eng, namespace="trace")
    pw.start()
    mdc = ModelDeploymentCard(name="m", tokenizer_kind="byte",
                              context_length=256)
    service = HttpService()
    service.manager.add_chat_model("m", LocalChatChain(mdc, disagg))
    await service.start(host="127.0.0.1", port=0)
    return service, disagg, pw, decode_eng, prefill_eng


async def _teardown(service, disagg, pw, decode_eng, prefill_eng):
    await service.stop()
    await pw.stop()
    await disagg.transfer.stop()
    await prefill_eng.stop()
    await decode_eng.stop()


def test_disagg_trace_end_to_end(run_async):
    """One chat completion through the remote-prefill path yields ONE
    trace covering http -> route -> prefill -> the kv_transfer stages ->
    decode, one trace_id across the queue and transfer envelopes, served
    by /v1/traces/{request_id}."""

    async def main():
        import aiohttp

        _, tparams = make_params(5)
        drt = await DistributedRuntime.detached()
        handles = await _disagg_http(tparams, drt)
        service, disagg = handles[0], handles[1]
        base = f"http://127.0.0.1:{service.port}"
        rid = "trace-e2e-1"
        try:
            async with aiohttp.ClientSession() as http:
                async with http.post(f"{base}/v1/chat/completions",
                                     json=chat_body(),
                                     headers={"X-Request-Id": rid}) as r:
                    assert r.status == 200
                    assert r.headers["X-Request-Id"] == rid
                    assert "traceparent" in r.headers
                    await r.json()
                assert disagg.remote_prefills == 1
                assert disagg.remote_fallbacks == 0
                async with http.get(f"{base}/v1/traces/{rid}") as r:
                    assert r.status == 200
                    tr = await r.json()
                async with http.get(f"{base}/metrics") as r:
                    metrics = await r.text()
        finally:
            await _teardown(*handles)
            await drt.shutdown()

        spans = tr["spans"]
        names = {s["name"] for s in spans}
        for expected in ("http.request", "preprocess", "route.disagg",
                         "prefill.remote", "prefill.forward",
                         "kv_transfer.send", "kv_transfer.extract",
                         "kv_transfer.wire", "kv_transfer.inject", "decode"):
            assert expected in names, f"missing span {expected}: {names}"
        assert len({s["trace_id"] for s in spans}) == 1
        by_name = {s["name"]: s for s in spans}
        ids = {s["span_id"] for s in spans}
        root = by_name["http.request"]
        assert root["parent_id"] is None
        for s in spans:
            if s is not root:
                assert s["parent_id"] in ids, s
        assert by_name["prefill.forward"]["parent_id"] == \
            by_name["prefill.remote"]["span_id"]
        assert by_name["kv_transfer.send"]["parent_id"] == \
            by_name["prefill.remote"]["span_id"]
        assert by_name["kv_transfer.inject"]["parent_id"] == \
            by_name["kv_transfer.send"]["span_id"]
        assert by_name["preprocess"]["parent_id"] == root["span_id"]
        assert tr["stages"]["http.request"] >= tr["stages"]["decode"]
        assert 'stage="prefill.remote"' in metrics

    run_async(main())


def test_sampling_zero_end_to_end(run_async):
    """DYN_TRACE_SAMPLE=0: the whole disagg path serves the same with no
    span recorded and no trace field on any envelope; the always-on cost
    attribution still answers /v1/traces/{rid} with an empty span
    list."""

    async def main():
        import aiohttp

        tracer = tracing.configure(sample=0.0)
        _, tparams = make_params(7)
        drt = await DistributedRuntime.detached()
        handles = await _disagg_http(tparams, drt)
        service, disagg = handles[0], handles[1]
        base = f"http://127.0.0.1:{service.port}"
        rid = "unsampled-1"
        try:
            async with aiohttp.ClientSession() as http:
                async with http.post(f"{base}/v1/chat/completions",
                                     json=chat_body(stream=True),
                                     headers={"X-Request-Id": rid}) as r:
                    assert r.status == 200
                    assert r.headers["X-Request-Id"] == rid
                    assert "traceparent" not in r.headers
                    async for line in r.content:
                        if line.decode().strip() == "data: [DONE]":
                            break
                assert disagg.remote_prefills == 1
                async with http.get(f"{base}/v1/traces/{rid}") as r:
                    assert r.status == 200
                    body = await r.json()
                    assert body["spans"] == []
                    assert body["cost"]["decode_tokens"] >= 1
        finally:
            await _teardown(*handles)
            await drt.shutdown()
        assert tracer.spans_recorded == 0
        assert tracer.snapshot() == []

    run_async(main())


# ------------------------------------------------------- the KV-routed tree


async def _routed(drt, drt2, tparams, namespace="rt"):
    from dynamo_tpu_torch.llm.http.service import HttpService
    from dynamo_tpu_torch.llm.kv_router.router import KvRouter
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.processor import Processor
    from dynamo_tpu_torch.llm.worker import serve_token_model

    mdc = ModelDeploymentCard(name="m", tokenizer_kind="byte",
                              kv_block_size=PS, model_type="completions")
    engines = [port_engine(tparams), port_engine(tparams)]
    served = [await serve_token_model(d, mdc, e, namespace=namespace,
                                      component="w")
              for d, e in zip((drt, drt2), engines)]
    router = KvRouter(drt, namespace, "w", block_size=PS, seed=0)
    await router.start(run_loop=False)
    await router.scrape_once()
    client = await drt.namespace(namespace).component("w") \
        .endpoint("generate_tokens").client()
    service = HttpService()
    service.manager.add_completions_model(
        "m", Processor(mdc, client, router).completion)
    await service.start(host="127.0.0.1", port=0)
    return service, router, client, served, engines


async def _routed_teardown(service, router, client, served, engines):
    await service.stop()
    await router.stop()
    await client.close()
    for h, pub in served:
        await pub.stop()
        await h.stop()
    for e in engines:
        await e.stop()


def test_routed_request_is_one_tree(run_async):
    """A KV-routed completion: /v1/traces/{rid} holds one trace whose
    root is http.request, with preprocess, route and
    serve.generate_tokens its children (the worker's span parented on the
    envelope's trace field), and the engine's cost block beside it."""

    async def main():
        import aiohttp

        _, tparams = make_params(3)
        drt = await DistributedRuntime.detached()
        drt2 = await DistributedRuntime.attach(drt.dcp.address)
        handles = await _routed(drt, drt2, tparams)
        service, router = handles[0], handles[1]
        rid = "routed-tree-1"
        try:
            async with aiohttp.ClientSession() as http:
                base = f"http://127.0.0.1:{service.port}"
                async with http.post(f"{base}/v1/completions", json={
                        "model": "m", "prompt": "a routed prompt here",
                        "max_tokens": 5},
                        headers={"X-Request-Id": rid}) as r:
                    assert r.status == 200
                    await r.json()
                async with http.get(f"{base}/v1/traces/{rid}") as r:
                    assert r.status == 200
                    tr = await r.json()
        finally:
            await _routed_teardown(*handles)
            await drt2.shutdown()
            await drt.shutdown()
        spans = tr["spans"]
        assert len({s["trace_id"] for s in spans}) == 1
        by_name = {s["name"]: s for s in spans}
        assert {"http.request", "preprocess", "route",
                "serve.generate_tokens"} <= set(by_name), set(by_name)
        root = by_name["http.request"]
        assert root["parent_id"] is None
        assert [s for s in spans if s["parent_id"] is None] == [root]
        for name in ("preprocess", "route", "serve.generate_tokens"):
            assert by_name[name]["parent_id"] == root["span_id"], name
        assert by_name["route"]["attributes"]["worker_id"] in {
            f"{d:x}" for d in router.scheduler.workers}
        assert tr["cost"]["decode_tokens"] == 5
        # the router compared its prediction with the engine's split
        assert router.stats()["calibration"]["compared"] == 1
        assert tr["cost"]["router_overlap_blocks"] == 0

    run_async(main())


def test_sampling_zero_routed_adds_no_envelope_field(run_async,
                                                     monkeypatch):
    """Sample 0 on the routed graph: no span anywhere, and the request
    envelope the Client sends carries no ``trace`` key."""

    async def main():
        import aiohttp

        from dynamo_tpu_torch.runtime import component

        tracer = tracing.configure(sample=0.0)
        sent = []
        real = component.wire.checked

        def spy(frame, d):
            if frame is component.wire.DCP_REQUEST_ENVELOPE:
                sent.append(dict(d))
            return real(frame, d)

        monkeypatch.setattr(component.wire, "checked", spy)
        _, tparams = make_params(3)
        drt = await DistributedRuntime.detached()
        drt2 = await DistributedRuntime.attach(drt.dcp.address)
        handles = await _routed(drt, drt2, tparams, namespace="rt0")
        try:
            async with aiohttp.ClientSession() as http:
                base = f"http://127.0.0.1:{handles[0].port}"
                async with http.post(f"{base}/v1/completions", json={
                        "model": "m", "prompt": "unsampled", "max_tokens": 3},
                        headers={"X-Request-Id": "rt0-1"}) as r:
                    assert r.status == 200
                    assert "traceparent" not in r.headers
                    await r.json()
        finally:
            await _routed_teardown(*handles)
            await drt2.shutdown()
            await drt.shutdown()
        assert sent and all("trace" not in d for d in sent)
        assert tracer.spans_recorded == 0

    run_async(main())


# ------------------------------------------------------- across packages


def test_jax_frontend_trace_parents_port_worker_span(run_async):
    """A JAX frontend (its Client under an ambient span) calls a port
    worker's endpoint: the port's serve.<endpoint> span joins the JAX
    trace, parented on the JAX span the envelope names."""

    async def main():
        from dynamo_tpu.runtime.runtime import \
            DistributedRuntime as JaxRuntime

        drt = await DistributedRuntime.detached()
        jdrt = await JaxRuntime.attach(drt.dcp.address)
        try:
            async def handler(request, ctx):
                yield {"echo": request["x"]}

            ep = drt.namespace("xt").component("w").endpoint("gen")
            handle = await ep.serve(handler)
            client = await jdrt.namespace("xt").component("w") \
                .endpoint("gen").client()
            await client.wait_for_instances(timeout=5)
            jt = ref_tracing.get_tracer()
            with jt.start_span("http.request", request_id="xt-1") as up:
                stream = await client.round_robin({"x": 7})
                got = [env.data async for env in stream]
            assert got == [{"echo": 7}]
            await asyncio.sleep(0.05)
            mine = [s for s in tracing.get_tracer().snapshot()
                    if s.name == "serve.gen"]
            assert len(mine) == 1
            assert mine[0].trace_id == up.trace_id
            assert mine[0].parent_id == up.span_id
            await client.close()
            await handle.stop()
        finally:
            await jdrt.shutdown()
            await drt.shutdown()

    run_async(main())


def test_port_frontend_trace_parents_jax_worker_span(run_async):
    """The reverse: a port Client under an ambient span stamps the trace
    on the envelope, and the JAX worker's serve.<endpoint> span joins
    it."""

    async def main():
        from dynamo_tpu.runtime.runtime import \
            DistributedRuntime as JaxRuntime

        drt = await DistributedRuntime.detached()
        jdrt = await JaxRuntime.attach(drt.dcp.address)
        try:
            async def handler(request, ctx):
                yield {"echo": request["x"]}

            ep = jdrt.namespace("xt2").component("w").endpoint("gen")
            handle = await ep.serve(handler)
            client = await drt.namespace("xt2").component("w") \
                .endpoint("gen").client()
            await client.wait_for_instances(timeout=5)
            with tracing.get_tracer().start_span("http.request") as up:
                stream = await client.round_robin({"x": 8})
                got = [env.data async for env in stream]
            assert got == [{"echo": 8}]
            await asyncio.sleep(0.05)
            theirs = [s for s in ref_tracing.get_tracer().snapshot()
                      if s.name == "serve.gen"]
            assert len(theirs) == 1
            assert theirs[0].trace_id == up.trace_id
            assert theirs[0].parent_id == up.span_id
            await client.close()
            await handle.stop()
        finally:
            await jdrt.shutdown()
            await drt.shutdown()

    run_async(main())


# ------------------------------------------------------ router calibration


def test_router_autotune_moves_weight():
    """Over-prediction (the index promises overlap the engines do not
    hold) shifts load_balance_weight toward load; perfect calibration
    does not move it; the weight stays clamped and is exported as a
    gauge; a disabled scheduler never moves."""
    from dynamo_tpu_torch.llm.kv_router.scheduler import KvScheduler
    from dynamo_tpu_torch.runtime import guard

    s = KvScheduler(block_size=4, autotune=True, autotune_gain=0.5,
                    autotune_window=4)
    w0 = s.load_balance_weight
    for _ in range(4):  # predicted 8, realized 2 of 8: bias 0.75
        s.observe_calibration(predicted=8, realized=2, isl_blocks=8)
    assert s.load_balance_weight > w0
    assert s.autotune_adjustments == 1
    assert abs(guard.counter_value("dyn_kv_router_load_balance_weight")
               - s.load_balance_weight) < 1e-9
    w1 = s.load_balance_weight
    for _ in range(4):
        s.observe_calibration(predicted=4, realized=4, isl_blocks=8)
    assert s.load_balance_weight == w1
    for _ in range(40):
        s.observe_calibration(predicted=8, realized=0, isl_blocks=8)
    assert s.alpha_min <= s.load_balance_weight <= s.alpha_max
    s2 = KvScheduler(block_size=4, autotune=False)
    for _ in range(128):
        s2.observe_calibration(predicted=8, realized=0, isl_blocks=8)
    assert s2.load_balance_weight == 0.3
    assert s2.autotune_adjustments == 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_observe_calibration_weights_equal_reference(seed, monkeypatch):
    """The same seeded stream of (predicted, realized, isl) observations
    gives the reference's sequence of weights and adjustment counts, at
    the default gain and window (read from the environment) and at a
    large gain that reaches the clamps."""
    from dynamo_tpu.llm.kv_router.scheduler import \
        KvScheduler as RefScheduler
    from dynamo_tpu_torch.llm.kv_router.scheduler import KvScheduler

    monkeypatch.delenv("DYN_ROUTER_AUTOTUNE", raising=False)
    monkeypatch.delenv("DYN_ROUTER_AUTOTUNE_GAIN", raising=False)
    rng = np.random.RandomState(seed)
    obs = []
    for _ in range(600):
        isl = int(rng.randint(1, 40))
        obs.append((int(rng.randint(0, isl + 1)),
                    int(rng.randint(0, isl + 1)), isl))
    for kw in ({}, {"autotune_gain": 3.0, "autotune_window": 8}):
        mine, theirs = KvScheduler(block_size=8, **kw), \
            RefScheduler(block_size=8, **kw)
        assert mine.autotune is True and theirs.autotune is True
        a, b = [], []
        for p, r, isl in obs:
            mine.observe_calibration(p, r, isl)
            theirs.observe_calibration(p, r, isl)
            a.append((mine.load_balance_weight, mine.autotune_adjustments))
            b.append((theirs.load_balance_weight,
                      theirs.autotune_adjustments))
        assert a == b
        assert a[-1][1] > 0
    monkeypatch.setenv("DYN_ROUTER_AUTOTUNE", "0")
    assert KvScheduler(block_size=8).autotune is False


def test_router_stats_carry_calibration(run_async):
    """The routed graph's router: each finished request's cost block is
    compared with its parked prediction; stats() carries the calibration
    counters, the live weight and the autotune block, and /debug/cache
    lists the router beside the engines."""

    async def main():
        import aiohttp

        _, tparams = make_params(4)
        drt = await DistributedRuntime.detached()
        drt2 = await DistributedRuntime.attach(drt.dcp.address)
        handles = await _routed(drt, drt2, tparams, namespace="cal")
        service, router = handles[0], handles[1]
        try:
            async with aiohttp.ClientSession() as http:
                base = f"http://127.0.0.1:{service.port}"
                for i in range(3):
                    async with http.post(f"{base}/v1/completions", json={
                            "model": "m", "prompt": "the same prefix " * 3,
                            "max_tokens": 3},
                            headers={"X-Request-Id": f"cal-{i}"}) as r:
                        assert r.status == 200
                        await r.json()
                async with http.get(f"{base}/debug/cache") as r:
                    caches = (await r.json())["caches"]
        finally:
            await _routed_teardown(*handles)
            await drt2.shutdown()
            await drt.shutdown()
        st = router.stats()
        assert st["calibration"]["compared"] == 3
        assert st["load_balance_weight"] == 0.3
        assert st["autotune"] == {"enabled": True, "adjustments": 0}
        assert any(v.get("kind") == "kv_router" for v in caches.values())

    run_async(main())
