"""The port's HTTP frontend with its operator surface against the JAX
package's, as a whole, on the CPU at ModelConfig.tiny() in float32: a
JaxEngine and a TorchEngine with the same (bridged) weights, each behind
its own package's HttpService on a local port, wired as each launcher
wires it (admission over the engine's ``stats()``, ``POST /drain`` over
its ``drain()``), take the same requests. Compared:

- greedy text identical, and for ``n = 2`` greedy both choices equal to
  the JAX single choice (on both sides);
- ``/metrics``: the same metric families and the same request counts by
  model, endpoint, type and status, and the same stream histogram
  counts;
- ``/debug/cache``: the port engine's view has the keys of the JAX
  engine's ``cache_snapshot()``;
- ``/v1/traces/{rid}``: a ``cost`` block with the reference's keys, and
  conservation: the finished requests' ``device_step_share`` sums to
  ``batch_dispatches_total`` on each side;
- ``X-Request-Deadline-Ms: 1``: 504 on both sides, and the port's
  ``kv_free_blocks`` back at its value before the request;
- ``ShedConfig(queue_depth=1)`` and 8 concurrent requests: the shed ones
  get 503 with a ``Retry-After`` within the cap, the admitted ones 200;
- ``X-Request-Id`` and ``traceparent`` on every response, the 409s of a
  second ``/debug/profile/stop`` and a second ``POST /drain``;
- ``/debug/profile/start`` then ``/stop`` writes a Chrome trace of the
  process's host ops on the CPU;
- ``/debug/incidents/capture`` then ``/debug/incidents/{id}``: the bundle
  folds the engine's ``stats()``;
- ``POST /drain`` with a request in flight: it finishes, the next request
  gets 503 with ``Retry-After``.

Also ``--model-id`` on a local checkpoint directory (the weights and card
of ``--model-path``), and two ``asyncio.run`` loops in a row, each with an
engine started and stopped, leave no stall-watchdog thread alive.
"""

import asyncio
import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.jax_engine import JaxEngine
from dynamo_tpu.llm.engines import LocalChatChain as JaxChatChain
from dynamo_tpu.llm.engines import LocalCompletionChain as JaxCompletionChain
from dynamo_tpu.llm.http.service import HttpService as JaxHttpService
from dynamo_tpu.llm.http.service import ModelManager as JaxModelManager
from dynamo_tpu.llm.model_card import ModelDeploymentCard as JaxCard
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.runtime import blackbox as jax_blackbox
from dynamo_tpu.runtime import profiling as jax_profiling
from dynamo_tpu.runtime import revive as jax_revive
from dynamo_tpu_torch import run
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime import blackbox, profiling, revive

# pages of 64 tokens: no request here fills one, so no page is ever
# committed to the prefix cache and a released request's pages all go
# back to the free list (kv_free_blocks is exact before and after)
ECFG = dict(page_size=64, num_pages=32, max_batch=4, prefill_chunk=64,
            prefill_buckets=(64,), batch_buckets=(1, 2, 4), page_buckets=(4,),
            decode_steps=4)
MODEL = "tiny"


def _chat(content: str, max_tokens: int = 8, **extra) -> dict:
    return {"model": MODEL, "max_tokens": max_tokens, "temperature": 0,
            "messages": [{"role": "user", "content": content}], **extra}


async def _jax_service(engine):
    """The JAX launcher's ``in=http out=jax`` wiring (dynamo_tpu/run.py)."""
    manager = JaxModelManager()
    chat = JaxChatChain(JaxCard(name=MODEL), engine)
    manager.add_chat_model(MODEL, chat)
    manager.add_completions_model(MODEL, JaxCompletionChain(
        JaxCard(name=MODEL), engine, chat.preprocessor))
    svc = JaxHttpService(manager)
    svc.set_admission(jax_revive.AdmissionController(
        lambda: jax_revive.signals_from_stats(engine.stats())))
    svc.on_drain(lambda: engine.drain(jax_revive.drain_timeout_s()))
    await svc.start("127.0.0.1", 0)
    return svc


async def _pages_idle(engine, limit_s: float = 10.0) -> None:
    """Wait until no sequence holds a page (``kv_active_blocks`` 0)."""
    t0 = time.monotonic()
    while engine.stats()["kv_active_blocks"] \
            and time.monotonic() - t0 < limit_s:
        await asyncio.sleep(0.01)


async def _drive(side: str, svc, engine, revive_mod, tmp) -> dict:
    """The same request sequence against one side; what it saw."""
    import aiohttp

    base = f"http://127.0.0.1:{svc.port}"
    out = {"headers_ok": True}

    def check_headers(r, rid):
        """Every answer to a request (200, 503, 504) names it and its
        trace."""
        if r.headers.get("X-Request-Id") != rid \
                or "traceparent" not in r.headers:
            out["headers_ok"] = False

    async with aiohttp.ClientSession() as s:
        async def post(path, body, rid=None, headers=None):
            hdrs = dict(headers or {})
            if rid is not None:
                hdrs["X-Request-Id"] = rid
            async with s.post(base + path, json=body, headers=hdrs) as r:
                if body is not None and body.get("stream"):
                    text = (await r.read()).decode()
                    data = [ln[6:] for ln in text.splitlines()
                            if ln.startswith("data: ")]
                    payload = data
                else:
                    payload = await r.json()
                if rid is not None:
                    check_headers(r, rid)
                return r.status, dict(r.headers), payload

        async def get(path):
            async with s.get(base + path) as r:
                body = await r.text()
                return r.status, body

        # greedy: unary chat, a stream, a completion
        st, _, g1 = await post("/v1/chat/completions",
                               _chat("hello there", 10), "hs-g1")
        assert st == 200, g1
        out["greedy"] = g1["choices"][0]["message"]["content"]
        st, _, chunks = await post("/v1/chat/completions",
                                   _chat("stream me", 9, stream=True),
                                   "hs-s1")
        assert st == 200 and chunks[-1] == "[DONE]"
        out["stream"] = "".join(
            (c["delta"].get("content") or "")
            for d in chunks[:-1] for c in json.loads(d)["choices"])
        st, _, c1 = await post("/v1/completions", {
            "model": MODEL, "prompt": "abc", "max_tokens": 6,
            "temperature": 0}, "hs-c1")
        out["completion"] = c1["choices"][0]["text"]
        # n = 2 greedy: both choices, by index
        st, _, n2 = await post("/v1/chat/completions",
                               _chat("hello there", 10, n=2), "hs-n2")
        assert st == 200, n2
        out["n2"] = [c["message"]["content"] for c in
                     sorted(n2["choices"], key=lambda c: c["index"])]
        # the deadline: 504, and the pool's free pages back. A finished
        # request's pages free once its last window in flight lands, which
        # may be after its answer: read the pool with no page held
        await _pages_idle(engine)
        free0 = engine.stats()["kv_free_blocks"]
        st, _, body = await post("/v1/chat/completions",
                                 _chat("hello there", 10), "hs-d1",
                                 {"X-Request-Deadline-Ms": "1"})
        out["deadline"] = (st, body["error"]["type"])
        await _pages_idle(engine)
        out["free_back"] = engine.stats()["kv_free_blocks"] == free0
        # the counts before the burst (how many it sheds is timing)
        out["metrics_pre"] = await get("/metrics")
        # shedding: queue depth 1, 8 at once
        svc.set_admission(revive_mod.AdmissionController(
            lambda: revive_mod.signals_from_stats(engine.stats()),
            revive_mod.ShedConfig(queue_depth=1)))
        burst = await asyncio.gather(*(
            post("/v1/chat/completions", _chat(f"burst {i}", 6),
                 f"hs-b{i}") for i in range(8)))
        out["burst"] = [(st, h.get("Retry-After")) for st, h, _ in burst]
        svc.set_admission(revive_mod.AdmissionController(
            lambda: revive_mod.signals_from_stats(engine.stats())))
        # the operator reads
        for path in ("/metrics", "/live", "/health", "/debug/slo",
                     "/debug/cache", "/debug/profile",
                     "/debug/profile/stacks", "/v1/traces",
                     "/v1/traces/hs-g1", "/v1/traces/nope",
                     "/debug/incidents", "/v1/traces?limit=x"):
            out[path] = await get(path)
        if side == "port":
            st, _, started = await post("/debug/profile/start",
                                        {"dir": str(tmp / "prof")})
            out["profile_start"] = (st, started)
            out["profile_busy"] = (await post("/debug/profile/start",
                                              None))[0]
            await post("/v1/chat/completions", _chat("profile me", 4),
                       "hs-p1")
            out["profile_stop"] = (await post("/debug/profile/stop",
                                              None))[:3:2]
            out["profile_stop_again"] = (await post("/debug/profile/stop",
                                                    None))[0]
        st, _, cap = await post("/debug/incidents/capture", None)
        out["capture"] = (st, cap)
        if st == 200:
            out["incident"] = await get(f"/debug/incidents/{cap['id']}")
        # drain with one stream in flight; then 503 and 409
        inflight = asyncio.ensure_future(post(
            "/v1/chat/completions", _chat("last one", 24, stream=True),
            "hs-last"))
        while not engine.stats()["request_active_slots"]:
            await asyncio.sleep(0.01)
        st, _, drained = await post("/drain", None)
        out["drain"] = (st, drained)
        st, _, last = await inflight
        out["inflight"] = (st, last[-1])
        st, hdrs, _ = await post("/v1/chat/completions", _chat("late"),
                                 "hs-late")
        out["after_drain"] = (st, hdrs.get("Retry-After"))
        out["drain_again"] = (await post("/drain", None))[0]
        out["stats"] = engine.stats()
    return out


async def _scenario(tmp) -> dict:
    jcfg, tcfg = JaxModelConfig.tiny(), ModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 jparams.items()}, tcfg, device="cpu")
    jeng = JaxEngine(jcfg, JaxEngineConfig(**ECFG), params=jparams)
    teng = TorchEngine(tcfg, EngineConfig(**ECFG), params=tparams,
                       device="cpu")
    jsvc = await _jax_service(jeng)
    tsvc = await run.serve_http(teng, ModelDeploymentCard(name=MODEL),
                                "127.0.0.1", 0)
    res = {"wired": (tsvc.admission is not None, len(tsvc._drain_cbs))}
    try:
        res["jax"] = await _drive("jax", jsvc, jeng, jax_revive, tmp)
        res["port"] = await _drive("port", tsvc, teng, revive, tmp)
    finally:
        await jsvc.stop()
        await tsvc.stop()
        await jeng.stop()
        await teng.stop()
    res["jax_cache"] = jeng.cache_snapshot()
    res["port_cache_name"] = f"torch-engine-{id(teng):x}"
    res["port_label"] = f"torch-engine-{id(teng):x}"
    res["attr"] = {
        "port": [c for rid, c in profiling.attributions_snapshot(10 ** 6)
                 if rid.startswith("hs-")],
        "jax": [c for rid, c in jax_profiling.attributions_snapshot(10 ** 6)
                if rid.startswith("hs-")]}
    return res


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    # flight recorders with no debounce, installed before the engines
    # register as their stats sources
    blackbox.configure(window_s=30.0, cooldown_s=0.0)
    jax_blackbox.configure(window_s=30.0, cooldown_s=0.0)
    try:
        yield asyncio.run(_scenario(tmp_path_factory.mktemp("surface")))
    finally:
        blackbox.reset()
        jax_blackbox.reset()


def test_greedy_text_and_n2_choices_match_jax(served):
    j, p = served["jax"], served["port"]
    assert p["greedy"] == j["greedy"] and p["greedy"]
    assert p["stream"] == j["stream"] and p["completion"] == j["completion"]
    assert p["n2"] == [j["greedy"], j["greedy"]]
    assert j["n2"] == [j["greedy"], j["greedy"]]
    assert served["wired"] == (True, 1)


def _families(text: str) -> set:
    """The metric families of the service's and the loop profiler's
    planes. The guard plane's counters are process-wide: another test
    of either package in the same worker process may have counted one."""
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")
            and ln.split()[2].startswith(("dyn_llm_http_service_",
                                          "dyn_slo_", "dyn_runtime_"))}


def _lines(text: str, prefix: str) -> list:
    return sorted(ln for ln in text.splitlines() if ln.startswith(prefix))


def test_metrics_families_and_counts_match_jax(served):
    jt, pt = served["jax"]["/metrics"], served["port"]["/metrics"]
    assert jt[0] == pt[0] == 200
    assert _families(pt[1]) == _families(jt[1])
    # the same requests, the same counts (before the burst, whose shed
    # share is a race with the engine's admission)
    jt, pt = served["jax"]["metrics_pre"], served["port"]["metrics_pre"]
    for prefix in ("dyn_llm_http_service_requests_total{",
                   "dyn_llm_http_service_time_to_first_token_seconds_count",
                   "dyn_llm_http_service_itl_seconds_count",
                   "dyn_llm_http_service_request_duration_seconds_count",
                   "dyn_llm_http_service_inflight_requests"):
        assert _lines(pt[1], prefix) == _lines(jt[1], prefix), prefix
    assert "dyn_runtime_loop_lag_seconds" in _families(pt[1])
    # after the burst: its 200s counted as successes; a shed request is
    # refused before it is counted, as in the reference
    burst = served["port"]["burst"]

    def count(text, status):
        key = ('dyn_llm_http_service_requests_total{model="tiny",'
               'endpoint="chat_completions",request_type="unary",'
               f'status="{status}"}}')
        return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                   if ln.startswith(key))

    after = served["port"]["/metrics"][1]
    assert count(after, "success") - count(pt[1], "success") == \
        sum(st == 200 for st, _ in burst)
    assert count(after, "error") == count(pt[1], "error")


def test_debug_reads_have_the_references_shapes(served):
    j, p = served["jax"], served["port"]
    for path in ("/live", "/health", "/debug/slo", "/debug/profile",
                 "/v1/traces", "/debug/incidents"):
        assert p[path][0] == j[path][0] == 200, path
        assert set(json.loads(p[path][1])) == set(json.loads(j[path][1]))
    assert p["/v1/traces/nope"][0] == j["/v1/traces/nope"][0] == 404
    assert p["/v1/traces?limit=x"][0] == 400
    assert p["/debug/profile/stacks"][0] == 200
    loop = json.loads(p["/debug/profile"][1])["loop"]
    assert loop["loop_lag"]["samples"] > 0
    caches = json.loads(p["/debug/cache"][1])["caches"]
    view = caches[served["port_cache_name"]]
    assert set(view) == set(served["jax_cache"])
    assert set(view["pool"]) == set(served["jax_cache"]["pool"])
    assert p["headers_ok"] and j["headers_ok"]


def test_trace_cost_block_and_conservation(served):
    j, p = served["jax"], served["port"]
    pt = json.loads(p["/v1/traces/hs-g1"][1])
    jt = json.loads(j["/v1/traces/hs-g1"][1])
    assert set(pt) == set(jt)
    assert set(pt["cost"]) == set(jt["cost"])
    assert pt["cost"]["finish_reason"] == "length"
    assert pt["spans"][0]["name"] == "http.request"
    for side in ("port", "jax"):
        shares = sum(c["device_step_share"] for c in served["attr"][side])
        total = served[side]["stats"]["batch_dispatches_total"]
        assert total > 0
        assert shares == pytest.approx(total, abs=1e-4 * len(
            served["attr"][side]))


def test_deadline_shed_and_drain_answers(served):
    j, p = served["jax"], served["port"]
    assert p["deadline"] == j["deadline"] == (504, "timeout_error")
    assert p["free_back"]
    for side in (p, j):
        codes = [st for st, _ in side["burst"]]
        assert set(codes) <= {200, 503} and 503 in codes and 200 in codes
        for st, ra in side["burst"]:
            if st == 503:
                assert 1 <= int(ra) <= 8
        assert side["drain"][0] == 200 and side["drain"][1]["results"] == \
            [True]
        assert side["inflight"] == (200, "[DONE]")
        assert side["after_drain"][0] == 503
        assert 1 <= int(side["after_drain"][1]) <= 8
        assert side["drain_again"] == 409


def test_profile_capture_and_incident_bundle(served):
    p = served["port"]
    assert p["profile_start"][0] == 200 and p["profile_busy"] == 409
    st, stopped = p["profile_stop"]
    assert st == 200 and p["profile_stop_again"] == 409
    trace = json.loads(open(os.path.join(
        stopped["dir"], "trace.pt.trace.json")).read())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"aten::mm", "aten::index_select"} & names, sorted(names)[:40]
    st, cap = p["capture"]
    assert st == 200 and cap["trigger"] == "manual"
    st, body = p["incident"]
    bundle = json.loads(body)
    assert st == 200 and bundle["id"] == cap["id"]
    assert served["port_label"] in bundle["telemetry"]["engines"]
    assert set(bundle) == set(json.loads(served["jax"]["incident"][1]))


def test_model_id_serves_a_local_checkpoint_as_model_path(tmp_path):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(5)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, torch_dtype="float32")).save_pretrained(
            tmp_path, safe_serialization=True)
    common = ["in=http", "out=torch", "--device", "cpu", "--no-warmup"]
    by_id = run.parse_args(common + ["--model-id", str(tmp_path)])
    by_path = run.parse_args(common + ["--model-path", str(tmp_path)])
    assert by_id.model_path == str(tmp_path) and by_id.model_name == \
        str(tmp_path)
    (e1, m1, _), (e2, m2, _) = run.build_engine(by_id), \
        run.build_engine(by_path)
    assert m1.context_length == m2.context_length
    assert e1.cfg == e2.cfg and set(e1.params) == set(e2.params)
    for k in e1.params:
        assert torch.equal(e1.params[k], e2.params[k]), k
    named = run.parse_args(common + ["--model-id", str(tmp_path),
                                     "--model-name", "mine"])
    assert named.model_name == "mine"


def test_two_loops_leave_no_stall_watchdog_alive():
    from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                       StopConditions)
    from dynamo_tpu_torch.runtime.engine import Context

    # the watchdogs these loops start (other tests of the same process may
    # leave their own, under the same thread name)
    watchdogs = []

    async def one_loop():
        eng = TorchEngine(ModelConfig.tiny(), EngineConfig(**ECFG),
                          device="cpu")
        req = PreprocessedRequest(token_ids=[1, 2, 3],
                                  stop=StopConditions(max_tokens=3))
        toks = [t async for out in eng.generate(req, Context())
                for t in out.token_ids]
        assert len(toks) == 3
        prof = profiling.current_loop_profiler()
        assert prof is not None and prof.watchdog.is_alive()
        watchdogs.append(prof.watchdog)
        await eng.stop()

    for _ in range(2):
        asyncio.run(one_loop())
    assert len(watchdogs) == 2 and watchdogs[0] is not watchdogs[1]
    for wd in watchdogs:
        wd.join(timeout=5)
    assert not [wd for wd in watchdogs if wd.is_alive()]
    assert not [t for t in threading.enumerate() if t in watchdogs]
