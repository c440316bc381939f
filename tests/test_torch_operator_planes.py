"""The HTTP frontend's operator planes against the JAX package's, module by
module, on the same seeded inputs with injected clocks where time enters:

- ``llm/http/metrics.py``: ``Metrics.render()`` byte-identical for the
  same guard/observe calls, with SLO objectives, guard counters and a
  breaker board (``runtime/guard.py render_prom_lines``);
- ``runtime/slo.py``: objective parsing, ``SloEngine`` snapshots and
  Prometheus lines on a stepped clock, ``GoodputTracker``, and the
  mergeable-histogram helpers;
- ``runtime/revive.py``: ``AdmissionController`` admit/shed decisions and
  ``Retry-After`` values from the same ``LoadSignals`` and rng seed;
- ``runtime/tracing.py``: ``traceparent`` parsing and formatting,
  ``Tracer`` summaries and request traces, ``StepTimeline`` snapshots,
  ``json_safe``;
- ``runtime/profiling.py``: ``LoopLagMonitor`` quantiles from injected
  samples, folded stall stacks, the attribution ring;
- ``runtime/blackbox.py``: ``FlightRecorder`` cooldown, trigger filter,
  deadline storms and the canonical bundle JSON;
- ``runtime/logging.py``: the JSONL and text formatters;
- ``models/hub.py resolve_model``: a local directory, and a model id in
  a synthesized HuggingFace cache with the hub offline;
- the service's route table: the reference's 18 (method, path) routes.
"""

import json
import logging
import random
import sys
import weakref

import numpy as np
import pytest

from dynamo_tpu.llm.http import metrics as jax_metrics
from dynamo_tpu.llm.http.service import HttpService as JaxHttpService
from dynamo_tpu.models import hub as jax_hub
from dynamo_tpu.runtime import blackbox as jax_blackbox
from dynamo_tpu.runtime import guard as jax_guard
from dynamo_tpu.runtime import logging as jax_logging
from dynamo_tpu.runtime import profiling as jax_profiling
from dynamo_tpu.runtime import revive as jax_revive
from dynamo_tpu.runtime import slo as jax_slo
from dynamo_tpu.runtime import tracing as jax_tracing
from dynamo_tpu_torch.llm.http import metrics
from dynamo_tpu_torch.llm.http.service import HttpService
from dynamo_tpu_torch.models import hub
from dynamo_tpu_torch.runtime import blackbox, guard
from dynamo_tpu_torch.runtime import logging as dyn_logging
from dynamo_tpu_torch.runtime import profiling, revive, slo, tracing

OBJECTIVES = "ttft<=0.25@0.9/300;tail=itl<=0.05@0.99/600;e2e<=2@0.95/300"


class Clock:
    """A stepped clock, injected where the modules read time."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def fresh_planes(monkeypatch):
    """Both packages' process-wide counters and breaker boards empty, and
    no loop profiler, so each renders only what the test feeds it."""
    for g in (guard, jax_guard):
        monkeypatch.setattr(g, "_COUNTERS", {})
        monkeypatch.setattr(g, "_BOARDS", weakref.WeakSet())
    for p in (profiling, jax_profiling):
        monkeypatch.setattr(p, "_latest", None)
    monkeypatch.setenv("DYN_SLO_OBJECTIVES", OBJECTIVES)


def _latencies(seed: int, n: int = 200):
    rng = np.random.RandomState(seed)
    return [float(np.exp(rng.uniform(np.log(5e-4), np.log(400.0))))
            for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_render_is_byte_identical(seed, fresh_planes):
    ours, theirs = metrics.Metrics(), jax_metrics.Metrics()
    # the SLO engines' snapshots are stamped on one stepped clock
    clock = Clock()
    ours.slo.clock = theirs.slo.clock = clock
    rng = np.random.RandomState(seed)
    vals = _latencies(seed)
    for k, v in enumerate(vals):
        model = ("llama", "tiny")[k % 2]
        endpoint = ("chat_completions", "completions")[k % 3 == 0]
        rtype = ("stream", "unary")[k % 5 == 0]
        for m in (ours, theirs):
            g = m.guard(model, endpoint, rtype)
            m.observe_ttft(model, v)
            m.observe_itl(model, v / 50.0)
            m.observe_stage(("http.request", "prefill")[k % 2], v / 3.0)
            m.count_output_tokens(model, int(rng.randint(1, 9)) if m is
                                  ours else 0)
            m.observe_request_slo({"ttft": v, "itl": v / 50.0,
                                   "e2e": v * 2})
            if k % 4:
                g.mark_ok()
            g.t0 -= v  # a request v seconds long
            g.done()
        if k % 7 == 0:
            guard.counter_inc("dyn_route_fallback_total", plane="stats")
            jax_guard.counter_inc("dyn_route_fallback_total", plane="stats")
    # the token counts: the same per model on both sides
    theirs.output_tokens_total.update(ours.output_tokens_total)
    boards = (guard.BreakerBoard("client"),
              jax_guard.BreakerBoard("client"))
    for b in boards:
        br = b.get("stats", 0x1a2b)
        for _ in range(b.cfg.threshold):
            br.record_failure()
        b.get("request", "w1")
    # the request durations are host clock reads: align them
    for fam in ("duration_buckets", "duration_sum", "duration_count"):
        getattr(theirs, fam).clear()
        getattr(theirs, fam).update(
            {k: (list(v) if isinstance(v, list) else v)
             for k, v in getattr(ours, fam).items()})
    text = ours.render()
    assert text == theirs.render()
    for family in ("requests_total", "inflight_requests",
                   "request_duration_seconds", "time_to_first_token_seconds",
                   "itl_seconds", "stage_duration_seconds"):
        assert f"# TYPE {metrics.PREFIX}_{family} " in text
    for name in ("dyn_slo_attainment", "dyn_slo_goodput_requests_total",
                 "dyn_route_fallback_total", "dyn_client_breaker_state"):
        assert name in text
    assert ours.slo_snapshot() == theirs.slo_snapshot()


def test_slo_engine_and_goodput_agree_on_a_stepped_clock(fresh_planes):
    assert slo.parse_objective("x=ttft<=0.3@0.9/60") == \
        slo.SloObjective(**jax_slo.parse_objective(
            "x=ttft<=0.3@0.9/60").to_dict())
    for bad in ("ttft<0.3@0.9/60", "nope<=0.3@0.9/60", "ttft<=0.3@1.5/60"):
        with pytest.raises(ValueError):
            slo.parse_objective(bad)
        with pytest.raises(ValueError):
            jax_slo.parse_objective(bad)
    regs = (slo.SloRegistry.from_env(), jax_slo.SloRegistry.from_env())
    assert regs[0].to_dict() == regs[1].to_dict()
    clocks = (Clock(), Clock())
    hists = ({m: slo.Histogram() for m in slo.METRICS},
             {m: jax_slo.Histogram() for m in jax_slo.METRICS})
    engines = [mod.SloEngine(reg, source=lambda h=h: h, clock=c)
               for mod, reg, h, c in zip((slo, jax_slo), regs, hists,
                                         clocks)]
    goodput = [mod.GoodputTracker(reg)
               for mod, reg in zip((slo, jax_slo), regs)]
    vals = _latencies(3, 120)
    for step in range(12):
        for v in vals[step * 10:(step + 1) * 10]:
            for h, gp in zip(hists, goodput):
                h["ttft"].observe(v / 100.0)
                h["itl"].observe(v / 2000.0)
                h["e2e"].observe(v)
                gp.observe_request({"ttft": v / 100.0, "itl": v / 2000.0,
                                    "e2e": v})
        for c in clocks:
            c.t += 30.0
        events = [e.tick() for e in engines]
        assert events[0] == events[1]
        assert engines[0].snapshot() == engines[1].snapshot()
        assert engines[0].render_prom_lines('model="m"') == \
            engines[1].render_prom_lines('model="m"')
    assert engines[0].window_quantiles("e2e", 120.0) == \
        engines[1].window_quantiles("e2e", 120.0)
    goodput[0].observe_failed()
    goodput[1].observe_failed()
    assert goodput[0].snapshot() == goodput[1].snapshot()
    assert goodput[0].render_prom_lines() == goodput[1].render_prom_lines()
    # the histogram helpers
    h = slo.Histogram()
    for v in vals:
        h.observe(v)
    wires = [{"prefill": {"ttft": h.to_wire()}},
             {"decode": {"itl": h.to_wire()}, "prefill": {"ttft":
                                                        h.to_wire()}}]
    merged = slo.merge_latency_wire(wires)
    jmerged = jax_slo.merge_latency_wire(wires)
    assert {r: {m: x.to_wire() for m, x in per.items()}
            for r, per in merged.items()} == \
        {r: {m: x.to_wire() for m, x in per.items()}
         for r, per in jmerged.items()}
    assert {m: x.to_wire() for m, x in slo.collapse_roles(merged).items()} \
        == {m: x.to_wire()
            for m, x in jax_slo.collapse_roles(jmerged).items()}
    assert slo.render_role_histograms(merged) == \
        jax_slo.render_role_histograms(jmerged)
    for q in (0, 1, 50, 95, 99, 100):
        assert slo.nearest_rank(vals, q) == jax_slo.nearest_rank(vals, q)
    assert slo.snap_threshold(0.3) == jax_slo.snap_threshold(0.3)


def _signals(seed: int):
    rng = np.random.RandomState(seed)
    for _ in range(60):
        yield dict(queue_depth=int(rng.randint(0, 12)),
                   workers=int(rng.randint(1, 4)),
                   loop_lag_p99_ms=float(rng.uniform(0, 80)),
                   kv_free_blocks=(None if rng.rand() < 0.2
                                   else int(rng.randint(0, 200))))


@pytest.mark.parametrize("cfg", [
    dict(queue_depth=2),
    dict(loop_lag_ms=40.0, retry_after_cap_s=4.0),
    dict(queue_depth=6, loop_lag_ms=78.0, kv_free_blocks=2),
    dict()], ids=["queue", "lag", "all", "off"])
def test_admission_decisions_and_retry_after_match(cfg, fresh_planes):
    feeds = [iter(list(_signals(5))), iter(list(_signals(5)))]
    ours = revive.AdmissionController(
        lambda: revive.LoadSignals(**next(feeds[0])),
        revive.ShedConfig(**cfg), rng=random.Random(11), window=4)
    theirs = jax_revive.AdmissionController(
        lambda: jax_revive.LoadSignals(**next(feeds[1])),
        jax_revive.ShedConfig(**cfg), rng=random.Random(11), window=4)
    got = [(ours.admit(), theirs.admit()) for _ in range(25)]
    assert [a for a, _ in got] == [b for _, b in got]
    assert ours.snapshot() == theirs.snapshot()
    cap = revive.ShedConfig(**cfg).retry_after_cap_s
    assert all(a is None or 1 <= a <= max(cap, 1) for a, _ in got)
    if cfg:
        assert ours.shed_total > 0 and ours.admitted_total > 0
    for p in (0.5, 1.0, 3.7, 50.0):
        assert ours.retry_after(p) == theirs.retry_after(p)
        assert revive.retry_after_s(p, random.Random(2), 6.0) == \
            jax_revive.retry_after_s(p, random.Random(2), 6.0)
    stats = {"num_requests_waiting": 3, "loop_lag_p99_seconds": 0.012,
             "kv_free_blocks": 17}
    assert vars(revive.signals_from_stats(stats)) == \
        vars(jax_revive.signals_from_stats(stats))

    class Fpm:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    view = {i: Fpm(num_requests_waiting=i, loop_lag_p99_seconds=i / 100,
                   kv_free_blocks=50 - i, draining=int(i == 2))
            for i in range(4)}
    assert vars(revive.signals_from_metrics(view)) == \
        vars(jax_revive.signals_from_metrics(view))
    assert revive.drain_timeout_s() == jax_revive.drain_timeout_s()


TRACEPARENTS = [
    None, "", "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-00",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e473-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902zz-01",
    "zz-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    " 00-aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa-bbbbbbbbbbbbbbbb-03 ", "a-b-c"]


def test_traceparent_tracer_and_timeline_match():
    for tp in TRACEPARENTS:
        assert tracing.parse_traceparent(tp) == \
            jax_tracing.parse_traceparent(tp)
    ctx = tracing.parse_traceparent(TRACEPARENTS[2])
    tracers = (tracing.Tracer(sample=1.0, ring=64, jsonl=""),
               jax_tracing.Tracer(sample=1.0, ring=64, jsonl=""))
    for i, tr in enumerate(tracers):
        mod = (tracing, jax_tracing)[i]
        with tr.start_span("http.request", parent=ctx,
                           attributes={"endpoint": "chat", "blob": b"\xff"},
                           request_id="rid-1") as root:
            # the round trip: a span's header names the span
            assert mod.parse_traceparent(mod.format_traceparent(root)) == \
                {"trace_id": root.trace_id, "span_id": root.span_id}
            with tr.start_span("prefill") as child:
                child.set_attribute("tokens", 17)
            tr.record_span("cache.restore", 0.002)
        with tr.start_span("solo", parent=None, request_id="rid-2"):
            pass
        assert mod.format_traceparent(mod.NoopSpan()) is None
        off = mod.Tracer(sample=0.0, ring=4, jsonl="")
        assert not off.start_span("x").recording
    summaries = [tr.traces_summary() for tr in tracers]
    assert [set(s) for s in summaries[0]] == [set(s) for s in summaries[1]]
    assert [(s["root"], s["spans"], s["request_id"]) for s in summaries[0]] \
        == [(s["root"], s["spans"], s["request_id"]) for s in summaries[1]]
    assert summaries[0][-1]["trace_id"] == ctx["trace_id"]
    reqs = [tr.get_request_trace("rid-1") for tr in tracers]
    assert set(reqs[0]) == set(reqs[1])
    assert set(reqs[0]["stages"]) == set(reqs[1]["stages"]) == {
        "http.request", "prefill", "cache.restore"}
    assert [sorted(s) for s in reqs[0]["spans"]] == \
        [sorted(s) for s in reqs[1]["spans"]]
    assert tracers[0].get_request_trace("nope") is None
    timelines = (tracing.StepTimeline(8), jax_tracing.StepTimeline(8))
    for tl in timelines:
        for k in range(12):
            tl.add("decode_window", batch=k, tokens=4 * k)
    snaps = [tl.snapshot(limit=5) for tl in timelines]
    assert [set(e) for e in snaps[0]] == [set(e) for e in snaps[1]]
    assert [e["batch"] for e in snaps[0]] == [e["batch"] for e in snaps[1]]
    assert set(timelines[0].anchors()) == set(timelines[1].anchors())
    assert not tracing.StepTimeline(0).enabled
    weird = {"a": (1, 2.5, None), 3: {b"k": bytearray(b"\x00\xff")},
             "s": {1}, "o": object}
    assert tracing.json_safe(weird) == jax_tracing.json_safe(weird)


def test_loop_lag_stacks_and_attribution_match(fresh_planes):
    rng = np.random.RandomState(9)
    samples = [float(x) for x in rng.exponential(0.004, 500)]
    mons = (profiling.LoopLagMonitor(0.05, ring=256),
            jax_profiling.LoopLagMonitor(0.05, ring=256))
    for m in mons:
        assert m.snapshot()["samples"] == 0
        m.samples.extend(samples)
    assert mons[0].snapshot() == mons[1].snapshot()
    frame = sys._getframe()
    assert profiling.fold_stack(frame) == jax_profiling.fold_stack(frame)
    dogs = (profiling.StallWatchdog(mons[0], 0.1, max_stacks=3),
            jax_profiling.StallWatchdog(mons[1], 0.1, max_stacks=3))
    for d in dogs:
        for stack, n in (("a;b", 3), ("a;c", 1), ("d", 5), ("e", 2)):
            for _ in range(n):
                with d._lock:
                    if stack in d._stacks:
                        d._stacks[stack] += 1
                    elif len(d._stacks) < d.max_stacks:
                        d._stacks[stack] = 1
                        d._last_seen[stack] = 0.0
    assert dogs[0].folded() == dogs[1].folded()
    assert dogs[0].folded(limit=2) == dogs[1].folded(limit=2)
    assert dogs[0].snapshot() == dogs[1].snapshot()
    for mod in (profiling, jax_profiling):
        seen = []
        mod.add_attribution_listener(lambda rid, c: seen.append(rid))
        for i in range(5):
            mod.record_attribution(f"op-r{i}", {"device_step_share": i})
        mod.record_attribution(None, {})
        assert mod.request_attribution("op-r3") == {"device_step_share": 3}
        assert [r for r, _ in mod.attributions_snapshot(2)] == \
            ["op-r3", "op-r4"]
        assert seen == [f"op-r{i}" for i in range(5)]
    assert profiling.loop_lag_snapshot() == \
        jax_profiling.loop_lag_snapshot()
    assert profiling.render_prom_lines() == [] == \
        jax_profiling.render_prom_lines()


def _recorder(mod, clock, wall, triggers):
    ids = iter(range(100))
    return mod.FlightRecorder(
        window_s=10.0, cooldown_s=5.0, triggers=triggers, clock=clock,
        wall=wall, id_factory=lambda: f"inc-{next(ids)}",
        include_process_state=False, ring_len=16)


@pytest.mark.parametrize("triggers", ["all", "manual,deadline_storm",
                                      "breaker_open,bogus"])
def test_flight_recorder_cooldown_filter_and_bundle_json(triggers):
    clocks, walls = (Clock(50.0), Clock(50.0)), (Clock(1.7e9), Clock(1.7e9))
    recs = [_recorder(mod, c, w, triggers) for mod, c, w in
            zip((blackbox, jax_blackbox), clocks, walls)]
    for r in recs:
        r.add_source("slo", lambda: {"alert": False, "x": b"\x01"})
    out = []
    for step in range(30):
        for r, c, w in zip(recs, clocks, walls):
            c.t += 0.7
            w.t += 0.7
            r.note("worker-a", "window", batch=step % 4, data=(1, 2))
            if step % 3 == 0:
                r.note("worker-b", "admit", rid=f"r{step}")
        if step % 2:
            for r in recs:
                r.note_deadline()
        trig = ("manual", "breaker_open", "slo_burn_rate")[step % 3]
        bundles = [r.trip(trig, {"step": step}) for r in recs]
        assert (bundles[0] is None) == (bundles[1] is None)
        if bundles[0] is not None:
            out.append(bundles)
            assert blackbox.render_bundle_json(bundles[0]) == \
                jax_blackbox.render_bundle_json(bundles[1])
        assert recs[0].cooldown_remaining_s() == \
            recs[1].cooldown_remaining_s()
    assert recs[0].incidents_summary() == recs[1].incidents_summary()
    assert (recs[0].captures_total, recs[0].suppressed_total) == \
        (recs[1].captures_total, recs[1].suppressed_total)
    assert recs[0].triggers == recs[1].triggers
    if triggers == "breaker_open,bogus":
        assert recs[0].triggers == {"breaker_open"}
    assert out, "no capture at all"
    assert blackbox.capture_header("inc-0", "manual", "w", at_ms=1.0) == \
        jax_blackbox.capture_header("inc-0", "manual", "w", at_ms=1.0)
    off = blackbox.FlightRecorder(window_s=0.0, include_process_state=False)
    assert not off.enabled and off.trip("manual") is None


def test_logging_formatters_match():
    rec = logging.LogRecord("dynamo.x", logging.WARNING, __file__, 1,
                            "hello %s", ("there",), None)
    rec.created = 1.7e9
    for mod in (dyn_logging, jax_logging):
        mod.tracing.bind_request_id("rid-9")
        assert mod.RequestIdFilter().filter(rec)
        mod.tracing.bind_request_id(None)
    assert dyn_logging.JsonlFormatter().format(rec) == \
        jax_logging.JsonlFormatter().format(rec)
    fmt = "%(levelname).1s %(name)s: %(message)s"
    assert dyn_logging.TextFormatter(fmt).format(rec) == \
        jax_logging.TextFormatter(fmt).format(rec) == \
        "W dynamo.x: hello there [rid-9]"
    assert json.loads(dyn_logging.JsonlFormatter().format(rec))[
        "request_id"] == "rid-9"


def test_guard_default_deadline_and_breaker_lines(monkeypatch,
                                                  fresh_planes):
    assert guard.default_deadline() is None
    monkeypatch.setenv("DYN_REQUEST_DEADLINE_MS", "250")
    clock = Clock(10.0)
    d = guard.default_deadline(clock)
    assert d.remaining_ms() == pytest.approx(250.0)
    assert jax_guard.default_deadline(clock).remaining_ms() == \
        pytest.approx(250.0)
    boards = (guard.BreakerBoard("b", clock=clock),
              jax_guard.BreakerBoard("b", clock=clock))
    for b in boards:
        br = b.get("request", 7)
        for _ in range(3):
            br.record_failure()
        assert br.state_name == "open" and b.opened_total() == 1
    assert guard.render_prom_lines() == jax_guard.render_prom_lines()
    assert guard.boards_snapshot() == jax_guard.boards_snapshot()
    assert guard.counters_snapshot() == jax_guard.counters_snapshot()


def test_resolve_model_local_dir_and_offline_cache(tmp_path, monkeypatch):
    assert hub.resolve_model(str(tmp_path)) == str(tmp_path) == \
        jax_hub.resolve_model(str(tmp_path))
    hf = pytest.importorskip("huggingface_hub")
    from huggingface_hub import constants

    cache = tmp_path / "hf"
    rev = "0123456789abcdef0123456789abcdef01234567"
    repo = cache / "models--acme--tiny-llama"
    snap = repo / "snapshots" / rev
    snap.mkdir(parents=True)
    (snap / "config.json").write_text('{"model_type": "llama"}')
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text(rev)
    # the hub offline, both as the environment and as the library's
    # constants (read at its import): nothing can reach a network
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    monkeypatch.setattr(constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(constants, "HF_HUB_CACHE", str(cache))
    got = hub.resolve_model("acme/tiny-llama")
    assert got == jax_hub.resolve_model("acme/tiny-llama")
    assert (tmp_path / got).resolve() == snap.resolve()
    assert hf is not None
    with pytest.raises(RuntimeError, match="cannot resolve model"):
        hub.resolve_model("acme/not-cached")


def test_route_table_is_the_references():
    def routes(svc):
        return sorted((r.method, r.resource.canonical)
                      for r in svc.app.router.routes() if r.method != "HEAD")

    ours = routes(HttpService())
    assert ours == routes(JaxHttpService())
    assert len(ours) == 18
