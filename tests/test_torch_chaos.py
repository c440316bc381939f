"""The port's chaos injection (``dynamo_tpu_torch/runtime/guard.py``), its
transport and worker points, and the flight recorder's chaos fold and
control-plane fan-out, on the CPU, against the reference's cases
(``tests/test_chaos.py``, ``tests/test_revive.py``,
``tests/test_blackbox.py``).

``parse_chaos`` gives rules equal to the reference's, field for field,
and a ``ChaosInjector`` of the same spec fires on the same hits of the
same points under the same seed (its ``random.Random`` is the
reference's). The transport points run against the real planes: a
severed call-home fails the caller's stream typed and fast, a severed
``kv.send`` is hedged onto the queue and the request completes with a
local run's tokens, and a dead transfer plane ends the request at its
deadline. Two tiny TorchEngines at the JAX package's weights; every
await of a remote event is bounded.
"""

import asyncio
import dataclasses
import time

import jax
import numpy as np
import pytest

from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.runtime import guard as ref_guard
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                   StopConditions)
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime import blackbox, guard
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

LIMIT = 30.0  # seconds: the bound on every await of a remote event
ECFG = dict(page_size=8, num_pages=64, max_batch=4, prefill_chunk=32,
            batch_buckets=(1, 2, 4), prefill_buckets=(8, 32),
            page_buckets=(8,), watermark_pages=2)
SPECS = [
    "seed=42;sever:kv.send@after=1;delay:tcp.send@ms=50,p=0.25;"
    "drop:kv.recv@nth=3,times=1",
    "seed=5;sever:worker.kill@nth=4;delay:engine.stall@ms=80,times=2",
    "drop:x.point@p=0.5;sever:x.point@after=3,times=2;delay:y@ms=1.5",
    "seed=9; drop:tcp.connect@nth=1 ; sever:kv.connect@p=0.3,times=4",
]


@pytest.fixture(autouse=True)
def _no_ambient_chaos():
    """Each test opts into chaos explicitly; none leaks between tests."""
    guard.set_chaos(None)
    ref_guard.set_chaos(None)
    yield
    guard.set_chaos(None)
    ref_guard.set_chaos(None)


def rule_fields(rules):
    return [dataclasses.asdict(r) for r in rules]


# ------------------------------------------------------------ the grammar


@pytest.mark.parametrize("spec", SPECS)
def test_parse_chaos_equals_reference(spec):
    seed, rules = guard.parse_chaos(spec)
    ref_seed, ref_rules = ref_guard.parse_chaos(spec)
    assert seed == ref_seed
    assert rule_fields(rules) == rule_fields(ref_rules)


def test_chaos_spec_parse():
    seed, rules = guard.parse_chaos(
        "seed=42;sever:kv.send@after=1;delay:tcp.send@ms=50,p=0.25;"
        "drop:kv.recv@nth=3,times=1")
    assert seed == 42 and len(rules) == 3
    sever, delay, drop = rules
    assert (sever.action, sever.point, sever.after) == ("sever", "kv.send", 1)
    assert (delay.ms, delay.p) == (50.0, 0.25)
    assert (drop.nth, drop.times) == (3, 1)


@pytest.mark.parametrize("bad", ["explode:kv.send", "drop:kv.send@wat=1",
                                 "sever:", "sever:worker.kill@bogus=1"])
def test_chaos_spec_rejects_malformed(bad):
    with pytest.raises(ValueError):
        guard.parse_chaos(bad)
    with pytest.raises(ValueError):
        ref_guard.parse_chaos(bad)


def test_chaos_grammar_worker_points_parse():
    seed, rules = guard.parse_chaos(
        "seed=5;sever:worker.kill@nth=4;delay:engine.stall@ms=80,times=2")
    assert seed == 5 and len(rules) == 2
    kill, stall = rules
    assert (kill.action, kill.point, kill.nth) == ("sever", "worker.kill", 4)
    assert (stall.action, stall.point, stall.ms, stall.times) == \
        ("delay", "engine.stall", 80.0, 2)


# ----------------------------------------------------- the fire sequences


async def _fires(mod, spec, points):
    """Hit ``points`` in order on a fresh injector of ``spec``; each
    hit's outcome (None, the exception's class name or 'delay')."""
    inj = mod.set_chaos(spec)
    for r in inj.rules:
        r.ms = 0.0  # the sequence, not the sleeps
    out = []
    for p in points:
        before = dict(inj.injected)
        try:
            await mod.chaos_point(p)
            out.append("delay" if inj.injected != before else None)
        except Exception as e:  # noqa: BLE001 — recorded and compared
            out.append(type(e).__name__)
    return out, dict(inj.injected), [(r.hits, r.fired) for r in inj.rules]


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234])
def test_injector_fire_sequences_equal_reference(run_async, seed):
    """Per seed, the port's injector fires on exactly the reference's
    hits: the same outcome per hit, the same fire counts, the same
    (hits, fired) per rule."""
    spec = (f"seed={seed};drop:a@p=0.4;sever:a@after=5,p=0.5,times=3;"
            f"delay:b@p=0.7;drop:c@nth=2")
    rng = np.random.RandomState(seed)
    points = [str(p) for p in rng.choice(["a", "b", "c", "d"], 120)]

    async def main():
        mine = await _fires(guard, spec, points)
        theirs = await _fires(ref_guard, spec, points)
        assert mine == theirs
        assert sum(v for v in mine[1].values()) > 0

    run_async(main())


def test_chaos_rules_fire_deterministically(run_async):
    async def main():
        inj = guard.set_chaos("seed=1;drop:x.point@nth=2,times=1")
        await guard.chaos_point("x.point")           # hit 1: no fire
        with pytest.raises(guard.ChaosError):
            await guard.chaos_point("x.point")       # hit 2: drop
        await guard.chaos_point("x.point")           # times=1: spent
        assert inj.injected[("x.point", "drop")] == 1
        assert guard.counter_value("dyn_guard_chaos_injections_total",
                                   point="x.point", action="drop") >= 1

    run_async(main())


def test_chaos_worker_kill_fires_deterministically(run_async):
    async def main():
        inj = guard.set_chaos("seed=1;sever:worker.kill@nth=2,times=1")
        await guard.chaos_point("worker.kill")          # hit 1: no fire
        with pytest.raises(ConnectionResetError):
            await guard.chaos_point("worker.kill")      # hit 2: sever
        await guard.chaos_point("worker.kill")          # times=1: spent
        assert inj.injected[("worker.kill", "sever")] == 1

    run_async(main())


def test_chaos_resolves_from_env_once(monkeypatch):
    """DYN_CHAOS is read on first use: unset is no injector."""
    monkeypatch.setattr(guard, "_CHAOS", False)
    monkeypatch.delenv("DYN_CHAOS", raising=False)
    assert guard.chaos() is None
    monkeypatch.setattr(guard, "_CHAOS", False)
    monkeypatch.setenv("DYN_CHAOS", "seed=3;drop:kv.send@nth=1")
    inj = guard.chaos()
    assert inj is not None and guard.chaos() is inj
    assert inj.rules[0].point == "kv.send"


# ------------------------------------------------------ flight recorder


def test_chaos_snapshot_folds_fire_counts(run_async):
    """The recorder's chaos fold: None without chaos or before any fire,
    then the injector's counts as 'action:point' keys, as the
    reference's fold gives them."""

    async def main():
        assert blackbox._chaos_snapshot() is None
        guard.set_chaos("seed=2;drop:kv.send@nth=1;delay:tcp.send@ms=0")
        assert blackbox._chaos_snapshot() is None
        with pytest.raises(guard.ChaosError):
            await guard.chaos_point("kv.send")
        await guard.chaos_point("tcp.send")
        await guard.chaos_point("tcp.send")
        assert blackbox._chaos_snapshot() == {
            "injected": {"kv.send:drop": 1, "tcp.send:delay": 2}}
        from dynamo_tpu.runtime import blackbox as ref_blackbox

        ref_guard.set_chaos("seed=2;drop:kv.send@nth=1;delay:tcp.send@ms=0")
        with pytest.raises(ref_guard.ChaosError):
            await ref_guard.chaos_point("kv.send")
        await ref_guard.chaos_point("tcp.send")
        await ref_guard.chaos_point("tcp.send")
        assert ref_blackbox._chaos_snapshot() == blackbox._chaos_snapshot()

    run_async(main())


def test_capture_fans_out_over_two_attachments(run_async):
    """broadcast_capture / attach_dcp over two runtime attachments: a
    capture on one recorder opens a remote stub on the other, whose rings
    come back and merge into the origin's incident."""

    async def main():
        drt = await DistributedRuntime.detached()
        drt2 = await DistributedRuntime.attach(drt.dcp.address)
        try:
            rec_a = blackbox.FlightRecorder(window_s=30.0, cooldown_s=0.0)
            rec_b = blackbox.FlightRecorder(window_s=30.0, cooldown_s=0.0)
            rec_b.note("worker-b", "step", n=1)
            await blackbox.attach_dcp(drt, "bb", rec_a, "worker-a")
            await blackbox.attach_dcp(drt2, "bb", rec_b, "worker-b")
            seen = []
            rec_a.add_capture_listener(seen.append)
            bundle = rec_a.trip("manual", {"why": "test"})
            assert bundle is not None and seen == [bundle]
            await blackbox.broadcast_capture(drt, "bb", bundle, "worker-a")
            for _ in range(200):
                mine = rec_a.get(bundle["id"])
                if "worker-b" in mine.get("contributed", []):
                    break
                await asyncio.sleep(0.02)
            stub = rec_b.get(bundle["id"])
            assert stub is not None and stub["remote"]
            assert stub["origin"] == "worker-a"
            mine = rec_a.get(bundle["id"])
            assert mine["contributed"] == ["worker-b"]
            assert "worker-b" in mine["workers"]
        finally:
            await drt2.shutdown()
            await drt.shutdown()

    run_async(main())


# ------------------------------------------------- the request plane


def test_severed_callhome_is_typed_fail_fast(run_async):
    """Chaos severs the worker's call-home mid-stream: the caller's stream
    read raises a typed error promptly, never hangs."""

    async def main():
        drt = await DistributedRuntime.detached()
        try:
            async def handler(request, ctx):
                for i in range(50):
                    yield {"i": i}
                    await asyncio.sleep(0.01)

            ep = drt.namespace("sever").component("w").endpoint("gen")
            handle = await ep.serve(handler)
            client = await ep.client()
            inj = guard.set_chaos("seed=3;sever:tcp.send@nth=4")
            stream = await client.round_robin({"x": 1})
            got = []
            t0 = time.monotonic()
            with pytest.raises(RuntimeError):
                async for env in stream:
                    got.append(env.data)
            assert time.monotonic() - t0 < 10.0
            # the hello frame is hit 1: data frames 1 and 2 went out
            assert len(got) == 2
            assert inj.injected[("tcp.send", "sever")] == 1
            await handle.stop()
            await client.close()
        finally:
            await drt.shutdown()

    run_async(main())


def test_connect_drop_fails_the_request_typed(run_async):
    """A dropped tcp.connect: the worker never calls home, and the
    caller's stream fails with a typed error within the IO bound."""

    async def main():
        drt = await DistributedRuntime.detached()
        try:
            async def handler(request, ctx):
                yield {"ok": True}

            ep = drt.namespace("conn").component("w").endpoint("gen")
            handle = await ep.serve(handler)
            client = await ep.client()
            inj = guard.set_chaos("seed=1;drop:tcp.connect@nth=1")
            ctx = Context("conn-1",
                          deadline=guard.Deadline.after_s(3.0))
            t0 = time.monotonic()
            with pytest.raises((RuntimeError, asyncio.TimeoutError)):
                stream = await client.round_robin({"x": 1}, context=ctx)
                async for _env in stream:
                    pass
            assert time.monotonic() - t0 < 10.0
            assert inj.injected[("tcp.connect", "drop")] == 1
            await handle.stop()
            await client.close()
        finally:
            await drt.shutdown()

    run_async(main())


# ------------------------------------------------ engines and transfers


def tiny(cls):
    return cls.tiny(num_heads=4, num_kv_heads=2, head_dim=8, hidden_size=32,
                    vocab_size=128)


def make_params(seed):
    jparams = jax_init_params(tiny(JaxModelConfig), jax.random.PRNGKey(seed))
    return params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                             tiny(ModelConfig), device="cpu")


def port_engine(tparams):
    return TorchEngine(tiny(ModelConfig), EngineConfig(**ECFG),
                       params=tparams, device="cpu")


def greedy(tokens, max_tokens=6):
    return PreprocessedRequest(token_ids=list(tokens),
                               stop=StopConditions(max_tokens=max_tokens))


async def collect(engine, req, ctx=None):
    toks = []

    async def run():
        async for out in engine.generate(req, ctx or Context()):
            toks.extend(out.token_ids)
            if out.finish_reason is not None:
                return out.finish_reason

    fin = await asyncio.wait_for(run(), LIMIT)
    return toks, fin


def test_engine_stall_chaos_delays_but_completes(run_async):
    """delay:engine.stall stalls the scheduler loop for its ms on its
    first iterations; the request still completes with the unfaulted
    tokens."""

    async def main():
        tparams = make_params(2)
        prompt = list(range(1, 12))
        engine = port_engine(tparams)
        want = await collect(engine, greedy(prompt))
        inj = guard.set_chaos("seed=2;delay:engine.stall@ms=40,times=2")
        t0 = time.monotonic()
        got = await collect(engine, greedy(prompt))
        assert time.monotonic() - t0 >= 0.08
        assert got == want and got[1] == "length"
        assert inj.injected.get(("engine.stall", "delay")) == 2
        await engine.stop()

    run_async(main())


def test_transfer_sever_mid_stream_hedge_recovers(run_async):
    """kv.send severed on the SECOND chunk (a prefill worker dying
    mid-transfer): the connection drop fails the decode waiter fast, the
    job is hedged onto the queue, the second dispatch commits, and the
    request completes remotely with a local run's tokens, well inside the
    prefill timeout."""

    async def main():
        from dynamo_tpu_torch.llm.disagg import DisaggRouter, PrefillWorker
        from dynamo_tpu_torch.llm.disagg.decode import build_disagg_decode

        tparams = make_params(4)
        prompt = [(i * 7) % 100 + 1 for i in range(20)]
        ref = port_engine(tparams)
        want = await collect(ref, greedy(prompt))
        await ref.stop()

        drt = await DistributedRuntime.detached()
        try:
            decode_eng, prefill_eng = port_engine(tparams), \
                port_engine(tparams)
            disagg = await build_disagg_decode(
                drt, decode_eng, namespace="chaos",
                router=DisaggRouter(max_local_prefill_length=4),
                watch_config=False)
            disagg.prefill_timeout = 30.0      # the hedge must beat this
            pw = PrefillWorker(drt, prefill_eng, namespace="chaos",
                               chunk_pages=1)
            # one attempt a dispatch: the recovery under test is the
            # decode side's hedge, not the worker's own send retry
            pw.retry = guard.RetryPolicy(max_attempts=1)
            pw.start()
            guard.set_chaos("seed=7;sever:kv.send@nth=2")
            t0 = time.monotonic()
            got = await collect(disagg, greedy(prompt))
            elapsed = time.monotonic() - t0
            assert got == want
            assert disagg.redispatches == 1
            assert disagg.remote_fallbacks == 0
            assert pw.failed == 1 and pw.completed == 1
            assert elapsed < 15.0, f"hedge took {elapsed:.1f}s"
            await pw.stop()
            await disagg.transfer.stop()
            await prefill_eng.stop()
            await decode_eng.stop()
        finally:
            await drt.shutdown()

    run_async(main())


def test_transfer_dead_plane_respects_deadline(run_async):
    """Every kv.send severed before its first frame: the decode side
    never hears a fail-fast, so the request budget bounds the wait and
    the request finishes "timeout" near its deadline, not at the prefill
    timeout."""

    async def main():
        from dynamo_tpu_torch.llm.disagg import DisaggRouter, PrefillWorker
        from dynamo_tpu_torch.llm.disagg.decode import build_disagg_decode

        tparams = make_params(4)
        drt = await DistributedRuntime.detached()
        try:
            decode_eng, prefill_eng = port_engine(tparams), \
                port_engine(tparams)
            disagg = await build_disagg_decode(
                drt, decode_eng, namespace="dead",
                router=DisaggRouter(max_local_prefill_length=4),
                watch_config=False)
            disagg.prefill_timeout = 30.0     # far past the budget
            pw = PrefillWorker(drt, prefill_eng, namespace="dead",
                               chunk_pages=1)
            pw.start()
            guard.set_chaos("seed=13;sever:kv.send@after=1")
            prompt = [(i * 7) % 100 + 1 for i in range(20)]
            ctx = Context("dead-req", deadline=guard.Deadline.after_s(2.5))
            t0 = time.monotonic()
            _, fin = await collect(disagg, greedy(prompt), ctx)
            elapsed = time.monotonic() - t0
            assert fin == "timeout"
            assert elapsed < 8.0, f"outlived its budget ({elapsed:.1f}s)"
            assert disagg.remote_fallbacks == 1
            await pw.stop()
            await disagg.transfer.stop()
            await prefill_eng.stop()
            await decode_eng.stop()
        finally:
            await drt.shutdown()

    run_async(main())


def test_kv_recv_drop_fails_fast_then_hedges(run_async):
    """A kv.recv drop on the receiver's second frame: the connection the
    stream came in on dies, its uncommitted stream fails the decode
    waiter at once, and the hedged dispatch, on the same prefill worker
    while the first send unwinds, completes the request with a local
    run's tokens (no frame is written to the lost connection, whose
    stale write handler would hang the next connect)."""

    async def main():
        from dynamo_tpu_torch.llm.disagg import DisaggRouter, PrefillWorker
        from dynamo_tpu_torch.llm.disagg.decode import build_disagg_decode

        tparams = make_params(6)
        prompt = [(i * 5) % 90 + 2 for i in range(20)]
        ref = port_engine(tparams)
        want = await collect(ref, greedy(prompt))
        await ref.stop()
        drt = await DistributedRuntime.detached()
        try:
            decode_eng, prefill_eng = port_engine(tparams), \
                port_engine(tparams)
            disagg = await build_disagg_decode(
                drt, decode_eng, namespace="recv",
                router=DisaggRouter(max_local_prefill_length=4),
                watch_config=False)
            disagg.prefill_timeout = 30.0
            pw = PrefillWorker(drt, prefill_eng, namespace="recv",
                               chunk_pages=1)
            pw.retry = guard.RetryPolicy(max_attempts=1)
            pw.start()
            # three 1-page chunks: the first registers the stream
            inj = guard.set_chaos("seed=1;drop:kv.recv@nth=2")
            t0 = time.monotonic()
            got = await collect(disagg, greedy(prompt))
            assert got == want
            assert time.monotonic() - t0 < 15.0
            assert inj.injected[("kv.recv", "drop")] == 1
            assert disagg.redispatches == 1
            assert disagg.remote_fallbacks == 0
            await pw.stop()
            await disagg.transfer.stop()
            await prefill_eng.stop()
            await decode_eng.stop()
        finally:
            await drt.shutdown()

    run_async(main())


def test_write_frame_refuses_a_lost_connection(run_async):
    """The transfer client's frame write raises on a connection the
    event loop already saw die, instead of handing the frame to a lost
    transport."""

    async def main():
        from dynamo_tpu_torch.llm.disagg.transfer import _write_frame

        got = asyncio.Event()

        async def on_conn(reader, writer):
            writer.close()
            got.set()

        server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        await asyncio.wait_for(got.wait(), LIMIT)
        assert await asyncio.wait_for(reader.read(), LIMIT) == b""
        for _ in range(100):  # the peer's close reaches this transport
            try:
                _write_frame(writer, {"kind": "abort", "request_id": "r"},
                             [b"x" * 65536])
            except ConnectionResetError:
                break
            await asyncio.sleep(0.01)
        else:
            pytest.fail("a write to the lost connection never raised")
        assert writer.is_closing()
        writer.close()
        server.close()
        await server.wait_closed()

    run_async(main())
