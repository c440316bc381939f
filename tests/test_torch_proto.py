"""The port's declared lifecycle protocols (``dynamo_tpu_torch/runtime/
proto.py``) and their runtime anchors, on the CPU, against the
reference's registry and cases (``tests/test_proto_fixes.py``).

The port's ``PROTOCOLS`` equals the reference's machine for machine. The
drain withdraws the discovery record before it nacks and withdraws it
once under racing calls; the error frame's delivery absorbs only
connection failures and carries the typed kind. Under
``DYN_PROTO_VALIDATE=1`` the breaker's whole cycle, and a serving
scenario with a drain, a breaker cycle and a mid-stream resume, raise
nothing, while an undeclared transition raises ``ProtocolError``; off,
an anchor is a no-op.
"""

import asyncio
import dataclasses
import re

import pytest

from dynamo_tpu.runtime import proto as ref_proto
from dynamo_tpu_torch.runtime import guard, proto, revive
from dynamo_tpu_torch.runtime.guard import (BREAKER_CLOSED,
                                            BREAKER_HALF_OPEN, BREAKER_OPEN,
                                            BreakerConfig, CircuitBreaker)

LIMIT = 30.0  # seconds: the bound on every await of a remote event


@pytest.fixture(autouse=True)
def _no_proto_validation(monkeypatch):
    monkeypatch.delenv("DYN_PROTO_VALIDATE", raising=False)
    guard.set_chaos(None)
    revive.reset_journal()
    yield
    guard.set_chaos(None)
    revive.reset_journal()


# ------------------------------------------------------------- the registry


def _fields(m) -> dict:
    """A machine's fields; the transfer stream's doc without its
    parenthetical name of the chunked plane, which the port words
    differently."""
    d = dataclasses.asdict(m)
    d["doc"] = re.sub(r" \([^)]*chunked plane\)", "", d["doc"])
    return d


def test_protocols_equal_reference():
    """Machine for machine and field for field."""
    assert sorted(proto.PROTOCOLS) == sorted(ref_proto.PROTOCOLS) == [
        "breaker", "kv_transfer.stream", "planner.pd_shift",
        "request.lifecycle", "revive.journal", "serve_handle.drain"]
    for name, m in proto.PROTOCOLS.items():
        assert _fields(m) == _fields(ref_proto.PROTOCOLS[name]), name
        assert m.edge_pairs == ref_proto.PROTOCOLS[name].edge_pairs


@pytest.mark.parametrize("bad", [
    dict(states=("a",), initial="b"),
    dict(states=("a",), initial="a", terminal=("z",)),
    dict(states=("a", "b"), initial="a",
         edges=({"from": "a", "to": "c"},)),
    dict(states=("a", "b"), initial="a", terminal=("b",),
         edges=({"from": "b", "to": "a"},)),
])
def test_register_protocol_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        proto.register_protocol("t.bad", **bad)
    with pytest.raises(ValueError):
        ref_proto.register_protocol("t.bad", **bad)
    assert "t.bad" not in proto.PROTOCOLS


# ------------------------------------------------------ drain ordering


def test_begin_drain_deletes_discovery_before_nacks_enabled(run_async):
    """The discovery delete completes while the nack flag is still off
    (delete before nack): a request arriving mid-drain is served or goes
    to a sibling, never nacked while routers can still pick this
    instance."""

    async def main():
        from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

        drt = await DistributedRuntime.detached()
        try:
            async def handler(request, ctx):
                yield {"ok": True}

            ep = drt.namespace("order").component("w").endpoint("gen")
            handle = await ep.serve(handler)
            seen = []
            real_delete = drt.dcp.kv_delete

            async def spying_delete(key):
                seen.append(handle.draining)
                await asyncio.sleep(0.01)   # widen the window
                seen.append(handle.draining)
                return await real_delete(key)

            drt.dcp.kv_delete = spying_delete
            await handle.begin_drain()
            assert seen == [False, False]
            assert handle.draining is True
            await handle.stop()
        finally:
            await drt.shutdown()

    run_async(main())


def test_begin_drain_concurrent_single_withdraw(run_async):
    """Two racing begin_drain calls withdraw the record exactly once."""

    async def main():
        from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

        drt = await DistributedRuntime.detached()
        try:
            async def handler(request, ctx):
                yield {"ok": True}

            ep = drt.namespace("order2").component("w").endpoint("gen")
            handle = await ep.serve(handler)
            calls = []
            real_delete = drt.dcp.kv_delete

            async def counting_delete(key):
                calls.append(key)
                await asyncio.sleep(0.01)
                return await real_delete(key)

            drt.dcp.kv_delete = counting_delete
            await asyncio.gather(handle.begin_drain(), handle.begin_drain())
            assert len(calls) == 1
            assert handle.draining is True
            await handle.stop()
        finally:
            await drt.shutdown()

    run_async(main())


# ------------------------------------------------- error-frame delivery


class _StubCallHome:
    """TcpCallHome double: records frames; error() can be rigged to fail
    like a dead connection."""

    def __init__(self, error_exc=None):
        self.sent = []
        self.errors = []
        self.closed = False
        self._error_exc = error_exc

    async def send_data(self, payload):
        self.sent.append(payload)

    async def complete(self):
        pass

    async def error(self, message, kind=None):
        if self._error_exc is not None:
            raise self._error_exc
        self.errors.append((message, kind))

    async def close(self):
        self.closed = True


def _stub_connect(stub):
    class _Stub:
        @staticmethod
        async def connect(conn_info, on_ctrl):
            return stub
    return _Stub


def test_error_frame_conn_failure_absorbed_and_inflight_popped(
        run_async, monkeypatch):
    """A dead call-home connection while delivering the error frame does
    not leak the request from the in-flight table."""

    async def main():
        from dynamo_tpu_torch.runtime import component as comp
        from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

        drt = await DistributedRuntime.detached()
        try:
            async def handler(request, ctx):
                raise ValueError("handler exploded")
                yield  # pragma: no cover — makes this an async generator

            ep = drt.namespace("err").component("w").endpoint("gen")
            handle = await ep.serve(handler)
            stub = _StubCallHome(error_exc=ConnectionError("conn gone"))
            monkeypatch.setattr(comp, "TcpCallHome", _stub_connect(stub))
            await handle._run_request("rid-1", object(), {"x": 1})
            assert "rid-1" not in handle._inflight
            assert stub.closed
            await handle.stop()
        finally:
            await drt.shutdown()

    run_async(main())


def test_error_frame_carries_typed_kind(run_async, monkeypatch):
    """The handler's exception class name crosses the wire as the error
    frame's kind (how the caller re-raises NoCapacity typed), and the
    request ran under its serve span."""

    async def main():
        from dynamo_tpu_torch.runtime import component as comp
        from dynamo_tpu_torch.runtime import tracing
        from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

        tracer = tracing.configure(sample=1.0)
        drt = await DistributedRuntime.detached()
        try:
            async def handler(request, ctx):
                raise guard.NoCapacity("full up")
                yield  # pragma: no cover

            ep = drt.namespace("err2").component("w").endpoint("gen")
            handle = await ep.serve(handler)
            stub = _StubCallHome()
            monkeypatch.setattr(comp, "TcpCallHome", _stub_connect(stub))
            parent = {"trace_id": "e" * 32, "span_id": "f" * 16}
            await handle._run_request("rid-2", object(), {"x": 1}, parent)
            assert stub.errors and stub.errors[0][1] == "NoCapacity"
            (span,) = [s for s in tracer.snapshot() if s.name == "serve.gen"]
            assert span.trace_id == parent["trace_id"]
            assert span.parent_id == parent["span_id"]
            assert span.attributes["request_id"] == "rid-2"
            await handle.stop()
        finally:
            await drt.shutdown()
            tracing.configure(sample=1.0)

    run_async(main())


# ------------------------------------------------- runtime conformance


def test_breaker_full_cycle_conforms_to_declared_machine(monkeypatch):
    """DYN_PROTO_VALIDATE=1: every transition the breaker takes is checked
    against the `breaker` machine; the full cycle raises nothing."""
    monkeypatch.setenv("DYN_PROTO_VALIDATE", "1")
    br = CircuitBreaker(BreakerConfig(threshold=2, probe_every=2))
    assert br.allow() and br.state == BREAKER_CLOSED
    br.record_failure()
    br.record_failure()                    # trip
    assert br.state == BREAKER_OPEN
    assert not br.allow()                  # deny 1
    assert br.allow()                      # deny 2 -> probe granted
    assert br.state == BREAKER_HALF_OPEN
    assert not br.allow()                  # single probe: second denied
    br.release_probe()                     # slot returned
    assert br.allow()                      # re-granted
    br.record_failure()                    # probe failed -> open
    assert br.state == BREAKER_OPEN
    br.reset()                             # external reset -> closed
    assert br.state == BREAKER_CLOSED
    br.record_success()                    # success in closed
    assert br.state == BREAKER_CLOSED


def test_step_rejects_undeclared_transition(monkeypatch):
    monkeypatch.setenv("DYN_PROTO_VALIDATE", "1")
    with pytest.raises(proto.ProtocolError, match="not declared"):
        proto.step("breaker", "closed", "half_open")
    with pytest.raises(proto.ProtocolError, match="unknown state"):
        proto.step("breaker", "closed", "molten")
    with pytest.raises(proto.ProtocolError, match="unknown protocol"):
        proto.step("no-such-machine", "a", "b")
    with pytest.raises(proto.ProtocolError, match="not declared"):
        proto.step("serve_handle.drain", ("live", "stopped"), "draining")
    proto.step("serve_handle.drain", "live", "draining")
    # off by default: the same undeclared transition is a no-op
    monkeypatch.setenv("DYN_PROTO_VALIDATE", "0")
    proto.step("breaker", "closed", "half_open")


def test_journal_close_exactly_once():
    """Every close edge leaves `open`, so a second close is a no-op."""
    ring = revive.ReviveJournal(capacity=4, max_tokens=16)
    ring.open("r1", prompt_tokens=3)
    assert len(ring) == 1
    ring.close("r1")
    assert len(ring) == 0
    ring.close("r1")
    assert len(ring) == 0


def test_serving_scenario_validates_clean(run_async, monkeypatch):
    """DYN_PROTO_VALIDATE=1 over a served scenario: a token stream whose
    worker dies mid-stream resumes on its sibling through the processor's
    resume loop, the dead worker's breaker opens, probes and recovers on
    a fresh discovery put, and the sibling drains and stops. Nothing
    raises, the resumed stream is whole, and the journal is empty."""
    monkeypatch.setenv("DYN_PROTO_VALIDATE", "1")
    calls = []
    real_step = proto.step

    def counting_step(machine, frm, to):
        calls.append((machine, frm, to))
        return real_step(machine, frm, to)

    monkeypatch.setattr(proto, "step", counting_step)

    async def main():
        from dynamo_tpu_torch.llm.processor import _RemoteTokenEngine
        from dynamo_tpu_torch.llm.protocols.common import (
            EngineOutput, PreprocessedRequest, StopConditions)
        from dynamo_tpu_torch.runtime.engine import Context
        from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

        drt = await DistributedRuntime.detached()
        drt2 = await DistributedRuntime.attach(drt.dcp.address)
        try:
            async def handler(request, ctx):
                # token i+1 at position i of the continuation
                pre = PreprocessedRequest.from_dict(request)
                start = len(pre.token_ids) - 2
                n = pre.stop.max_tokens
                for i in range(n):
                    yield EngineOutput(
                        token_ids=[start + i + 1],
                        finish_reason="length" if i == n - 1 else None,
                    ).to_dict()
                    await asyncio.sleep(0.002)

            handles = [await d.namespace("ps").component("w")
                       .endpoint("gen").serve(handler)
                       for d in (drt, drt2)]
            client = await drt.namespace("ps").component("w") \
                .endpoint("gen").client()
            await client.wait_for_instances(timeout=5)
            a, b = (h.instance.instance_id for h in handles)

            async def reroute(tokens, exclude, rid):
                (other,) = {a, b} - set(exclude)
                return other

            guard.set_chaos("seed=1;sever:worker.kill@nth=4")
            eng = _RemoteTokenEngine(client, a, reroute=reroute)
            got = []

            async def run():
                async for out in eng.generate(PreprocessedRequest(
                        token_ids=[0, 0], stop=StopConditions(max_tokens=9)),
                        Context("ps-1")):
                    got.extend(out.token_ids)

            await asyncio.wait_for(run(), LIMIT)
            guard.set_chaos(None)
            assert got == list(range(1, 10))
            assert handles[0]._dead and not handles[1]._dead
            assert len(revive.journal()) == 0
            # the dead worker's breaker: open, a probe, recovery on reset
            br = client.breakers.get("request", a)
            for _ in range(br.cfg.threshold):
                br.record_failure()
            assert br.state == BREAKER_OPEN
            while not br.allow():
                pass
            assert br.state == BREAKER_HALF_OPEN
            br.record_failure()
            br.reset()
            assert br.state == BREAKER_CLOSED
            # the sibling drains and stops
            drained = await revive.drain_worker(handles[1], timeout_s=5.0)
            assert drained
            for h in handles:
                await h.stop()
            await client.close()
        finally:
            await drt2.shutdown()
            await drt.shutdown()

    run_async(main())
    machines = {m for m, _, _ in calls}
    assert {"breaker", "serve_handle.drain"} <= machines, calls
