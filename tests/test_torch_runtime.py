"""The port's distributed runtime against the JAX package's (the
reference), on the CPU: the two-part codec and ``pack`` byte for byte on
seeded frames, each side decoding the other's; the wire registry's
frames; the port's DcpClient against the reference's DcpServer, the
reverse, and the port alone (leases, watches, compare-and-swap, pub/sub,
request/reply, work queues); ``subject_matches``; a served component
end to end, across the packages in both directions and on the port
alone; breakers and the retry policy; and the primary lease outliving a
stalled event loop."""

import asyncio
import time

import numpy as np
import pytest

from dynamo_tpu.runtime import codec as ref_codec
from dynamo_tpu.runtime import dcp_client as ref_client
from dynamo_tpu.runtime import dcp_server as ref_server
from dynamo_tpu.runtime import guard as ref_guard
from dynamo_tpu.runtime import runtime as ref_runtime
from dynamo_tpu.runtime import wire as ref_wire
from dynamo_tpu_torch.runtime import codec, dcp_client, dcp_server, guard
from dynamo_tpu_torch.runtime import runtime as port_runtime
from dynamo_tpu_torch.runtime import wire
from dynamo_tpu_torch.runtime.engine import Context

PKGS = {
    "port": (dcp_client, dcp_server, port_runtime),
    "ref": (ref_client, ref_server, ref_runtime),
}


def _value(rng, depth=0):
    """One random msgpack-able value of the types the frames carry:
    None, bool, ints (negative, small, and uint64 past 2^63, as block
    hashes are), floats, str, bytes, lists and dicts."""
    kinds = ["none", "bool", "int", "u64", "neg", "float", "str", "bytes"]
    if depth < 2:
        kinds += ["list", "dict"]
    k = kinds[rng.randint(len(kinds))]
    if k == "none":
        return None
    if k == "bool":
        return bool(rng.randint(2))
    if k == "int":
        return int(rng.randint(0, 2**31))
    if k == "u64":
        return int(rng.randint(2**62, 2**63 - 1)) * 2 + int(rng.randint(2))
    if k == "neg":
        return -int(rng.randint(1, 2**40))
    if k == "float":
        return float(rng.standard_normal())
    if k == "str":
        return "".join(chr(int(c)) for c in rng.randint(32, 0x2FFF,
                                                         rng.randint(0, 40)))
    if k == "bytes":
        return rng.bytes(int(rng.randint(0, 300)))
    if k == "list":
        return [_value(rng, depth + 1) for _ in range(rng.randint(0, 6))]
    return {f"k{i}": _value(rng, depth + 1) for i in range(rng.randint(0, 6))}


@pytest.mark.parametrize("seed", range(4))
def test_codec_and_pack_bytes_equal_reference(seed):
    rng = np.random.RandomState(seed)
    for _ in range(40):
        header = {f"h{i}": _value(rng) for i in range(rng.randint(1, 6))}
        body = rng.bytes(int(rng.randint(0, 2000)))
        ours = codec.encode(codec.TwoPartMessage(header, body))
        theirs = ref_codec.encode(ref_codec.TwoPartMessage(header, body))
        assert ours == theirs
        parts = codec.encode_parts(header, [body[:7], np.frombuffer(
            body[7:], np.uint8)])
        assert b"".join(bytes(p) for p in parts) == theirs
        # each side decodes the other's frame, with a tail left over
        msg, rest = codec.decode_buffer(theirs + b"tail")
        assert (msg.header, msg.body, rest) == (header, body, b"tail")
        msg, rest = ref_codec.decode_buffer(ours)
        assert (msg.header, msg.body, rest) == (header, body, b"")
        obj = _value(rng)
        assert dcp_client.pack(obj) == ref_client.pack(obj)
        assert dcp_client.unpack(ref_client.pack(obj)) == obj
        assert ref_client.unpack(dcp_client.pack(obj)) == obj
        frame = {"op": "kv_put", "seq": 1, "value": obj}
        assert dcp_server.pack_frame(frame) == ref_server.pack_frame(frame)


def test_codec_rejects_corruption_and_partial_frames():
    buf = codec.encode(codec.TwoPartMessage({"t": "err", "message": "x"},
                                            b"\x00\x01payload\xff"))
    assert codec.decode_buffer(buf[:-1]) == (None, buf[:-1])
    bad = bytearray(buf)
    bad[-1] ^= 0xFF
    with pytest.raises(codec.CodecError):
        codec.decode_buffer(bytes(bad))

    async def read():
        reader = asyncio.StreamReader()
        reader.feed_data(buf)
        return await codec.decode(reader)

    msg = asyncio.run(read())
    assert msg.header == {"t": "err", "message": "x"}


def test_wire_frames_are_the_reference_frames():
    """Every frame the port declares is the reference's frame: name,
    version, discriminator and field rows."""
    assert set(wire.FRAMES) == {
        wire.DCP_REQUEST_ENVELOPE, wire.DCP_REQUEST_ACK,
        wire.DCP_STATS_REPLY, wire.DCP_PUSH_WATCH, wire.DCP_PUSH_MSG,
        wire.DCP_PUSH_REQ, wire.TCP_HELLO, wire.TCP_DATA,
        wire.TCP_COMPLETE, wire.TCP_ERR, wire.TCP_CTRL,
        wire.PREFILL_REMOTE_REQUEST, wire.KV_TRANSFER_BULK,
        wire.KV_TRANSFER_CHUNK, wire.KV_TRANSFER_ABORT,
        wire.KV_TRANSFER_ACK, wire.BLACKBOX_CAPTURE}
    for name, frame in wire.FRAMES.items():
        ref = ref_wire.FRAMES[name]
        assert (frame.version, frame.when) == (ref.version, ref.when)
        assert [tuple(f.__dict__.values()) for f in frame.fields] == \
            [tuple(f.__dict__.values()) for f in ref.fields]


def test_wire_validation_mode(monkeypatch):
    monkeypatch.setenv("DYN_WIRE_VALIDATE", "1")
    hello = {"t": "hello", "subject": "s"}
    assert wire.checked(wire.TCP_HELLO, hello) is hello
    with pytest.raises(wire.WireValidationError):
        wire.checked(wire.TCP_HELLO, {"t": "hello"})
    with pytest.raises(wire.WireValidationError):
        wire.decoded(wire.TCP_CTRL, {"t": "ctrl", "kind": "stop", "x": 1})
    with pytest.raises(wire.UnknownWireFrame):
        codec.encode(codec.TwoPartMessage({"nope": 1}))
    assert wire.infer_frame({"t": "data"}).name == wire.TCP_DATA


SUBJECT_CASES = [
    ("a.b.c", "a.b.c", True), ("a.*.c", "a.b.c", True),
    ("a.*.c", "a.b.d", False), ("a.>", "a.b.c", True), ("a.>", "a.b", True),
    ("a.>", "a", False), ("a.b", "a.b.c", False), ("*", "a", True),
    ("*", "a.b", False), (">", "a.b.c", True), ("a.*", "a", False),
    ("ns.comp.kv_events", "ns.comp.kv_events", True),
    ("stats.ns.c.ep-1000", "stats.ns.c.ep-1001", False),
]


@pytest.mark.parametrize("pattern,subject,want", SUBJECT_CASES)
def test_subject_matches(pattern, subject, want):
    assert dcp_server.subject_matches(pattern, subject) is want
    assert ref_server.subject_matches(pattern, subject) is want


async def _control_plane(client_mod, server_mod):
    """Leases, watches, CAS, pub/sub, request/reply and queues of
    ``client_mod``'s DcpClient against ``server_mod``'s DcpServer."""
    server = await server_mod.DcpServer.start("127.0.0.1", 0)
    c1 = await client_mod.DcpClient.connect(server.address)
    c2 = await client_mod.DcpClient.connect(server.address)
    try:
        # KV
        await c1.kv_put("config/a", b"1")
        assert await c2.kv_get("config/a") == b"1"
        assert await c2.kv_get("config/missing") is None
        assert await c1.kv_create("config/a", b"2") is False
        assert await c1.kv_create("config/b", b"2") is True
        items = await c2.kv_get_prefix("config/")
        assert [(i.key, i.value) for i in items] == [
            ("config/a", b"1"), ("config/b", b"2")]
        # compare-and-swap on mod_rev (0 = must not exist)
        item = await c1.kv_get_item("config/a")
        assert await c1.kv_cas("config/a", b"3", item.mod_rev) is True
        assert await c2.kv_cas("config/a", b"4", item.mod_rev) is False
        assert await c1.kv_get("config/a") == b"3"
        assert await c1.kv_cas("config/c", b"new", 0) is True
        assert await c1.kv_cas("config/c", b"again", 0) is False
        assert await c1.kv_delete_prefix("config/") == 3
        # watch: the snapshot, a put, a delete, then a lease expiry
        lease = await c1.lease_grant(0.4)
        await c1.kv_put("inst/a", b"A", lease=lease)
        items, watch = await c2.kv_watch_prefix("inst/")
        assert [(i.key, i.value, i.lease) for i in items] == [
            ("inst/a", b"A", lease)]
        await c1.kv_put("inst/b", b"B")
        assert await c1.kv_delete("inst/b") is True
        events = []
        async with asyncio.timeout(5):
            async for ev in watch:
                events.append((ev.event, ev.key, ev.value))
                if ev.key == "inst/a":
                    break
        assert events == [("put", "inst/b", b"B"), ("delete", "inst/b", None),
                          ("delete", "inst/a", None)]
        await watch.stop()
        # a renewed lease keeps its keys past its TTL; a revoke drops them
        lease = await c1.lease_grant(0.4)
        await c1.kv_put("inst/c", b"C", lease=lease)
        for _ in range(4):
            await asyncio.sleep(0.2)
            await c1.lease_keepalive(lease)
        assert await c2.kv_get("inst/c") == b"C"
        await c1.lease_revoke(lease)
        assert await c2.kv_get("inst/c") is None
        with pytest.raises(client_mod.DcpError, match="lease"):
            await c1.lease_keepalive(lease)
        # pub/sub with wildcards and a queue group (one member a message)
        got = {"plain": [], "g1": [], "g2": []}

        def sink(tag):
            async def on(msg):
                got[tag].append((msg.subject, msg.payload))
            return on

        await c2.subscribe("ev.*", sink("plain"))
        await c2.subscribe("ev.>", sink("g1"), group="g")
        await c2.subscribe("ev.>", sink("g2"), group="g")
        for i in range(4):
            await c1.publish("ev.x", bytes([i]))
        await c1.publish("ev.x.deep", b"d")
        await asyncio.sleep(0.2)
        assert got["plain"] == [("ev.x", bytes([i])) for i in range(4)]
        # the group alternates its members on one subject ("ev.>" also
        # takes the two-token subject "ev.*" does not)
        assert got["g1"] == [("ev.x", b"\x00"), ("ev.x", b"\x02"),
                             ("ev.x.deep", b"d")]
        assert got["g2"] == [("ev.x", b"\x01"), ("ev.x", b"\x03")]
        # request/reply through a queue group; errors and no responders
        async def upper(msg):
            if msg.payload == b"bad":
                await msg.respond_error("refused")
            else:
                await msg.respond(msg.payload.upper())

        sid = await c2.subscribe("svc.echo", upper, group="workers")
        assert await c1.request("svc.echo", b"hi", timeout=5) == b"HI"
        with pytest.raises(client_mod.DcpError, match="refused"):
            await c1.request("svc.echo", b"bad", timeout=5)
        await c2.unsubscribe(sid)
        with pytest.raises(client_mod.NoRespondersError):
            await c1.request("svc.echo", b"hi", timeout=5)
        # work queue: FIFO, length, and a blocked pull served by a put
        await c1.queue_put("jobs", b"1")
        await c1.queue_put("jobs", b"2")
        assert await c2.queue_len("jobs") == 2
        assert await c2.queue_pull("jobs") == b"1"
        assert await c2.queue_pull("jobs") == b"2"
        assert await c2.queue_pull("jobs") is None
        pull = asyncio.create_task(c2.queue_pull("jobs", timeout=5))
        await asyncio.sleep(0.1)
        await c1.queue_put("jobs", b"3")
        assert await pull == b"3"
        assert await c1.ping() > 0
    finally:
        await c1.close()
        await c2.close()
        await server.stop()


@pytest.mark.parametrize("client,server", [("port", "ref"), ("ref", "port"),
                                           ("port", "port")])
def test_control_plane_across_packages(client, server):
    asyncio.run(_control_plane(PKGS[client][0], PKGS[server][1]))


async def _component(serve_mod, client_mod, dcp_mod):
    """An endpoint served by ``serve_mod``'s runtime and called by
    ``client_mod``'s, on ``dcp_mod``'s control-plane server."""
    server = await dcp_mod.DcpServer.start("127.0.0.1", 0)
    wdrt = await serve_mod.DistributedRuntime.attach(server.address)
    cdrt = await client_mod.DistributedRuntime.attach(server.address)
    try:
        stopped = asyncio.Event()

        async def handler(request, context):
            if request.get("fail"):
                yield {"ok": 1}
                raise ValueError("boom")
            for i in range(int(request["n"])):
                if context.stopped:
                    stopped.set()
                    yield {"stopped_at": i}
                    return
                yield {"i": i, "msg": request["msg"]}
                if request.get("slow"):
                    await asyncio.sleep(0.05)

        comp = wdrt.namespace("test").component("greeter")
        await comp.create_service()
        handle = await comp.endpoint("generate").serve(
            handler, stats_handler=lambda: {"custom": 7})
        client = await cdrt.namespace("test").component("greeter") \
            .endpoint("generate").client()
        ids = await client.wait_for_instances(5)
        assert ids == [wdrt.instance_id]
        stream = await client.round_robin({"n": 3, "msg": "hello"})
        out = [env.data async for env in stream]
        assert out == [{"i": i, "msg": "hello"} for i in range(3)]
        stream = await client.direct({"n": 1, "msg": "d"}, ids[0])
        assert [e.data async for e in stream] == [{"i": 0, "msg": "d"}]
        stream = await client.random({"n": 2, "msg": "r"})
        assert len([e async for e in stream]) == 2
        stats = await client.collect_stats()
        assert stats[ids[0]]["data"] == {"custom": 7}
        assert stats[ids[0]]["subject"] == f"test.greeter.generate-" \
                                           f"{ids[0]:x}"
        # the caller's stop reaches the worker's context mid-stream
        stream = await client.round_robin({"n": 1000, "msg": "s",
                                           "slow": True})
        first = await stream.__anext__()
        assert first.data["i"] == 0
        await stream.stop_generating()
        rest = [e.data async for e in stream]
        assert rest and "stopped_at" in rest[-1]
        assert stopped.is_set()
        # a worker-side ValueError keeps its type across the hop
        stream = await client.round_robin({"fail": True})
        with pytest.raises(ValueError, match="boom"):
            async for _ in stream:
                pass
        # withdrawal removes the instance from discovery
        await handle.stop()
        await asyncio.sleep(0.2)
        assert client.instance_ids() == []
        with pytest.raises(client_mod.NoRespondersError):
            await client.round_robin({"n": 1, "msg": "x"})
        await client.close()
    finally:
        await cdrt.shutdown()
        await wdrt.shutdown()
        await server.stop()


class _Side:
    """One package's runtime and its NoRespondersError."""

    def __init__(self, pkg):
        client, _server, runtime = PKGS[pkg]
        self.DistributedRuntime = runtime.DistributedRuntime
        self.NoRespondersError = client.NoRespondersError


@pytest.mark.parametrize("serve,call", [("port", "port"), ("port", "ref"),
                                        ("ref", "port")])
def test_component_end_to_end(serve, call):
    asyncio.run(_component(_Side(serve), _Side(call), dcp_server))


def test_dead_instance_opens_the_stats_breaker():
    """A served handle that dies (the crashed-but-leased shape) fails the
    stats plane; after the threshold its breaker opens and it leaves the
    scrape targets, and a fresh discovery put closes it again."""

    async def main():
        drt = await port_runtime.DistributedRuntime.detached()
        try:
            ep = drt.namespace("t").component("c").endpoint("e")

            async def handler(request, context):
                yield {"x": 1}

            handle = await ep.serve(handler, stats_handler=lambda: {"a": 1})
            client = await ep.client()
            client.retry = guard.RetryPolicy(max_attempts=1)
            await client.wait_for_instances(5)
            assert await client.collect_stats(timeout=1)
            await handle.die()
            for _ in range(client.STATS_EVICTION_THRESHOLD):
                assert await client.collect_stats(timeout=1) == {}
            assert client.evicted_ids() == [drt.instance_id]
            handle2 = await ep.serve(handler, stats_handler=lambda: {"a": 2})
            await asyncio.sleep(0.2)
            assert client.evicted_ids() == []
            stats = await client.collect_stats(timeout=1)
            assert stats[drt.instance_id]["data"] == {"a": 2}
            await handle2.stop()
            await client.close()
        finally:
            await drt.shutdown()

    asyncio.run(main())


def test_breaker_and_retry_follow_the_reference():
    """The same failure/success sequence drives the port's breaker and the
    reference's through the same states; the retry policy's backoff
    sequence from one seed is the reference's."""
    import random

    clock = [0.0]
    cfg_p = guard.BreakerConfig(threshold=2, probe_every=3, reset_after_s=5)
    cfg_r = ref_guard.BreakerConfig(threshold=2, probe_every=3,
                                    reset_after_s=5)
    bp = guard.CircuitBreaker(cfg_p, clock=lambda: clock[0])
    br = ref_guard.CircuitBreaker(cfg_r, clock=lambda: clock[0])
    rng = np.random.RandomState(0)
    for step in range(200):
        op = rng.randint(5)
        clock[0] += float(rng.uniform(0, 2))
        for b in (bp, br):
            if op == 0:
                b.record_failure()
            elif op == 1:
                b.record_success()
            elif op == 2:
                b.release_probe()
        if op >= 3:
            assert bp.allow() == br.allow(), step
        assert (bp.state, bp.failures, bp.opened_total) == \
            (br.state, br.failures, br.opened_total), step
    rp = guard.RetryPolicy(rng=random.Random(7))
    rr = ref_guard.RetryPolicy(rng=random.Random(7))
    a = b = None
    for _ in range(20):
        a, b = rp.next_backoff(a), rr.next_backoff(b)
        assert a == b
    wire_ms = guard.Deadline.after_s(2.0).to_wire_ms()
    assert 1900 <= wire_ms <= 2000
    assert guard.Deadline.from_wire_ms(None) is None
    assert guard.Deadline.from_wire_ms(0) is None


def test_deadline_travels_and_bounds_the_stream():
    """A deadline set on the caller's context crosses the envelope as the
    budget left; the worker's context sees it, and the caller's stream
    read is cut by it."""

    async def main():
        drt = await port_runtime.DistributedRuntime.detached()
        try:
            seen = {}
            ep = drt.namespace("t").component("c").endpoint("e")

            async def handler(request, context):
                seen["left"] = context.deadline.remaining_s()
                yield {"first": True}
                await asyncio.sleep(5)
                yield {"late": True}

            handle = await ep.serve(handler)
            client = await ep.client()
            await client.wait_for_instances(5)
            ctx = Context(deadline=guard.Deadline.after_s(0.5))
            stream = await client.round_robin({}, context=ctx)
            assert (await stream.__anext__()).data == {"first": True}
            with pytest.raises(guard.DeadlineExceeded):
                await stream.__anext__()
            assert 0 < seen["left"] <= 0.5
            assert ctx.killed
            await handle.stop()
            await client.close()
        finally:
            await drt.shutdown()

    asyncio.run(main())


def test_lease_survives_event_loop_stall():
    """The primary lease outlives synchronous work that blocks the event
    loop for multiples of the TTL (graph capture at warmup, a long
    prefill chunk): the keepalive runs on its own thread and
    connection."""

    async def main():
        server = await dcp_server.DcpServer.start()
        drt = await port_runtime.DistributedRuntime.attach(
            server.address, lease_ttl=0.5)
        try:
            await drt.dcp.kv_put("inst/me", b"alive",
                                 lease=drt.primary_lease)
            time.sleep(2.0)  # blocks the loop for 4x the TTL
            await asyncio.sleep(0.3)  # the reaper ticks with IO pending
            assert await drt.dcp.kv_get("inst/me") == b"alive"
            await asyncio.sleep(1.0)
            assert await drt.dcp.kv_get("inst/me") == b"alive"
            await drt.shutdown()
            # shutdown revoked the lease: the key is gone at once
            c = await dcp_client.DcpClient.connect(server.address)
            assert await c.kv_get("inst/me") is None
            await c.close()
        finally:
            await server.stop()

    asyncio.run(main())


def test_lease_expires_without_keepalive():
    """The control: a lease nobody renews expires within its TTL plus a
    reaper tick, and its keys go with it."""

    async def main():
        server = await dcp_server.DcpServer.start()
        c = await dcp_client.DcpClient.connect(server.address)
        try:
            lease = await c.lease_grant(0.3)
            await c.kv_put("inst/x", b"x", lease=lease)
            await asyncio.sleep(1.0)
            assert await c.kv_get("inst/x") is None
        finally:
            await c.close()
            await server.stop()

    asyncio.run(main())


def test_drain_withdraws_then_finishes_in_flight():
    """begin_drain withdraws the discovery record first, the stats plane
    keeps answering flagged ``draining``, a request that still reaches
    the instance is refused, and the stream already in flight finishes
    before drain() returns True."""

    async def main():
        drt = await port_runtime.DistributedRuntime.detached()
        try:
            ep = drt.namespace("t").component("c").endpoint("e")

            async def handler(request, context):
                for i in range(request["n"]):
                    await asyncio.sleep(0.05)
                    yield {"i": i}

            handle = await ep.serve(handler, stats_handler=lambda: {"a": 1})
            client = await ep.client()
            await client.wait_for_instances(5)
            wid = drt.instance_id
            stream = await client.direct({"n": 6}, wid)
            assert (await stream.__anext__()).data == {"i": 0}
            await handle.begin_drain()
            assert handle.draining and handle.inflight == 1
            await asyncio.sleep(0.2)
            assert client.instance_ids() == []
            stats = await client.collect_stats()
            assert stats == {}  # not discoverable: not a scrape target
            reply = dcp_client.unpack(await drt.dcp.request(
                f"stats.{handle.instance.subject}", b"", timeout=5))
            assert reply["data"] == {"a": 1, "draining": 1}
            subject = handle.instance.subject
            env = dcp_client.pack({"req_id": "late", "conn": {
                "address": "127.0.0.1:1", "subject": "x"},
                "payload": dcp_client.pack({"n": 1})})
            ack = dcp_client.unpack(await drt.dcp.request(subject, env,
                                                          timeout=5))
            assert ack["accepted"] is False
            assert await handle.drain(timeout_s=5) is True
            assert [e.data["i"] async for e in stream] == [1, 2, 3, 4, 5]
            await client.close()
        finally:
            await drt.shutdown()

    asyncio.run(main())
