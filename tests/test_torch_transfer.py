"""The port's KV transfer plane (``dynamo_tpu_torch/llm/disagg``) against
the reference's, with no engine.

The five disaggregation frames are the reference's registry entries and,
on a real connection, the bytes both directions carry are the
reference's; the remote-prefill job and the router's decisions and live
reconfiguration are the reference's; the int8 host forms are bitwise
the reference's in float32, bfloat16 and float16; and the failure cases
of ``tests/test_transfer_stream.py`` hold on the port's client and
server (a recording fake engine stands in for ``inject_pages``). Every
await on a remote event is bounded, so a hang fails fast.
"""

import asyncio
import json
import time

import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import kv_compress as ref_compress
from dynamo_tpu.llm.disagg import protocols as ref_protocols
from dynamo_tpu.llm.disagg import router as ref_router
from dynamo_tpu.llm.disagg import transfer as ref_transfer
from dynamo_tpu.runtime import codec as ref_codec
from dynamo_tpu.runtime import wire as ref_wire
from dynamo_tpu_torch.engine import kv_compress
from dynamo_tpu_torch.llm.disagg import (DisaggRouter, KvTransferClient,
                                         KvTransferServer,
                                         RemotePrefillRequest, TransferStats)
from dynamo_tpu_torch.llm.disagg.router import publish_config
from dynamo_tpu_torch.llm.disagg.transfer import encode_pages
from dynamo_tpu_torch.runtime import codec, wire
from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

SHAPE = (2, 1, 2, 4, 8)  # [L, n=1 page per unit, KV, ps, hd]
LIMIT = 10.0  # seconds: the bound on every await of a remote event
NEW_FRAMES = (wire.PREFILL_REMOTE_REQUEST, wire.KV_TRANSFER_BULK,
              wire.KV_TRANSFER_CHUNK, wire.KV_TRANSFER_ABORT,
              wire.KV_TRANSFER_ACK)


def bounded(aw, limit=LIMIT):
    return asyncio.wait_for(aw, limit)


class FakeEngine:
    """Page-keyed sink standing in for TorchEngine.inject_pages."""

    def __init__(self, fail_on_page=None):
        self.pages = {}
        self.fail_on_page = fail_on_page
        self.inject_calls = 0

    async def inject_pages(self, page_ids, k, v):
        self.inject_calls += 1
        if self.fail_on_page is not None and self.fail_on_page in page_ids:
            raise RuntimeError(f"boom on page {self.fail_on_page}")
        k, v = torch.as_tensor(k), torch.as_tensor(v)
        for i, p in enumerate(page_ids):
            self.pages[int(p)] = (k[:, i].clone(), v[:, i].clone())


class RefFakeEngine(FakeEngine):
    async def inject_pages(self, page_ids, k, v):
        await super().inject_pages(page_ids, torch.from_numpy(
            np.array(k, np.float32)), torch.from_numpy(
                np.array(v, np.float32)))


def _pages(n, seed=0):
    rng = np.random.RandomState(seed)
    shape = (SHAPE[0], n) + SHAPE[2:]
    return ((rng.randn(*shape) * 0.3).astype(np.float32),
            (rng.randn(*shape) * 0.3).astype(np.float32))


async def _frames(page_ids, k, v, chunk_pages, compress=False):
    """Chunk producer shaped as PrefillWorker._frames, fed from arrays."""
    for off in range(0, len(page_ids), chunk_pages):
        yield (page_ids[off:off + chunk_pages],
               *encode_pages(k[:, off:off + chunk_pages],
                             v[:, off:off + chunk_pages], compress))


async def _ref_frames(page_ids, k, v, chunk_pages, compress=False):
    """The reference's chunk producer (tests/test_transfer_stream.py)."""
    for off in range(0, len(page_ids), chunk_pages):
        kc = np.ascontiguousarray(k[:, off:off + chunk_pages])
        vc = np.ascontiguousarray(v[:, off:off + chunk_pages])
        dst = page_ids[off:off + chunk_pages]
        extra = {"shape": list(kc.shape), "dtype": str(kc.dtype),
                 "k_len": kc.nbytes}
        if compress:
            kq, ks = ref_compress.quantize_pages_np(kc)
            vq, vs = ref_compress.quantize_pages_np(vc)
            extra.update(quant="int8", k_len=kq.nbytes)
            yield dst, extra, [kq, vq, ks, vs], (kq.nbytes + vq.nbytes
                                                 + ks.nbytes + vs.nbytes)
        else:
            yield dst, extra, [kc, vc], kc.nbytes + vc.nbytes


def n_chunks(n_pages, cp):
    return -(-n_pages // cp)


async def _server(engine=None):
    server = KvTransferServer(engine or FakeEngine())
    await server.start(host="127.0.0.1")
    return server


def _assert_landed(eng, dst, k, v):
    for i, p in enumerate(dst):
        assert torch.equal(eng.pages[p][0], torch.from_numpy(k[:, i]))
        assert torch.equal(eng.pages[p][1], torch.from_numpy(v[:, i]))


# ---------------------------------------------------------- wire and bytes


def test_new_frames_are_the_reference_frames():
    for name in NEW_FRAMES:
        frame, ref = wire.FRAMES[name], ref_wire.FRAMES[name]
        assert (frame.version, frame.doc, frame.when) == \
            (ref.version, ref.doc, ref.when)
        assert [tuple(f.__dict__.values()) for f in frame.fields] == \
            [tuple(f.__dict__.values()) for f in ref.fields]
        assert wire.frame_version(name) == ref_wire.frame_version(name)


class Tap:
    """A TCP proxy recording the bytes each direction carries."""

    def __init__(self, port):
        self.port = port
        self.up = bytearray()
        self.down = bytearray()

    async def start(self):
        self.server = await asyncio.start_server(self._on, "127.0.0.1", 0)
        self.listen = self.server.sockets[0].getsockname()[1]

    async def _on(self, r, w):
        ur, uw = await asyncio.open_connection("127.0.0.1", self.port)

        async def pipe(src, dst, buf):
            while data := await src.read(1 << 16):
                buf += data
                dst.write(data)
                await dst.drain()
            dst.close()

        await asyncio.gather(pipe(r, uw, self.up), pipe(ur, w, self.down),
                             return_exceptions=True)

    async def stop(self):
        self.server.close()


def _frames_of(buf: bytes) -> list:
    out = []
    while buf:
        msg, buf = codec.decode_buffer(bytes(buf))
        out.append(msgpack.packb(msg.header, use_bin_type=True) + msg.body)
    return out


async def _tapped_run(server_cls, client_cls, engine, frames_fn):
    """Bulk (raw and int8), a 2-chunk stream (raw and int8), an aborted
    stream and a last bulk send through a tap; returns (client->server,
    server->client) bytes."""
    server = server_cls(engine)
    await server.start(host="127.0.0.1")
    tap = Tap(server.port)
    await tap.start()
    client = client_cls("127.0.0.1", tap.listen)
    k, v = _pages(3, seed=30)
    try:
        for i, compress in enumerate((False, True)):
            fut = server.expect(f"b{i}")
            await bounded(client.send_kv(f"b{i}", [4, 5, 6], k, v,
                                         first_token=9, compress=compress))
            assert await bounded(fut) == 9
            fut = server.expect(f"c{i}")
            await bounded(client.send_kv_chunked(
                f"c{i}", 2, frames_fn([1, 2, 3], k, v, 2, compress),
                first_token=7))
            assert await bounded(fut) == 7
        fut = server.expect("a")

        async def broken():
            agen = frames_fn([1, 2, 3], k, v, 2)
            yield await agen.__anext__()
            raise RuntimeError("extract exploded")

        with pytest.raises(RuntimeError, match="exploded"):
            await bounded(client.send_kv_chunked("a", 2, broken(), 0))
        with pytest.raises(RuntimeError, match="aborted"):
            await bounded(fut)
        # one more send: its ack follows every earlier ack down the tap
        fut = server.expect("z")
        await bounded(client.send_kv("z", [8], k[:, :1], v[:, :1], 3))
        assert await bounded(fut) == 3
    finally:
        client.close()
        await bounded(server.stop())
        await tap.stop()
    return bytes(tap.up), bytes(tap.down)


def test_transfer_bytes_are_the_reference_bytes(run_async):
    """The same sends through the port's client and server and through
    the reference's carry the same bytes both ways: every bulk, chunk,
    int8, abort and ack frame, headers and bodies."""
    async def main():
        port = await _tapped_run(KvTransferServer, KvTransferClient,
                                 FakeEngine(), _frames)
        ref = await _tapped_run(ref_transfer.KvTransferServer,
                                ref_transfer.KvTransferClient,
                                RefFakeEngine(), _ref_frames)
        return port, ref

    (up, down), (rup, rdown) = run_async(main())
    assert len(_frames_of(up)) == 9 and len(_frames_of(down)) == 8
    assert _frames_of(up) == _frames_of(rup)
    assert _frames_of(down) == _frames_of(rdown)


@pytest.mark.parametrize("sender", ["port", "reference"])
def test_bfloat16_pages_cross_frameworks_bitwise(run_async, sender):
    """bfloat16 pages sent by one framework land bitwise in the other's
    receiver (raw bytes; the header names "bfloat16")."""
    rng = np.random.RandomState(31)
    k32 = rng.randn(2, 3, 2, 4, 8).astype(np.float32)
    kb = k32.astype(ml_dtypes.bfloat16)
    vb = (-k32).astype(ml_dtypes.bfloat16)

    async def main():
        if sender == "port":
            got = {}

            class RefSink:
                async def inject_pages(self, page_ids, k, v):
                    got["k"], got["v"] = k, v

            server = ref_transfer.KvTransferServer(RefSink())
            await server.start(host="127.0.0.1")
            client = KvTransferClient("127.0.0.1", server.port)
            kt = torch.from_numpy(kb.view(np.int16)).view(torch.bfloat16)
            vt = torch.from_numpy(vb.view(np.int16)).view(torch.bfloat16)
            fut = server.expect("x")
            await bounded(client.send_kv("x", [1, 2, 3], kt, vt, 5))
            assert await bounded(fut) == 5
            assert got["k"].dtype == kb.dtype
            out = (got["k"].view(np.int16), got["v"].view(np.int16))
        else:
            eng = FakeEngine()
            server = await _server(eng)
            client = ref_transfer.KvTransferClient("127.0.0.1", server.port)
            fut = server.expect("x")
            # the reference's bulk header; its body goes as the arrays'
            # bytes (the reference's encode_parts takes a memoryview of
            # each part, which numpy refuses for an ml_dtypes array)
            header, _ = ref_transfer._bulk_frame("x", [1, 2, 3], kb, vb, 5,
                                                 compress=False)
            assert header["dtype"] == "bfloat16"
            q = client._register("x")
            writer = await bounded(client._ensure())
            writer.writelines(ref_codec.encode_parts(
                header, [kb.view(np.uint8), vb.view(np.uint8)]))
            await bounded(writer.drain())
            assert (await bounded(q.get()))["ok"] is True
            assert await bounded(fut) == 5
            assert eng.pages[1][0].dtype == torch.bfloat16
            out = tuple(torch.stack([eng.pages[p][j] for p in (1, 2, 3)],
                                    dim=1).view(torch.int16).numpy()
                        for j in (0, 1))
        client.close()
        await bounded(server.stop())
        return out

    k, v = run_async(main())
    np.testing.assert_array_equal(k, kb.view(np.int16))
    np.testing.assert_array_equal(v, vb.view(np.int16))


# ---------------------------------------------- the job, router, compression


@pytest.mark.parametrize("extra", [{}, {"deadline_ms": 1500},
                                   {"trace_ctx": {"trace_id": "t",
                                                  "span_id": "s"}}])
def test_remote_prefill_request_is_the_reference_frame(extra, monkeypatch):
    monkeypatch.setenv("DYN_WIRE_VALIDATE", "1")
    kw = dict(request_id="r1", token_ids=[1, 2, 3],
              sampling={"temperature": 0.5}, eos_token_ids=[0],
              page_ids=[4, 5], skip_pages=1, engine_id=7, **extra)
    got = RemotePrefillRequest(**kw).to_dict()
    want = ref_protocols.RemotePrefillRequest(**kw).to_dict()
    assert json.dumps(got) == json.dumps(want)
    assert RemotePrefillRequest.from_dict(want) == RemotePrefillRequest(**kw)
    assert ref_protocols.RemotePrefillRequest.from_dict(got) == \
        ref_protocols.RemotePrefillRequest(**kw)


ROUTER_CONFIGS = [dict(max_local_prefill_length=100),
                  dict(max_local_prefill_length=100,
                       max_prefill_queue_size=2),
                  dict(enabled=False), dict(max_local_prefill_length=0)]


@pytest.mark.parametrize("cfg", ROUTER_CONFIGS)
def test_router_decisions_are_the_reference_decisions(cfg):
    port, ref = DisaggRouter(**cfg), ref_router.DisaggRouter(**cfg)
    for n in (0, 50, 100, 101, 500, 10_000):
        for hit in (0, 1, 64, 450, n):
            for depth in (0, 1, 2, 5):
                assert port.prefill_remote(n, hit, depth) == \
                    ref.prefill_remote(n, hit, depth), (n, hit, depth)


def test_router_live_reconfig_both_ways(run_async):
    """Port and reference routers follow the same DCP key; a config
    published by either side's publish_config reconfigures both."""
    async def main():
        drt = await DistributedRuntime.detached()
        try:
            port = DisaggRouter(max_local_prefill_length=100)
            ref = ref_router.DisaggRouter(max_local_prefill_length=100)
            await bounded(port.start_watch(drt.dcp, "test", "m"))
            await bounded(ref.start_watch(drt.dcp, "test", "m"))
            states = []
            for publish, cfg in (
                    (publish_config, dict(max_local_prefill_length=5000,
                                          max_prefill_queue_size=3)),
                    (ref_router.publish_config,
                     dict(max_local_prefill_length=7, enabled=False,
                          max_prefill_queue_size=None))):
                await bounded(publish(drt.dcp, "test", "m", **cfg))
                t0 = time.monotonic()
                while time.monotonic() - t0 < LIMIT and not all(
                        r.max_local_prefill_length ==
                        cfg["max_local_prefill_length"] for r in (port, ref)):
                    await asyncio.sleep(0.01)
                states.append([(r.max_local_prefill_length,
                                r.max_prefill_queue_size, r.enabled)
                               for r in (port, ref)])
            port.stop()
            ref.stop()
            return states
        finally:
            await drt.shutdown()

    states = run_async(main())
    assert states == [[(5000, 3, True)] * 2, [(7, None, False)] * 2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_kv_compress_host_forms_bitwise(dtype):
    """quantize_pages_np and dequantize_pages_np give the reference's
    bytes in each pool dtype (bfloat16 through ml_dtypes there, through
    torch here)."""
    rng = np.random.RandomState(32)
    a32 = (rng.randn(2, 3, 2, 4, 16) * 3).astype(np.float32)
    a32[0, 0, 0, 0] = 0.0  # an all-zero row takes the scale floor
    np_dt = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
             "float16": np.float16}[dtype]
    t_dt = getattr(torch, dtype)
    ref_pages = a32.astype(np_dt)
    pages = torch.from_numpy(a32).to(t_dt)
    np.testing.assert_array_equal(pages.float().numpy(),
                                  ref_pages.astype(np.float32))
    q, s = kv_compress.quantize_pages_np(pages)
    rq, rs = ref_compress.quantize_pages_np(ref_pages)
    assert q.dtype == rq.dtype and s.dtype == rs.dtype
    np.testing.assert_array_equal(q, rq)
    np.testing.assert_array_equal(s.view(np.int32), rs.view(np.int32))
    back = kv_compress.dequantize_pages_np(q, s, t_dt)
    rback = ref_compress.dequantize_pages_np(rq, rs, np_dt)
    assert back.dtype == t_dt
    bits = np.int16 if dtype != "float32" else np.int32
    np.testing.assert_array_equal(
        back.view(torch.int16 if bits is np.int16 else torch.int32).numpy(),
        rback.view(bits))
    # the element error is at most s/2 (float32; 16 bits adds rounding)
    if dtype == "float32":
        assert np.all(np.abs(back.numpy() - a32) <= s / 2 + 1e-7)


# ------------------------------------------------------ the failure cases


def test_chunked_stream_roundtrip(run_async):
    """A multi-chunk stream lands every page exactly and resolves the
    waiter only on the final commit chunk."""
    async def main():
        eng = FakeEngine()
        server = await _server(eng)
        k, v = _pages(5, seed=1)
        dst = [10, 11, 12, 13, 14]
        client = KvTransferClient("127.0.0.1", server.port)
        fut = server.expect("r1")
        await bounded(client.send_kv_chunked(
            "r1", n_chunks(5, 2), _frames(dst, k, v, 2), first_token=99))
        assert await bounded(fut) == 99
        assert (server.chunks_ingested, server.pages_ingested) == (3, 5)
        assert not server._ingests
        _assert_landed(eng, dst, k, v)
        client.close()
        await bounded(server.stop())

    run_async(main())


@pytest.mark.parametrize("mode", ["chunked", "bulk"])
def test_interleaved_sends_one_connection_concurrent_progress(run_async,
                                                             mode):
    """Two requests share ONE connection; a slow inject for request A
    does not hold back request B's commit (acks demultiplexed by
    request_id), in chunked and in bulk mode."""
    async def main():
        eng = FakeEngine()
        server = await _server(eng)
        real = eng.inject_pages

        async def slow_inject(page_ids, k, v):
            if 0 in page_ids:  # request A's pages
                await asyncio.sleep(0.5)
            await real(page_ids, k, v)

        eng.inject_pages = slow_inject
        client = KvTransferClient("127.0.0.1", server.port)
        ka, va = _pages(4, seed=2)
        kb, vb = _pages(4, seed=3)
        fut_a, fut_b = server.expect("a"), server.expect("b")
        t0 = time.monotonic()
        done_at = {}

        async def send(rid, dst, k, v):
            if mode == "chunked":
                await client.send_kv_chunked(
                    rid, n_chunks(4, 2), _frames(dst, k, v, 2),
                    first_token=1)
            else:
                await client.send_kv(rid, dst, k, v, first_token=1)
            done_at[rid] = time.monotonic() - t0

        await bounded(asyncio.gather(send("a", [0, 1, 2, 3], ka, va),
                                     send("b", [20, 21, 22, 23], kb, vb)))
        assert await bounded(fut_a) == 1 and await bounded(fut_b) == 1
        assert done_at["b"] < 0.45 <= done_at["a"], done_at
        _assert_landed(eng, [0, 1, 2, 3], ka, va)
        _assert_landed(eng, [20, 21, 22, 23], kb, vb)
        client.close()
        await bounded(server.stop())

    run_async(main())


@pytest.mark.parametrize("mode", ["chunked", "bulk"])
def test_ingest_failure_fails_waiter_immediately(run_async, mode):
    """A decode-side inject error fails the waiter now and nacks the
    sender."""
    async def main():
        server = await _server(FakeEngine(fail_on_page=12))
        client = KvTransferClient("127.0.0.1", server.port)
        k, v = _pages(4, seed=6)
        fut = server.expect("r")
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="ingest failed"):
            if mode == "chunked":
                await bounded(client.send_kv_chunked(
                    "r", n_chunks(4, 2), _frames([10, 11, 12, 13], k, v, 2),
                    first_token=0, timeout=30.0))
            else:
                await bounded(client.send_kv("r", [10, 11, 12, 13], k, v,
                                             first_token=0))
        with pytest.raises(RuntimeError, match="boom"):
            await bounded(fut, 1)
        assert time.monotonic() - t0 < 5
        assert server.streams_failed >= 1
        client.close()
        await bounded(server.stop())

    run_async(main())


def test_connection_drop_mid_stream_releases_state(run_async):
    """Killing the connection between chunks fails the waiter at once and
    tears down the server's partial ingest state."""
    async def main():
        server = await _server()
        client = KvTransferClient("127.0.0.1", server.port)
        k, v = _pages(6, seed=8)
        fut = server.expect("r")

        async def two_chunks_then_die():
            i = 0
            async for item in _frames([1, 2, 3, 4, 5, 6], k, v, 2):
                yield item
                i += 1
                if i == 2:
                    client._writer.close()  # the sender crashes
                    await asyncio.sleep(0.05)

        with pytest.raises(Exception):
            await bounded(client.send_kv_chunked(
                "r", 3, two_chunks_then_die(), first_token=0, timeout=5.0))
        with pytest.raises(ConnectionError):
            await bounded(fut, 2)
        await asyncio.sleep(0.05)
        assert not server._ingests and "r" not in server._waiters
        assert server.streams_failed >= 1
        client.close()
        await bounded(server.stop())

    run_async(main())


def test_abort_frame_tears_down_stream(run_async):
    """A producer error aborts the stream: the server drops partial state
    and fails the waiter, and the connection keeps serving."""
    async def main():
        server = await _server()
        client = KvTransferClient("127.0.0.1", server.port)
        k, v = _pages(4, seed=9)
        fut = server.expect("r")

        async def broken_producer():
            agen = _frames([1, 2, 3, 4], k, v, 2)
            yield await agen.__anext__()
            raise RuntimeError("extract exploded")

        with pytest.raises(RuntimeError, match="extract exploded"):
            await bounded(client.send_kv_chunked("r", 2, broken_producer(),
                                                 first_token=0))
        with pytest.raises(RuntimeError, match="aborted"):
            await bounded(fut, 2)
        await asyncio.sleep(0.05)
        assert not server._ingests
        k2, v2 = _pages(2, seed=10)
        fut2 = server.expect("r2")
        await bounded(client.send_kv_chunked(
            "r2", 1, _frames([7, 8], k2, v2, 2), first_token=3))
        assert await bounded(fut2, 2) == 3
        client.close()
        await bounded(server.stop())

    run_async(main())


def test_late_chunk_after_cancel_never_writes(run_async):
    """Once the decode side cancels (its pages may be reassigned), chunks
    that arrive are dropped, not injected."""
    async def main():
        eng = FakeEngine()
        server = await _server(eng)
        client = KvTransferClient("127.0.0.1", server.port)
        k, v = _pages(4, seed=11)
        fut = server.expect("r")

        async def cancel_after_first():
            agen = _frames([1, 2, 3, 4], k, v, 2)
            yield await agen.__anext__()
            t0 = time.monotonic()
            while 2 not in eng.pages and time.monotonic() - t0 < LIMIT:
                await asyncio.sleep(0.005)
            server.cancel("r")
            yield await agen.__anext__()

        with pytest.raises(RuntimeError, match="unknown/cancelled"):
            await bounded(client.send_kv_chunked(
                "r", 2, cancel_after_first(), first_token=0))
        assert fut.cancelled()
        assert 1 in eng.pages and 2 in eng.pages
        assert 3 not in eng.pages and 4 not in eng.pages
        client.close()
        await bounded(server.stop())

    run_async(main())


@pytest.mark.parametrize("frame", [
    {"kind": "zstd-delta", "request_id": "rx", "page_ids": [1]},
    {"kind": "chunk", "request_id": "rx", "chunk_idx": 0, "n_chunks": 1,
     "page_ids": [], "shape": [], "dtype": "float32", "k_len": 0,
     "first_token": 0, "v": 99}], ids=["unknown_kind", "newer_version"])
def test_foreign_frame_rejected_typed(run_async, frame):
    """A frame of an unknown kind or a newer schema version is refused
    with a typed error: the waiter fails fast, the sender gets a nack,
    nothing is injected, and the connection keeps serving."""
    async def main():
        eng = FakeEngine()
        server = await _server(eng)
        client = KvTransferClient("127.0.0.1", server.port)
        fut = server.expect("rx")
        await bounded(client._ensure())
        q = client._register("rx")
        client._writer.writelines(codec.encode_parts(frame))
        await bounded(client._writer.drain())
        ack = await bounded(q.get())
        assert ack["ok"] is False and "unsupported" in ack["error"]
        assert f"v={frame.get('v', 1)}" in ack["error"]
        with pytest.raises(wire.WireVersionMismatch):
            await bounded(fut, 1)
        assert server.streams_failed >= 1 and not eng.pages
        k, v = _pages(2, seed=22)
        fut2 = server.expect("ry")
        await bounded(client.send_kv_chunked(
            "ry", 1, _frames([7, 8], k, v, 2), first_token=3))
        assert await bounded(fut2) == 3
        client.close()
        await bounded(server.stop())

    run_async(main())


def test_sender_stage_stats_accumulate(run_async):
    """The sender's per-stage breakdown counts every chunk and byte."""
    async def main():
        server = await _server()
        stats = TransferStats()
        client = KvTransferClient("127.0.0.1", server.port, stats=stats)
        k, v = _pages(4, seed=12)
        fut = server.expect("r")
        await bounded(client.send_kv_chunked(
            "r", n_chunks(4, 1), _frames([1, 2, 3, 4], k, v, 1),
            first_token=0))
        await bounded(fut, 2)
        assert stats.chunks_sent == 4 and stats.sends == 1
        assert stats.bytes_sent == k.nbytes + v.nbytes
        assert stats.wall_seconds > 0 and stats.wire_seconds > 0
        assert stats.ack_wait_seconds >= 0
        assert server.bytes_ingested == stats.bytes_sent
        merged = TransferStats()
        merged.merge(stats)
        merged.merge(stats)
        assert merged.chunks_sent == 8 and merged.sends == 2
        assert set(stats.to_dict()) == set(
            ref_transfer.TransferStats().to_dict())
        client.close()
        await bounded(server.stop())

    run_async(main())


def test_stop_closes_open_connections_first(run_async):
    """stop() with a sender's connection open returns at once (the
    listener's wait_closed waits for open connections, so they close
    first), and the sender sees the connection drop."""
    async def main():
        server = await _server()
        client = KvTransferClient("127.0.0.1", server.port)
        k, v = _pages(1, seed=13)
        fut = server.expect("r")
        await bounded(client.send_kv("r", [1], k, v, first_token=2))
        assert await bounded(fut) == 2
        assert len(server._conns) == 1
        t0 = time.monotonic()
        await bounded(server.stop())
        took = time.monotonic() - t0
        t1 = time.monotonic()
        while client._writer is not None and time.monotonic() - t1 < LIMIT:
            await asyncio.sleep(0.01)
        dropped = client._writer is None
        client.close()
        return took, dropped

    took, dropped = run_async(main())
    assert took < 1.0, took
    assert dropped


def test_listener_never_advertises_every_interface(run_async, monkeypatch):
    async def main(host):
        server = KvTransferServer(FakeEngine())
        await server.start(host=host)
        got = server.host
        await bounded(server.stop())
        return got

    monkeypatch.delenv("DYN_TCP_ADVERTISE_HOST", raising=False)
    assert run_async(main("0.0.0.0")) == "127.0.0.1"
    assert run_async(main("127.0.0.1")) == "127.0.0.1"
    monkeypatch.setenv("DYN_TCP_ADVERTISE_HOST", "10.1.2.3")
    assert run_async(main("0.0.0.0")) == "10.1.2.3"
