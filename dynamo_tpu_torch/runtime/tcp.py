"""TCP streaming response plane, a copy of ``dynamo_tpu/runtime/tcp.py``.

The request plane (DCP request/reply) carries only the request;
responses stream back over a raw TCP connection from the worker to the
caller (the "call-home" pattern):

1. The caller registers a pending stream (a uuid subject) with its local
   ``TcpStreamServer`` and sends its ``(address, subject)`` inside the
   request.
2. The worker connects back, sends a hello frame naming the subject, then
   streams ``data`` frames and a ``complete`` or ``err`` sentinel.
3. The connection is full-duplex: the caller can send ``ctrl`` frames
   (``stop``/``kill``) upstream, which the worker surfaces on the
   request's ``Context``.

The listener advertises ``DYN_TCP_ADVERTISE_HOST``, else its bind host
(127.0.0.1 when it binds every interface).

The worker side consults the ``tcp.connect`` and ``tcp.send`` chaos
points (``runtime/guard.py``) when chaos is configured.
"""

from __future__ import annotations

import asyncio
import logging
import uuid
from dataclasses import dataclass
from typing import Dict, Optional

from . import guard, wire
from .codec import TwoPartMessage, decode, encode
from .config import env_float, env_str
from .tasks import cancel_join, spawn_tracked

log = logging.getLogger("dynamo_tpu_torch.tcp")


def _io_timeout() -> float:
    """Bound on single IO steps (connect/handshake/drain): a dead peer
    fails a hop in DYN_IO_TIMEOUT instead of wedging it forever."""
    return env_float("DYN_IO_TIMEOUT", 30.0) or 30.0

# sentinel objects pushed into the receive queue
STREAM_COMPLETE = object()


@dataclass
class StreamError:
    message: str
    kind: str = ""  # exception class name from the worker, if known


@dataclass
class TcpConnectionInfo:
    """Sent in the request header so the worker can call home."""

    address: str  # host:port of the caller's TcpStreamServer
    subject: str  # uuid identifying the pending stream

    def to_dict(self) -> dict:
        return {"address": self.address, "subject": self.subject}

    @classmethod
    def from_dict(cls, d: dict) -> "TcpConnectionInfo":
        return cls(address=d["address"], subject=d["subject"])


class PendingStream:
    """Caller-side handle: an async queue of response payloads plus an
    upstream control channel once the worker has connected."""

    def __init__(self, subject: str, server: "TcpStreamServer"):
        self.subject = subject
        self._server = server
        self.queue: asyncio.Queue = asyncio.Queue()
        self._writer: Optional[asyncio.StreamWriter] = None
        self._connected = asyncio.Event()
        self._wlock = asyncio.Lock()
        self._pending_ctrl: list = []

    def _attach(self, writer: asyncio.StreamWriter) -> None:
        self._writer = writer
        self._connected.set()
        for kind in self._pending_ctrl:
            spawn_tracked(self.send_ctrl(kind),
                          name=f"tcp-ctrl-flush-{kind}")
        self._pending_ctrl.clear()

    async def wait_connected(self, timeout: float = 30.0) -> None:
        await asyncio.wait_for(self._connected.wait(), timeout)

    async def send_ctrl(self, kind: str) -> None:
        """Send a control frame upstream (kind: 'stop' | 'kill'). Frames
        issued before the worker's call-home attaches are buffered and
        flushed on attach."""
        if self._writer is None:
            self._pending_ctrl.append(kind)
            return
        async with self._wlock:
            try:
                self._writer.write(encode(TwoPartMessage(wire.checked(
                    wire.TCP_CTRL, {"t": "ctrl", "kind": kind}))))
                # frame atomicity needs the lock across the (bounded) drain
                await asyncio.wait_for(
                    self._writer.drain(), _io_timeout())
            except (ConnectionError, RuntimeError, asyncio.TimeoutError):
                pass

    def close(self) -> None:
        self._server._pending.pop(self.subject, None)
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass


class TcpStreamServer:
    """Caller-side listener for call-home response streams.

    One per process (lazily created by the DistributedRuntime); all
    in-flight requests multiplex onto it via per-request subjects.
    """

    def __init__(self) -> None:
        self._pending: Dict[str, PendingStream] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._writers: set = set()
        self.host = ""
        self.port = 0

    @classmethod
    async def start(cls, host: str = "0.0.0.0",
                    advertise_host: Optional[str] = None) -> "TcpStreamServer":
        self = cls()
        self._server = await asyncio.start_server(self._on_conn, host, 0)
        sock = self._server.sockets[0]
        self.port = sock.getsockname()[1]
        self.host = (advertise_host or env_str("DYN_TCP_ADVERTISE_HOST")
                     or (host if host not in ("0.0.0.0", "") else
                         "127.0.0.1"))
        log.debug("tcp stream server on %s:%d", self.host, self.port)
        return self

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def stop(self) -> None:
        if self._server:
            self._server.close()
        for w in list(self._writers):  # unblock handlers so wait_closed returns
            try:
                w.close()
            except Exception:
                log.debug("writer close failed during stop", exc_info=True)
        if self._server:
            try:
                await asyncio.wait_for(self._server.wait_closed(), 5.0)
            except asyncio.TimeoutError:
                log.warning("tcp stream server wait_closed timed out")

    def register(self) -> PendingStream:
        subject = uuid.uuid4().hex
        ps = PendingStream(subject, self)
        self._pending[subject] = ps
        return ps

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        ps: Optional[PendingStream] = None
        self._writers.add(writer)
        try:
            hello = await asyncio.wait_for(decode(reader), _io_timeout())
            hh = wire.decoded(wire.TCP_HELLO, hello.header)
            if hh.get("t") != "hello":
                raise ValueError(f"bad handshake: {hh}")
            subject = hh.get("subject")
            ps = self._pending.get(subject)
            if ps is None:
                writer.write(encode(TwoPartMessage(wire.checked(
                    wire.TCP_ERR,
                    {"t": "err", "message": f"unknown stream {subject}"}))))
                await asyncio.wait_for(writer.drain(), _io_timeout())
                return
            ps._attach(writer)
            while True:
                # idle server read: a response stream legitimately waits
                # as long as the worker generates; the REQUEST's deadline
                # bounds the consumer side (AsyncResponseStream)
                msg = await decode(reader)
                mh = wire.decoded(
                    (wire.TCP_DATA, wire.TCP_COMPLETE, wire.TCP_ERR),
                    msg.header)
                t = mh.get("t")
                if t == "data":
                    ps.queue.put_nowait(msg.body)
                elif t == "complete":
                    ps.queue.put_nowait(STREAM_COMPLETE)
                    break
                elif t == "err":
                    ps.queue.put_nowait(StreamError(mh.get("message", ""),
                                                    mh.get("kind", "")))
                    break
                else:
                    raise ValueError(f"unexpected frame type {t}")
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.TimeoutError):
            if ps is not None:
                ps.queue.put_nowait(StreamError("response stream disconnected"))
        except Exception as e:  # noqa: BLE001
            log.exception("response stream error")
            if ps is not None:
                ps.queue.put_nowait(StreamError(repr(e)))
        finally:
            self._writers.discard(writer)
            if ps is not None:
                self._pending.pop(ps.subject, None)
            try:
                writer.close()
            except Exception:
                pass


class TcpCallHome:
    """Worker-side: connect back to the caller and stream responses.

    Reads ``ctrl`` frames concurrently and invokes ``on_ctrl(kind)``.
    """

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 on_ctrl=None):
        self._reader = reader
        self._writer = writer
        self._on_ctrl = on_ctrl
        self._wlock = asyncio.Lock()
        self._ctrl_task = spawn_tracked(self._ctrl_loop(),
                                        name="tcp-callhome-ctrl")

    @classmethod
    async def connect(cls, info: TcpConnectionInfo, on_ctrl=None,
                      timeout: Optional[float] = None) -> "TcpCallHome":
        if guard.chaos() is not None:
            await guard.chaos_point("tcp.connect")
        host, _, port = info.address.rpartition(":")
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, int(port)),
            timeout if timeout is not None else _io_timeout())
        self = cls(reader, writer, on_ctrl)
        await self._send(TwoPartMessage(wire.checked(
            wire.TCP_HELLO, {"t": "hello", "subject": info.subject})))
        return self

    async def _ctrl_loop(self) -> None:
        try:
            while True:
                # ctrl frames arrive whenever the caller chooses; this
                # read lives exactly as long as the connection
                msg = await decode(self._reader)
                ch = wire.decoded(wire.TCP_CTRL, msg.header)
                if ch.get("t") == "ctrl" and self._on_ctrl is not None:
                    self._on_ctrl(ch.get("kind"))
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.CancelledError):
            # peer hung up: treat as kill (caller went away)
            if self._on_ctrl is not None:
                self._on_ctrl("disconnect")

    async def _send(self, msg: TwoPartMessage) -> None:
        # chaos points are consulted only when chaos is configured: no
        # extra await a frame otherwise
        if guard.chaos() is not None:
            await guard.chaos_point("tcp.send", self._writer)
        async with self._wlock:
            self._writer.write(encode(msg))
            # frame atomicity needs the lock across the (bounded) drain
            await asyncio.wait_for(
                self._writer.drain(), _io_timeout())

    async def send_data(self, body: bytes) -> None:
        await self._send(TwoPartMessage(
            wire.checked(wire.TCP_DATA, {"t": "data"}), body))

    async def complete(self) -> None:
        await self._send(TwoPartMessage(
            wire.checked(wire.TCP_COMPLETE, {"t": "complete"})))

    async def error(self, message: str, kind: str = "") -> None:
        await self._send(TwoPartMessage(wire.checked(wire.TCP_ERR, {
            "t": "err", "message": message, "kind": kind})))

    async def close(self) -> None:
        await cancel_join(self._ctrl_task)
        try:
            self._writer.close()
            await asyncio.wait_for(self._writer.wait_closed(), _io_timeout())
        except Exception:
            pass
