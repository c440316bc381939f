"""Asyncio client for the control-plane service (DCP), a copy of
``dynamo_tpu/runtime/dcp_client.py``.

It plays both the etcd client (``kv_create``/``kv_put``/``kv_cas``/
``kv_get_prefix``/``kv_watch_prefix``, leases) and the NATS client
(pub/sub, request/reply, work queues) over the one DCP wire protocol.
:class:`KeepaliveThread` renews a lease from a thread and connection of
its own, so a worker's records outlive an event loop that blocks (CUDA
graph capture at warmup, long host stalls).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
from dataclasses import dataclass
from typing import AsyncIterator, Awaitable, Callable, Dict, List, Optional, Tuple

import msgpack

from . import wire
from .config import env_float
from .dcp_server import pack_frame, read_frame
from .tasks import cancel_join, spawn_tracked


def _io_timeout() -> float:
    return env_float("DYN_IO_TIMEOUT", 30.0) or 30.0

log = logging.getLogger("dynamo_tpu_torch.dcp.client")


@dataclass
class KvItem:
    key: str
    value: bytes
    lease: int = 0
    mod_rev: int = 0


@dataclass
class WatchEvent:
    """Put/Delete event from a prefix watch (reference etcd.rs WatchEvent)."""

    event: str  # "put" | "delete"
    key: str
    value: Optional[bytes]


class DcpError(RuntimeError):
    pass


class NoRespondersError(DcpError):
    pass


class CasConflict(DcpError):
    """kv_cas lost the race: the key's mod_rev moved. Raised off the
    server's structured ``conflict`` flag, not the error text."""


class DcpClient:
    """One connection to the DCP server, usable concurrently from many tasks."""

    def __init__(self) -> None:
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._seq = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._watch_ids = itertools.count(1)
        self._watch_queues: Dict[int, asyncio.Queue] = {}
        self._sub_handlers: Dict[int, Callable[[dict], Awaitable[None]]] = {}
        self._rx_task: Optional[asyncio.Task] = None
        self._wlock = asyncio.Lock()
        self._closed = False
        self.address = ""

    # ------------------------------------------------------------- lifecycle

    @classmethod
    async def connect(cls, address: str) -> "DcpClient":
        self = cls()
        host, _, port = address.rpartition(":")
        self._reader, self._writer = await asyncio.wait_for(
            asyncio.open_connection(host, int(port)), _io_timeout())
        self._rx_task = spawn_tracked(self._rx_loop(),
                                      name=f"dcp-client-rx-{address}")
        self.address = address
        return self

    async def close(self) -> None:
        self._closed = True
        await cancel_join(self._rx_task)
        if self._writer:
            try:
                self._writer.close()
                await asyncio.wait_for(self._writer.wait_closed(),
                                       _io_timeout())
            except Exception:
                pass
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(DcpError("connection closed"))
        self._pending.clear()

    @property
    def connected(self) -> bool:
        return not self._closed and self._writer is not None

    # --------------------------------------------------------------- rx loop

    async def _rx_loop(self) -> None:
        try:
            while True:
                # idle demux read: every RPC bounds its own reply future;
                # this loop lives exactly as long as the connection
                msg = await read_frame(self._reader)
                if "push" in msg:
                    await self._on_push(msg)
                else:
                    fut = self._pending.pop(msg.get("seq"), None)
                    if fut is not None and not fut.done():
                        fut.set_result(msg)
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):
            pass
        except Exception:
            log.exception("dcp client rx error")
        finally:
            self._closed = True
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(DcpError("connection lost"))
            self._pending.clear()
            for q in self._watch_queues.values():
                q.put_nowait(None)

    async def _on_push(self, msg: dict) -> None:
        msg = wire.decoded((wire.DCP_PUSH_WATCH, wire.DCP_PUSH_MSG,
                            wire.DCP_PUSH_REQ), msg)
        kind = msg["push"]
        if kind == "watch":
            q = self._watch_queues.get(msg["watch_id"])
            if q is not None:
                q.put_nowait(WatchEvent(msg["event"], msg["key"], msg.get("value")))
        elif kind in ("msg", "req"):
            handler = self._sub_handlers.get(msg["sid"])
            if handler is not None:
                spawn_tracked(self._run_handler(handler, msg),
                              name=f"dcp-sub-{msg.get('subject')}")
            elif kind == "req":
                await self._send_raw(
                    {"op": "reply", "seq": next(self._seq), "reply": msg["reply"],
                     "ok": False, "error": "no handler"})

    async def _run_handler(self, handler, msg: dict) -> None:
        try:
            await handler(msg)
        except Exception:
            log.exception("subscription handler failed for %s", msg.get("subject"))

    # ------------------------------------------------------------------- rpc

    async def _send_raw(self, msg: dict) -> None:
        async with self._wlock:
            self._writer.write(pack_frame(msg))
            # bounded drain under the frame lock: atomicity needs the
            # lock held across the write, DYN_IO_TIMEOUT bounds it
            await asyncio.wait_for(
                self._writer.drain(), _io_timeout())

    async def _call(self, op: str, timeout: Optional[float] = None, **kw) -> dict:
        if self._closed:
            raise DcpError("client closed")
        seq = next(self._seq)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[seq] = fut
        await self._send_raw({"op": op, "seq": seq, **kw})
        try:
            resp = await (asyncio.wait_for(fut, timeout) if timeout else fut)
        finally:
            self._pending.pop(seq, None)
        if not resp.get("ok", True):
            err = resp.get("error", "unknown")
            if resp.get("conflict"):
                raise CasConflict(err)
            if "no responders" in str(err):
                raise NoRespondersError(err)
            raise DcpError(err)
        return resp

    # ---------------------------------------------------------------- KV API

    async def kv_put(self, key: str, value: bytes, lease: int = 0) -> int:
        resp = await self._call("kv_put", key=key, value=value, lease=lease)
        return resp["rev"]

    async def kv_create(self, key: str, value: bytes, lease: int = 0) -> bool:
        """Create-if-absent; returns False when the key already exists."""
        try:
            await self._call("kv_create", key=key, value=value, lease=lease)
            return True
        except DcpError as e:
            if "exists" in str(e):
                return False
            raise

    async def kv_get(self, key: str) -> Optional[bytes]:
        resp = await self._call("kv_get", key=key)
        return resp["value"] if resp.get("found") else None

    async def kv_get_item(self, key: str) -> Optional[KvItem]:
        """kv_get with metadata (mod_rev for CAS round-trips)."""
        resp = await self._call("kv_get", key=key)
        if not resp.get("found"):
            return None
        return KvItem(key, resp["value"], resp.get("lease", 0),
                      resp.get("mod_rev", 0))

    async def kv_cas(self, key: str, value: bytes, prev_rev: int,
                     lease: int = 0) -> bool:
        """Compare-and-swap: write only if the key's mod_rev still equals
        ``prev_rev`` (0 = key must not exist).  Returns False on conflict
        (reference etcd.rs transactional guard)."""
        try:
            await self._call("kv_put", key=key, value=value, lease=lease,
                             prev_rev=prev_rev)
            return True
        except CasConflict:
            return False

    async def kv_get_prefix(self, prefix: str) -> List[KvItem]:
        resp = await self._call("kv_get_prefix", prefix=prefix)
        return [KvItem(i["key"], i["value"], i.get("lease", 0), i.get("mod_rev", 0)) for i in resp["items"]]

    async def kv_delete(self, key: str) -> bool:
        return (await self._call("kv_delete", key=key))["deleted"]

    async def kv_delete_prefix(self, prefix: str) -> int:
        return (await self._call("kv_delete_prefix", prefix=prefix))["deleted"]

    async def kv_watch_prefix(
        self, prefix: str
    ) -> Tuple[List[KvItem], "PrefixWatch"]:
        """Returns (current items, watch stream) — reference
        etcd.rs kv_get_and_watch_prefix."""
        wid = next(self._watch_ids)
        q: asyncio.Queue = asyncio.Queue()
        self._watch_queues[wid] = q
        resp = await self._call("watch_prefix", prefix=prefix, watch_id=wid)
        items = [KvItem(i["key"], i["value"], i.get("lease", 0), i.get("mod_rev", 0)) for i in resp["items"]]
        return items, PrefixWatch(self, wid, q)

    # ------------------------------------------------------------- lease API

    async def lease_grant(self, ttl: float = 10.0) -> int:
        return (await self._call("lease_grant", ttl=ttl))["lease"]

    async def lease_keepalive(self, lease: int,
                              timeout: Optional[float] = None) -> None:
        await self._call("lease_keepalive", lease=lease, timeout=timeout)

    async def lease_revoke(self, lease: int) -> None:
        await self._call("lease_revoke", lease=lease)

    # NOTE: there is deliberately no loop-resident keepalive helper. An
    # asyncio-task renewal starves whenever synchronous work blocks the
    # loop for multiples of the TTL (graph capture, bulk host transfers)
    # and the lease expires. Every lease that must stay alive renews via
    # :class:`KeepaliveThread` (its own thread + connection);
    # DistributedRuntime's primary lease does.

    # ----------------------------------------------------------- pub/sub API

    async def subscribe(
        self,
        subject: str,
        handler: Callable[["Message"], Awaitable[None]],
        group: Optional[str] = None,
    ) -> int:
        """Subscribe; ``handler(Message)`` runs per delivery. For request-plane
        subjects, use ``msg.respond()`` to send the reply."""

        async def _raw(msg: dict) -> None:
            await handler(Message(self, msg))

        resp = await self._call("sub", subject=subject, group=group)
        sid = resp["sid"]
        self._sub_handlers[sid] = _raw
        return sid

    async def unsubscribe(self, sid: int) -> None:
        self._sub_handlers.pop(sid, None)
        await self._call("unsub", sid=sid)

    async def publish(self, subject: str, payload: bytes) -> None:
        await self._call("pub", subject=subject, payload=payload)

    async def request(self, subject: str, payload: bytes,
                      timeout: float = 30.0) -> bytes:
        resp = await self._call("req", subject=subject, payload=payload,
                                timeout=timeout)
        return resp["payload"]

    # --------------------------------------------------------- work-queue API

    async def queue_put(self, queue: str, payload: bytes) -> None:
        await self._call("q_put", queue=queue, payload=payload)

    async def queue_pull(self, queue: str,
                         timeout: float = 0.0) -> Optional[bytes]:
        resp = await self._call(
            "q_pull", queue=queue, timeout_ms=int(timeout * 1000))
        return resp["payload"] if resp.get("found") else None

    async def queue_len(self, queue: str) -> int:
        return (await self._call("q_len", queue=queue))["len"]

    async def ping(self) -> float:
        return (await self._call("ping"))["time"]


class Message:
    """A delivered pub/sub or request-plane message."""

    __slots__ = ("_client", "subject", "payload", "_reply")

    def __init__(self, client: DcpClient, raw: dict):
        self._client = client
        raw = wire.decoded((wire.DCP_PUSH_MSG, wire.DCP_PUSH_REQ), raw)
        self.subject: str = raw["subject"]
        self.payload: bytes = raw["payload"]
        self._reply: Optional[int] = raw.get("reply")

    @property
    def needs_reply(self) -> bool:
        return self._reply is not None

    async def respond(self, payload: bytes) -> None:
        assert self._reply is not None, "not a request message"
        await self._client._send_raw(
            {"op": "reply", "seq": next(self._client._seq),
             "reply": self._reply, "ok": True, "payload": payload})

    async def respond_error(self, error: str) -> None:
        assert self._reply is not None, "not a request message"
        await self._client._send_raw(
            {"op": "reply", "seq": next(self._client._seq),
             "reply": self._reply, "ok": False, "error": error})


class PrefixWatch:
    """Async iterator of WatchEvents; ``stop()`` to end."""

    def __init__(self, client: DcpClient, watch_id: int, queue: asyncio.Queue):
        self._client = client
        self._watch_id = watch_id
        self._queue = queue
        self._stopped = False

    def __aiter__(self) -> AsyncIterator[WatchEvent]:
        return self

    async def __anext__(self) -> WatchEvent:
        if self._stopped:
            raise StopAsyncIteration
        # a watch stream is unbounded by design; server death enqueues a
        # None sentinel (rx loop finally), so this can never wedge
        ev = await self._queue.get()
        if ev is None:
            raise StopAsyncIteration
        return ev

    async def stop(self) -> None:
        self._stopped = True
        self._client._watch_queues.pop(self._watch_id, None)
        try:
            await self._client._call("unwatch", watch_id=self._watch_id)
        except DcpError:
            pass
        self._queue.put_nowait(None)


def pack(obj) -> bytes:
    """Standard payload serialization for the framework (msgpack)."""
    return msgpack.packb(obj, use_bin_type=True)


def unpack(data: bytes):
    return msgpack.unpackb(data, raw=False)


class KeepaliveThread:
    """Lease keep-alive on a dedicated daemon thread with its OWN
    connection and event loop, immune to main-loop stalls.

    The serving process routinely blocks its event loop for multiples of
    the lease TTL — engine warmup captures the whole bucket grid
    synchronously, a long prefill chunk holds the loop — and a
    loop-resident keepalive task then starves until the lease
    expires, deleting every lease-attached key (endpoint instances, model
    entries) out from under a live worker. A thread with
    its own socket keeps renewals flowing regardless; with the embedded
    DCP server the renewal frames queue in the socket during a stall and
    are processed before the reaper's timer callback when the loop
    resumes (asyncio runs IO callbacks ahead of timers in an iteration).
    """

    def __init__(self, address: str, lease: int, ttl: float):
        import threading

        self.address = address
        self.lease = lease
        self.ttl = ttl
        self.dead = False          # lease reported gone by the server
        self._stop = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._waker: Optional[asyncio.Event] = None
        self._thread = threading.Thread(
            target=self._run, name=f"dcp-keepalive-{lease:x}", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            asyncio.run(self._amain())
        except Exception:  # noqa: BLE001 — best-effort background thread
            log.exception("keepalive thread for lease %x died", self.lease)

    async def _amain(self) -> None:
        interval = max(self.ttl / 3.0, 0.05)
        self._loop = asyncio.get_running_loop()
        self._waker = asyncio.Event()
        client: Optional[DcpClient] = None

        async def _pause() -> None:
            try:
                await asyncio.wait_for(self._waker.wait(), interval)
            except asyncio.TimeoutError:
                pass

        try:
            # connect EAGERLY, before the first interval: once a stall
            # begins, the (possibly loop-embedded) server can no longer
            # accept, and renewals can only queue on an existing socket
            try:
                client = await DcpClient.connect(self.address)
            except OSError:
                pass
            while not self._stop.is_set():
                await _pause()
                if self._stop.is_set():
                    return
                try:
                    if client is None or not client.connected:
                        if client is not None:
                            await client.close()
                        client = await DcpClient.connect(self.address)
                    # bound the wait so a wedged server can't pin the
                    # thread past cancel()
                    await client.lease_keepalive(
                        self.lease, timeout=max(self.ttl, 1.0))
                except DcpError as e:
                    if "lease" in str(e):
                        # the server says the lease is GONE (expired or
                        # revoked) — renewing cannot resurrect it, and the
                        # worker's lease-attached records are already
                        # deleted. Surface loudly and stop; the owner
                        # must re-attach to get a new identity. (During
                        # shutdown the revoke races a final renewal —
                        # that's the expected quiet path, not an error.)
                        if not self._stop.is_set():
                            log.error(
                                "lease %x is gone (%s): keepalive "
                                "stopping — this worker's instance "
                                "records are deleted; re-attach to "
                                "rejoin discovery", self.lease, e)
                        self.dead = True
                        return
                    await self._drop(client)
                    client = None
                except (OSError, asyncio.TimeoutError):
                    # server briefly down/stalled: keep trying until
                    # cancelled — renewals must survive transient faults
                    await self._drop(client)
                    client = None
        finally:
            if client is not None:
                await client.close()

    @staticmethod
    async def _drop(client: Optional[DcpClient]) -> None:
        try:
            if client is not None:
                await client.close()
        except Exception:  # noqa: BLE001
            pass

    def cancel(self) -> None:
        """Stop the thread. Wakes its sleep via its own loop so the join
        returns in milliseconds instead of blocking the caller up to a
        renewal interval."""
        self._stop.set()
        if self._loop is not None and self._waker is not None:
            try:
                self._loop.call_soon_threadsafe(self._waker.set)
            except RuntimeError:
                pass  # thread's loop already closed
        self._thread.join(timeout=2.0)
