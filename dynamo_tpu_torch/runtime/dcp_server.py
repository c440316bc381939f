"""Control-plane service ("DCP"), a copy of ``dynamo_tpu/runtime/dcp_server.py``.

One asyncio server gives the four planes the reference takes from etcd
and NATS:

- **KV store with leases and prefix watches**: ``kv_put/kv_create/kv_get/
  kv_get_prefix/kv_delete``, compare-and-swap on ``mod_rev``,
  ``lease_grant/keepalive/revoke``; keys attached to a lease are deleted
  when it expires and prefix watchers receive Put/Delete events.
- **Pub/sub**: subjects with queue groups; ``publish`` fans out to all
  plain subscribers and one member of each queue group.
- **Request/reply**: ``request`` routes to one subscriber of the
  subject's queue group and relays the single reply.
- **Work queues**: in-memory FIFOs with a blocking pull.

Wire protocol: a 4-byte big-endian length prefix and a msgpack map.
Client-to-server maps carry ``op`` and ``seq``; server-to-client maps are
responses (``seq`` echo and ``ok``) or pushes (``push`` kind). The
reference's durability journal (``dcp_journal.py``) is not part of the
port: this server keeps everything in memory.

    python -m dynamo_tpu_torch.runtime.dcp_server --port 6650
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import signal
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import msgpack

from . import wire
from .tasks import cancel_join, spawn_tracked

log = logging.getLogger("dynamo_tpu_torch.dcp")

MAX_FRAME = 64 * 1024 * 1024


def pack_frame(msg: dict) -> bytes:
    body = msgpack.packb(msg, use_bin_type=True)
    return len(body).to_bytes(4, "big") + body


async def read_frame(reader: asyncio.StreamReader) -> dict:
    hdr = await reader.readexactly(4)
    n = int.from_bytes(hdr, "big")
    if n > MAX_FRAME:
        raise ValueError(f"frame too large: {n}")
    body = await reader.readexactly(n)
    return msgpack.unpackb(body, raw=False)


@dataclass
class _KvEntry:
    value: bytes
    lease: int = 0  # 0 = no lease
    create_rev: int = 0
    mod_rev: int = 0


@dataclass
class _Lease:
    id: int
    ttl: float
    deadline: float
    keys: Set[str] = field(default_factory=set)


@dataclass
class _Sub:
    conn: "_Conn"
    sub_id: int
    subject: str
    group: Optional[str]


@dataclass
class _Watch:
    conn: "_Conn"
    watch_id: int
    prefix: str


def subject_matches(pattern: str, subject: str) -> bool:
    """NATS-style matching: '.'-separated tokens, '*' = one token,
    trailing '>' = one-or-more tokens."""
    if pattern == subject:
        return True
    pt = pattern.split(".")
    st = subject.split(".")
    for i, p in enumerate(pt):
        if p == ">":  # matches one or more remaining tokens
            return len(st) > i
        if i >= len(st):
            return False
        if p != "*" and p != st[i]:
            return False
    return len(pt) == len(st)


class _Conn:
    """One client connection. Outbound frames go through a per-connection
    queue drained by a writer task, so a slow consumer never blocks the
    server's dispatch loop (head-of-line isolation)."""

    MAX_OUTBOUND = 65536

    __slots__ = ("server", "reader", "writer", "id", "alive", "_outq", "_wtask")

    def __init__(self, server: "DcpServer", reader, writer, conn_id: int):
        self.server = server
        self.reader = reader
        self.writer = writer
        self.id = conn_id
        self.alive = True
        self._outq: asyncio.Queue = asyncio.Queue()
        self._wtask = spawn_tracked(self._writer_loop(),
                                    name=f"dcp-conn-{conn_id}-writer")

    async def _writer_loop(self) -> None:
        try:
            while True:
                msg = await self._outq.get()
                self.writer.write(pack_frame(msg))
                # a consumer that stops reading long enough to block the
                # drain past the IO bound is dead: drop the connection
                await asyncio.wait_for(self.writer.drain(), 30.0)
        except (ConnectionError, RuntimeError, asyncio.CancelledError,
                asyncio.TimeoutError):
            self.alive = False

    async def send(self, msg: dict) -> None:
        if not self.alive:
            return
        if self._outq.qsize() > self.MAX_OUTBOUND:
            log.warning("conn %d outbound queue overflow; dropping conn", self.id)
            self.close()
            return
        self._outq.put_nowait(msg)

    def close(self) -> None:
        self.alive = False
        self._wtask.cancel()
        try:
            self.writer.close()
        except Exception:
            pass


class DcpServer:
    """The control-plane server. ``await DcpServer.start(host, port)``;
    ``port=0`` binds an ephemeral port (see ``.port``)."""

    def __init__(self) -> None:
        self._kv: Dict[str, _KvEntry] = {}
        self._rev = 0
        self._leases: Dict[int, _Lease] = {}
        self._lease_ids = itertools.count(0x1000)
        self._conn_ids = itertools.count(1)
        self._sub_ids = itertools.count(1)
        self._subs: Dict[int, _Sub] = {}  # global sub key -> sub
        self._subs_by_conn: Dict[int, Set[int]] = defaultdict(set)
        self._watches: Dict[Tuple[int, int], _Watch] = {}
        self._group_rr: Dict[Tuple[str, str], int] = defaultdict(int)
        # rid -> (requester conn, requester seq, responder conn id)
        self._pending_replies: Dict[int, Tuple[_Conn, int, int]] = {}
        self._reply_ids = itertools.count(1)
        self._conns: Dict[int, _Conn] = {}
        self._queues: Dict[str, deque] = defaultdict(deque)
        self._queue_waiters: Dict[str, deque] = defaultdict(deque)
        self._server: Optional[asyncio.AbstractServer] = None
        self._lease_task: Optional[asyncio.Task] = None
        self.port: int = 0
        self.host: str = ""

    # ------------------------------------------------------------- lifecycle

    @classmethod
    async def start(cls, host: str = "127.0.0.1",
                    port: int = 0) -> "DcpServer":
        self = cls()
        self._server = await asyncio.start_server(self._on_conn, host, port)
        sock = self._server.sockets[0]
        self.host, self.port = sock.getsockname()[:2]
        self._lease_task = spawn_tracked(self._lease_reaper(),
                                         name="dcp-lease-reaper")
        log.info("dcp server listening on %s:%d", self.host, self.port)
        return self

    async def stop(self) -> None:
        await cancel_join(self._lease_task)
        if self._server:
            self._server.close()
        # close live connections so wait_closed() (which waits for all
        # connection handlers on Python 3.12+) cannot hang
        for conn in list(self._conns.values()):
            conn.close()
        if self._server:
            try:
                await asyncio.wait_for(self._server.wait_closed(), 5.0)
            except asyncio.TimeoutError:
                log.warning("dcp server wait_closed timed out")

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    # ------------------------------------------------------------- conn loop

    # ops that may block (waiting) run as tasks so they never stall the
    # connection's dispatch loop; everything else is quick and runs inline
    _BLOCKING_OPS = frozenset({"q_pull"})

    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        conn = _Conn(self, reader, writer, next(self._conn_ids))
        self._conns[conn.id] = conn
        try:
            while True:
                # idle server read: a control-plane client is allowed to
                # sit quiet; conn close / lease expiry bound the session
                msg = await read_frame(reader)
                if msg.get("op") in self._BLOCKING_OPS:
                    spawn_tracked(self._dispatch(conn, msg),
                                  name=f"dcp-op-{msg.get('op')}")
                else:
                    await self._dispatch(conn, msg)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        except Exception:
            log.exception("dcp conn %d error", conn.id)
        finally:
            conn.close()
            self._conns.pop(conn.id, None)
            await self._cleanup_conn(conn)

    async def _cleanup_conn(self, conn: _Conn) -> None:
        for sid in list(self._subs_by_conn.pop(conn.id, ())):
            self._subs.pop(sid, None)
        for key in [k for k in self._watches if k[0] == conn.id]:
            self._watches.pop(key, None)
        # queue waiters owned by this conn just get dropped; items stay queued
        for q in self._queue_waiters.values():
            for c, fut in list(q):
                if c is conn and not fut.done():
                    fut.cancel()
        # fail in-flight requests this conn was the responder for, and drop
        # entries whose requester is gone
        for rid, (requester, seq, responder_id) in list(self._pending_replies.items()):
            if responder_id == conn.id:
                self._pending_replies.pop(rid, None)
                await requester.send(
                    {"seq": seq, "ok": False, "error": "responder disconnected"})
            elif requester is conn:
                self._pending_replies.pop(rid, None)

    async def _dispatch(self, conn: _Conn, msg: dict) -> None:
        op = msg.get("op")
        seq = msg.get("seq")
        try:
            handler = getattr(self, f"_op_{op}", None)
            if handler is None:
                await conn.send({"seq": seq, "ok": False, "error": f"unknown op {op}"})
                return
            resp = await handler(conn, msg)
            if resp is not None:
                resp["seq"] = seq
                resp.setdefault("ok", True)
                await conn.send(resp)
        except Exception as e:  # noqa: BLE001 — report errors to client
            log.exception("dcp op %s failed", op)
            await conn.send({"seq": seq, "ok": False, "error": repr(e)})

    # ------------------------------------------------------------- KV + lease

    def _notify_watchers(self, event: str, key: str, value: Optional[bytes]) -> None:
        for w in list(self._watches.values()):
            if key.startswith(w.prefix):
                spawn_tracked(
                    w.conn.send(wire.checked(wire.DCP_PUSH_WATCH, {
                        "push": "watch", "watch_id": w.watch_id,
                        "event": event, "key": key, "value": value})),
                    name="dcp-watch-notify")

    async def _op_kv_put(self, conn, msg):
        key, value, lease = msg["key"], msg["value"], msg.get("lease", 0)
        if lease and lease not in self._leases:
            return {"ok": False, "error": f"no such lease {lease}"}
        prev = self._kv.get(key)
        # compare-and-swap (reference etcd.rs txn: mod_revision guard):
        # prev_rev=0 means "must not exist"
        prev_rev = msg.get("prev_rev")
        if prev_rev is not None:
            have = prev.mod_rev if prev is not None else 0
            if have != prev_rev:
                return {"ok": False, "error": "cas conflict",
                        "conflict": True, "mod_rev": have}
        self._rev += 1
        entry = _KvEntry(
            value=value, lease=lease,
            create_rev=prev.create_rev if prev else self._rev, mod_rev=self._rev)
        self._kv[key] = entry
        if lease:
            self._leases[lease].keys.add(key)
        self._notify_watchers("put", key, value)
        return {"rev": self._rev}

    async def _op_kv_create(self, conn, msg):
        """Transactional create-if-absent (reference etcd.rs kv_create)."""
        if msg["key"] in self._kv:
            return {"ok": False, "error": "exists", "exists": True}
        return await self._op_kv_put(conn, msg)

    async def _op_kv_get(self, conn, msg):
        e = self._kv.get(msg["key"])
        if e is None:
            return {"found": False}
        return {"found": True, "value": e.value, "lease": e.lease,
                "mod_rev": e.mod_rev}

    async def _op_kv_get_prefix(self, conn, msg):
        p = msg["prefix"]
        items = [
            {"key": k, "value": e.value, "lease": e.lease,
             "mod_rev": e.mod_rev}
            for k, e in sorted(self._kv.items()) if k.startswith(p)
        ]
        return {"items": items}

    async def _op_kv_delete(self, conn, msg):
        key = msg["key"]
        e = self._kv.pop(key, None)
        if e is not None:
            if e.lease in self._leases:
                self._leases[e.lease].keys.discard(key)
            self._notify_watchers("delete", key, None)
        return {"deleted": e is not None}

    async def _op_kv_delete_prefix(self, conn, msg):
        p = msg["prefix"]
        keys = [k for k in self._kv if k.startswith(p)]
        for k in keys:
            e = self._kv.pop(k)
            if e.lease in self._leases:
                self._leases[e.lease].keys.discard(k)
            self._notify_watchers("delete", k, None)
        return {"deleted": len(keys)}

    async def _op_watch_prefix(self, conn, msg):
        w = _Watch(conn, msg["watch_id"], msg["prefix"])
        self._watches[(conn.id, w.watch_id)] = w
        items = [
            {"key": k, "value": e.value, "lease": e.lease,
             "mod_rev": e.mod_rev}
            for k, e in sorted(self._kv.items()) if k.startswith(w.prefix)
        ]
        return {"items": items}

    async def _op_unwatch(self, conn, msg):
        self._watches.pop((conn.id, msg["watch_id"]), None)
        return {}

    async def _op_lease_grant(self, conn, msg):
        ttl = float(msg.get("ttl", 10.0))
        lid = next(self._lease_ids)
        self._leases[lid] = _Lease(id=lid, ttl=ttl, deadline=time.monotonic() + ttl)
        return {"lease": lid}

    async def _op_lease_keepalive(self, conn, msg):
        lease = self._leases.get(msg["lease"])
        if lease is None:
            return {"ok": False, "error": "lease expired"}
        lease.deadline = time.monotonic() + lease.ttl
        return {}

    async def _op_lease_revoke(self, conn, msg):
        await self._expire_lease(msg["lease"])
        return {}

    async def _expire_lease(self, lid: int) -> None:
        lease = self._leases.pop(lid, None)
        if lease is None:
            return
        for key in list(lease.keys):
            if key in self._kv and self._kv[key].lease == lid:
                self._kv.pop(key)
                self._notify_watchers("delete", key, None)

    async def _lease_reaper(self) -> None:
        last = time.monotonic()
        while True:
            await asyncio.sleep(0.25)
            now = time.monotonic()
            gap = now - last
            last = now
            if gap > 1.0:
                # the event loop (and so this server) just resumed from a
                # stall: keep-alive renewals may still be queued in socket
                # buffers or mid-reconnect — judging deadlines NOW would
                # expire leases whose owners renewed on time. Skip one
                # tick so pending renewals land first.
                log.info("lease reaper resumed after %.1fs stall; "
                         "deferring one tick", gap)
                continue
            for lid in [l.id for l in self._leases.values() if l.deadline < now]:
                log.info("lease %x expired", lid)
                await self._expire_lease(lid)

    # --------------------------------------------------------------- pub/sub

    async def _op_sub(self, conn, msg):
        sid = next(self._sub_ids)
        sub = _Sub(conn, sid, msg["subject"], msg.get("group"))
        self._subs[sid] = sub
        self._subs_by_conn[conn.id].add(sid)
        return {"sid": sid}

    async def _op_unsub(self, conn, msg):
        # client refers to its own sub_id; resolve via its conn
        for sid in list(self._subs_by_conn.get(conn.id, ())):
            s = self._subs.get(sid)
            if s and s.sub_id == msg["sid"]:
                self._subs.pop(sid, None)
                self._subs_by_conn[conn.id].discard(sid)
        return {}

    def _route(self, subject: str) -> List[_Sub]:
        """All plain subscribers + one per queue group (round-robin)."""
        plain: List[_Sub] = []
        groups: Dict[str, List[_Sub]] = defaultdict(list)
        for s in self._subs.values():
            if not s.conn.alive or not subject_matches(s.subject, subject):
                continue
            if s.group:
                groups[s.group].append(s)
            else:
                plain.append(s)
        out = plain
        for gname, members in groups.items():
            members.sort(key=lambda s: s.sub_id)
            idx = self._group_rr[(subject, gname)] % len(members)
            self._group_rr[(subject, gname)] += 1
            out.append(members[idx])
        return out

    async def _op_pub(self, conn, msg):
        subject, payload = msg["subject"], msg["payload"]
        for s in self._route(subject):
            await s.conn.send(wire.checked(wire.DCP_PUSH_MSG, {
                "push": "msg", "sid": s.sub_id, "subject": subject,
                "payload": payload}))
        return {}

    def _route_request(self, subject: str) -> Optional[_Sub]:
        """Pick exactly one queue-group member for a request (plain
        subscribers observe via pub/sub but never consume requests)."""
        groups: Dict[str, List[_Sub]] = defaultdict(list)
        for s in self._subs.values():
            if s.group and s.conn.alive and subject_matches(s.subject, subject):
                groups[s.group].append(s)
        if not groups:
            return None
        gname = sorted(groups)[0]
        members = sorted(groups[gname], key=lambda s: s.sub_id)
        idx = self._group_rr[(subject, gname)] % len(members)
        self._group_rr[(subject, gname)] += 1
        return members[idx]

    async def _op_req(self, conn, msg):
        """Request plane: route to one queue-group member, relay one reply."""
        subject, payload = msg["subject"], msg["payload"]
        target = self._route_request(subject)
        if target is None:
            return {"ok": False, "error": f"no responders for {subject}"}
        rid = next(self._reply_ids)
        self._pending_replies[rid] = (conn, msg["seq"], target.conn.id)
        await target.conn.send(wire.checked(wire.DCP_PUSH_REQ, {
            "push": "req", "sid": target.sub_id, "subject": subject,
            "payload": payload, "reply": rid}))
        return None  # response sent when the reply comes back

    async def _op_reply(self, conn, msg):
        rid = msg["reply"]
        entry = self._pending_replies.pop(rid, None)
        if entry is not None:
            requester, seq, _responder = entry
            await requester.send(
                {"seq": seq, "ok": msg.get("ok", True), "payload": msg.get("payload"),
                 "error": msg.get("error")})
        return {}

    # ------------------------------------------------------------ work queues

    async def _op_q_put(self, conn, msg):
        qname, payload = msg["queue"], msg["payload"]
        waiters = self._queue_waiters[qname]
        while waiters:
            _c, fut = waiters.popleft()
            if not fut.done():
                # direct handoff to a blocked puller
                fut.set_result(payload)
                return {"queued": 0}
        self._queues[qname].append(payload)
        return {"queued": len(self._queues[qname])}

    async def _op_q_pull(self, conn, msg):
        qname = msg["queue"]
        timeout = msg.get("timeout_ms", 0) / 1000.0
        q = self._queues[qname]
        if q:
            payload = q.popleft()
            return {"found": True, "payload": payload}
        if timeout <= 0:
            return {"found": False}
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._queue_waiters[qname].append((conn, fut))
        try:
            payload = await asyncio.wait_for(fut, timeout)
            return {"found": True, "payload": payload}
        except (asyncio.TimeoutError, asyncio.CancelledError):
            return {"found": False}

    async def _op_q_len(self, conn, msg):
        return {"len": len(self._queues[msg["queue"]])}

    async def _op_ping(self, conn, msg):
        return {"pong": True, "time": time.time()}


async def _amain(host: str, port: int) -> None:
    server = await DcpServer.start(host, port)
    print(f"dcp listening on {server.address}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    try:
        await stop.wait()
    finally:
        await server.stop()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="dynamo_tpu_torch control-plane service")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=6650)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    try:
        asyncio.run(_amain(args.host, args.port))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    main()
