"""Component model: Namespace -> Component -> Endpoint addressing and
serving, a copy of ``dynamo_tpu/runtime/component.py``.

The discovery record of a served endpoint lives at
``instances/<ns>/components/<comp>/<ep>:<lease_hex>`` in the KV store
(under the worker's primary lease), and its request-plane subject is
``<ns>.<comp>.<ep>-<lease_hex>``. Serving an endpoint registers the
subject consumer and writes the instance record; a :class:`Client`
watches the prefix and routes round_robin / random / direct, under the
retry policy and per-instance circuit breakers. The same keys, subjects
and frames as the reference, so port and reference processes discover
and call each other.

A served request runs under a ``serve.<endpoint>`` span parented on the
trace context the caller stamped on the envelope (``trace``), and
``Client.generate`` stamps the ambient context on the envelopes it
sends. The handle's lifecycle is the ``serve_handle.drain`` machine of
``runtime/proto.py``; the ``worker.kill`` chaos point
(``runtime/guard.py``) is consulted once per streamed frame when chaos
is configured, and a fire turns the handle into a wedged process.
"""

from __future__ import annotations

import asyncio
import logging
import random
from dataclasses import dataclass
from typing import (Any, AsyncIterator, Callable, Dict, List, Optional,
                    Tuple)

from . import guard, proto, tracing, wire
from .config import env_float, env_int
from .dcp_client import Message, NoRespondersError, pack, unpack
from .engine import Annotated, Context
from .tasks import cancel_join, spawn_tracked
from .tcp import (STREAM_COMPLETE, StreamError, TcpCallHome, TcpConnectionInfo,
                  TcpStreamServer)

log = logging.getLogger("dynamo_tpu_torch.component")

INSTANCE_ROOT = "instances/"  # KV prefix for endpoint instance records


def instance_key(namespace: str, component: str, endpoint: str, lease: int) -> str:
    return f"{INSTANCE_ROOT}{namespace}/components/{component}/{endpoint}:{lease:x}"


def instance_prefix(namespace: str, component: str, endpoint: str) -> str:
    return f"{INSTANCE_ROOT}{namespace}/components/{component}/{endpoint}:"


def instance_subject(namespace: str, component: str, endpoint: str,
                     lease: int) -> str:
    return f"{namespace}.{component}.{endpoint}-{lease:x}"


def shared_subject(namespace: str, component: str, endpoint: str) -> str:
    return f"{namespace}.{component}.{endpoint}"


@dataclass(frozen=True)
class EndpointAddress:
    """Parsed ``dyn://namespace.component.endpoint`` address."""

    namespace: str
    component: str
    endpoint: str

    @classmethod
    def parse(cls, path: str) -> "EndpointAddress":
        p = path[len("dyn://"):] if path.startswith("dyn://") else path
        parts = p.split(".")
        if len(parts) == 2:
            parts = [parts[0], parts[1], "generate"]
        if len(parts) != 3:
            raise ValueError(
                f"endpoint path must be namespace.component[.endpoint]: {path!r}")
        return cls(*parts)

    def __str__(self) -> str:
        return f"dyn://{self.namespace}.{self.component}.{self.endpoint}"


@dataclass
class EndpointInstance:
    """A live, discoverable endpoint instance."""

    namespace: str
    component: str
    endpoint: str
    instance_id: int  # == serving worker's lease id
    subject: str
    transport: str = "dcp+tcp"

    def to_dict(self) -> dict:
        return {
            "namespace": self.namespace, "component": self.component,
            "endpoint": self.endpoint, "instance_id": self.instance_id,
            "subject": self.subject, "transport": self.transport,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "EndpointInstance":
        return cls(
            namespace=d["namespace"], component=d["component"],
            endpoint=d["endpoint"], instance_id=d["instance_id"],
            subject=d["subject"], transport=d.get("transport", "dcp+tcp"))


class Namespace:
    def __init__(self, drt: "DistributedRuntime", name: str):  # noqa: F821
        self.drt = drt
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self.drt, self.name, name)


class Component:
    def __init__(self, drt, namespace: str, name: str):
        self.drt = drt
        self.namespace = namespace
        self.name = name
        self._service_created = False

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self.drt, self.namespace, self.name, name)

    async def create_service(self) -> None:
        """Registers the component's service record (stats root)."""
        self._service_created = True
        await self.drt.dcp.kv_create(
            f"services/{self.namespace}/{self.name}",
            pack({"namespace": self.namespace, "component": self.name}),
            lease=self.drt.primary_lease,
        )

    @property
    def service_subject(self) -> str:
        return f"{self.namespace}.{self.name}"


Handler = Callable[[Any, Context], AsyncIterator[Any]]


class Endpoint:
    def __init__(self, drt, namespace: str, component: str, name: str):
        self.drt = drt
        self.namespace = namespace
        self.component = component
        self.name = name

    @property
    def address(self) -> EndpointAddress:
        return EndpointAddress(self.namespace, self.component, self.name)

    @property
    def path(self) -> str:
        return str(self.address)

    def subject_for(self, lease: int) -> str:
        return instance_subject(self.namespace, self.component, self.name, lease)

    async def serve(
        self,
        handler: Handler,
        *,
        stats_handler: Optional[Callable[[], dict]] = None,
        metrics_labels: Optional[dict] = None,
    ) -> "ServeHandle":
        """Serve this endpoint with ``handler(request, context) -> aiter``.

        Registers the request-plane consumer (both the per-instance subject
        and the shared queue-group subject), publishes the discoverable
        instance record under the worker's primary lease, and answers stats
        queries.
        """
        drt = self.drt
        lease = drt.primary_lease
        inst = EndpointInstance(
            namespace=self.namespace, component=self.component,
            endpoint=self.name, instance_id=lease,
            subject=self.subject_for(lease))
        serve_handle = ServeHandle(self, inst, handler, stats_handler)
        await serve_handle._start()
        return serve_handle

    async def client(self) -> "Client":
        c = Client(self.drt, self.address)
        await c._start()
        return c


class _WorkerKilled(Exception):
    """Internal: a ``worker.kill`` chaos rule fired or the handle died
    (:meth:`ServeHandle.die`): it must act like a crashed process (conn
    drops, no error frames, lease and discovery record left behind)."""


class ServeHandle:
    """A served endpoint instance; ``stop()`` to withdraw from discovery,
    ``begin_drain()``/``drain()`` for the graceful path."""

    def __init__(self, endpoint: Endpoint, instance: EndpointInstance,
                 handler: Handler, stats_handler):
        self.endpoint = endpoint
        self.instance = instance
        self.handler = handler
        self.stats_handler = stats_handler
        self._sids: List[int] = []
        self._inflight: Dict[str, Context] = {}
        self._stopped = asyncio.Event()
        # lifecycle (the `serve_handle.drain` machine of runtime/proto.py):
        # draining = discovery record withdrawn, new requests nacked,
        # in-flight streams finishing, stats plane still answering
        # (draining is not dead). dead = a worker.kill chaos rule fired
        # or die() was called, the wedged-process shape (lease and
        # discovery record stay, nothing answers). _drain_started makes
        # begin_drain idempotent while keeping the nack flag OFF until the
        # discovery delete has completed (delete before nack).
        self.draining = False
        self._drain_started = False
        self._dead = False

    async def _start(self) -> None:
        drt = self.endpoint.drt
        on_req = self._on_request
        # per-instance subject (direct routing)
        self._sids.append(await drt.dcp.subscribe(
            self.instance.subject, on_req, group="workers"))
        # shared subject (server-side balanced routing)
        self._sids.append(await drt.dcp.subscribe(
            shared_subject(self.instance.namespace, self.instance.component,
                           self.instance.endpoint),
            on_req, group="workers"))
        # stats subject
        self._sids.append(await drt.dcp.subscribe(
            f"stats.{self.instance.subject}", self._on_stats, group="stats"))
        # discoverable instance record, attached to our lease
        key = instance_key(self.instance.namespace, self.instance.component,
                           self.instance.endpoint, self.instance.instance_id)
        await drt.dcp.kv_put(key, pack(self.instance.to_dict()),
                             lease=self.instance.instance_id)
        log.info("serving %s as instance %x",
                 self.endpoint.path, self.instance.instance_id)

    async def stop(self) -> None:
        drt = self.endpoint.drt
        self._stopped.set()  # proto: serve_handle.drain live|draining->stopped
        # claim the subscriptions before the awaits: a concurrent
        # stop()/drain() interleaving must not double-unsubscribe
        sids, self._sids = self._sids, []
        for sid in sids:
            try:
                await drt.dcp.unsubscribe(sid)
            # teardown sweep: every subscription must be attempted even
            # when one fails; no request path runs through here
            except Exception:
                log.debug("unsubscribe %d failed during stop", sid,
                          exc_info=True)
        await self._withdraw_discovery()
        for ctx in self._inflight.values():
            ctx.kill()

    async def _withdraw_discovery(self) -> None:
        key = instance_key(self.instance.namespace, self.instance.component,
                           self.instance.endpoint, self.instance.instance_id)
        try:
            await self.endpoint.drt.dcp.kv_delete(key)
        # best-effort withdraw on the way out: the lease expiry is the
        # backstop; no client response rides on this path
        except Exception:
            log.debug("discovery withdraw failed for %s",
                      self.instance.subject, exc_info=True)

    # ------------------------------------------------------------- drain

    async def begin_drain(self) -> None:
        """Enter the draining state: delete the discovery record FIRST
        (every watching client drops this instance; routers stop picking
        it), only then nack any request that still reaches the subjects,
        keep answering stats with ``draining=1``, and let in-flight
        streams finish. Draining ≠ dead: nothing errors, no breaker
        opens.

        Ordering is load-bearing: flipping the nack flag before the
        delete lands would have clients re-picking this
        still-discoverable instance into repeated nacks until their
        retry budget dies."""
        if self._drain_started:  # claim-before-await: double begin_drain
            return               # must not double-withdraw (draining=True
        self._drain_started = True  # implies _drain_started)
        log.info("draining %s (instance %x, %d in flight)",
                 self.endpoint.path, self.instance.instance_id,
                 len(self._inflight))
        await self._withdraw_discovery()  # proto: serve_handle.drain live->live
        proto.step("serve_handle.drain", "live", "draining")
        self.draining = True

    async def wait_idle(self, timeout_s: float) -> bool:
        """Wall-bounded wait for the in-flight set to empty. Returns
        False when the timeout expired with work still in flight."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + max(timeout_s, 0.0)
        while self._inflight and loop.time() < deadline:
            await asyncio.sleep(0.02)
        return not self._inflight

    async def drain(self, timeout_s: float = 10.0) -> bool:
        """begin_drain + bounded in-flight wait + full stop. Returns True
        when everything finished inside the budget."""
        await self.begin_drain()
        drained = await self.wait_idle(timeout_s)
        await self.stop()
        return drained

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    async def die(self) -> None:
        """Test hook: apply the ``worker.kill`` chaos shape on demand."""
        await self._on_killed()

    async def _on_killed(self) -> None:
        """Become a wedged process. Streams drop raw, the request and
        stats planes go silent (subscriptions dropped, stats errors), the
        lease keepalive and discovery record stay — the crashed-but-leased
        shape the breaker and failover paths handle — and every in-flight
        context is killed so engine pages free."""
        if self._dead:
            return
        self._dead = True  # proto: serve_handle.drain live|draining->dead
        log.warning("instance %x of %s is now dead (lease and discovery "
                    "record left behind)",
                    self.instance.instance_id, self.endpoint.path)
        sids, self._sids = self._sids, []
        for sid in sids:
            try:
                await self.endpoint.drt.dcp.unsubscribe(sid)
            # a wedged process answers nothing, so nothing here can owe
            # a typed error to a client
            except Exception:
                log.debug("unsubscribe during die() failed",
                          exc_info=True)
        for ctx in self._inflight.values():
            ctx.kill()

    async def _on_stats(self, msg: Message) -> None:
        if self._dead:
            # a dead process answers nothing; erroring (vs timing out)
            # keeps the test/scrape planes fast while the breaker still
            # counts the failure
            await msg.respond_error("worker dead")
            return
        try:
            data = self.stats_handler() if self.stats_handler else {}
        except Exception as e:
            # must answer (error), not leave the scraper waiting out its
            # full request timeout every round
            log.debug("stats handler failed for %s", self.instance.subject,
                      exc_info=True)
            await msg.respond_error(f"stats handler failed: {e!r}")
            return
        if self.draining:
            # draining ≠ dead: the scrape plane keeps answering, flagged,
            # so the router/aggregator treat this instance as leaving —
            # not as a failure to break on
            data = dict(data, draining=1)
        await msg.respond(pack(wire.checked(wire.DCP_STATS_REPLY, {
            "instance_id": self.instance.instance_id,
            "subject": self.instance.subject,
            "inflight": len(self._inflight),
            "data": data,
        })))

    async def _on_request(self, msg: Message) -> None:
        """Request-plane delivery: ack over the request plane, then stream
        responses over the TCP call-home connection."""
        try:
            envelope = wire.decoded(wire.DCP_REQUEST_ENVELOPE,
                                    unpack(msg.payload))
            req_id = envelope["req_id"]
            conn_info = TcpConnectionInfo.from_dict(envelope["conn"])
            request = unpack(envelope["payload"])
            # deadline propagation: absent field = no deadline (legacy
            # peer); the value is the REMAINING budget at the sender's
            # send time, rebuilt against this host's clock
            deadline_ms = envelope.get("deadline_ms")
            # trace propagation: absent field = no parent
            trace_ctx = envelope.get("trace")
        except Exception as e:
            if msg.needs_reply:
                await msg.respond_error(f"bad request envelope: {e!r}")
            return
        if self._dead:
            return  # a dead process never acks: the caller's ack wait fails
        if self.draining:
            # drain admits nothing new: a nack the Client maps to
            # "request rejected" (retry lands on a live sibling)
            # proto: serve_handle.drain draining->draining
            if msg.needs_reply:
                await msg.respond(pack(wire.checked(wire.DCP_REQUEST_ACK, {
                    "accepted": False,
                    "instance_id": self.instance.instance_id})))
            return
        if msg.needs_reply:
            await msg.respond(pack(wire.checked(wire.DCP_REQUEST_ACK, {
                "accepted": True,
                "instance_id": self.instance.instance_id})))
        spawn_tracked(self._run_request(req_id, conn_info, request, trace_ctx,
                                        deadline_ms),
                      name=f"serve-{req_id}")

    async def _run_request(self, req_id: str, conn_info: TcpConnectionInfo,
                           request: Any,
                           trace_ctx: Optional[dict] = None,
                           deadline_ms: Optional[int] = None) -> None:
        ctx = Context(req_id,
                      deadline=guard.Deadline.from_wire_ms(deadline_ms))
        self._inflight[req_id] = ctx
        tracing.bind_request_id(req_id)
        span = tracing.get_tracer().start_span(
            f"serve.{self.instance.endpoint}",
            parent=trace_ctx,  # None: a new (sampled) root on this worker
            attributes={"subject": self.instance.subject},
            request_id=req_id)

        def on_ctrl(kind: str) -> None:
            if kind == "stop":
                ctx.stop_generating()
            else:  # kill / disconnect
                ctx.kill()

        callhome: Optional[TcpCallHome] = None
        try:
            with span:
                callhome = await TcpCallHome.connect(conn_info, on_ctrl)
                agen = self.handler(request, ctx)
                async for item in agen:
                    if ctx.killed:
                        break
                    if guard.chaos() is not None or self._dead:
                        # a fired `worker.kill` rule turns THIS handle
                        # into a wedged process; sibling streams on the
                        # same handle die with it. The gate keeps the
                        # chaos coroutine off the path when no chaos is
                        # configured.
                        if self._dead:
                            raise _WorkerKilled()
                        try:
                            await guard.chaos_point("worker.kill")
                        except (guard.ChaosError,
                                ConnectionResetError) as e:
                            raise _WorkerKilled() from e
                    env = item if isinstance(item, Annotated) \
                        else Annotated(data=item)
                    if env.id is None:
                        env.id = req_id
                    await callhome.send_data(pack(env.to_dict()))
                if self._dead:
                    raise _WorkerKilled()
                await callhome.complete()
        except _WorkerKilled:
            # die like a process: no error frame, no complete — the
            # caller sees a raw connection drop (finally closes it)
            await self._on_killed()
        except asyncio.CancelledError:
            if callhome:
                await callhome.error("worker cancelled")
        # not a swallow: the exception crosses the wire as an err frame
        # whose `kind` is the exception class name — AsyncResponseStream
        # re-raises DeadlineExceeded/NoCapacity/NoRespondersError typed
        # on the caller side, so the 504/503 mappers still see them
        except Exception as e:
            log.exception("handler failed for %s", req_id)
            if callhome:
                try:
                    await callhome.error(str(e), kind=type(e).__name__)
                except (ConnectionError, RuntimeError):
                    # conn already dead: the caller sees the drop anyway
                    log.debug("error frame for %s not delivered", req_id,
                              exc_info=True)
        finally:
            self._inflight.pop(req_id, None)
            if callhome:
                await callhome.close()


class AsyncResponseStream:
    """Caller-side response stream: async-iterates Annotated envelopes."""

    def __init__(self, pending, context: Context):
        self._pending = pending
        self.context = context

    def __aiter__(self):
        return self

    async def __anext__(self) -> Annotated:
        # the stream read is bounded by the request deadline: a wedged
        # worker costs the caller its remaining budget, never forever
        try:
            item = await guard.bound(self._pending.queue.get(),
                                     deadline=self.context.deadline,
                                     what="response stream read")
        except guard.DeadlineExceeded:
            self.context.kill()
            await self._pending.send_ctrl("kill")
            self._pending.close()
            raise
        if item is STREAM_COMPLETE:
            self._pending.close()
            raise StopAsyncIteration
        if isinstance(item, StreamError):
            self._pending.close()
            # typed re-raise by worker-side exception kind: client-error
            # kinds map to 4xx, deadline/capacity kinds keep their type
            # across the hop so frontends answer 504/503 — everything
            # else is a server-side RuntimeError
            if item.kind in ("ValueError", "ValidationError"):
                raise ValueError(item.message)
            if item.kind == "DeadlineExceeded":
                raise guard.DeadlineExceeded(item.message)
            if item.kind in ("NoCapacity", "NoRespondersError"):
                raise guard.NoCapacity(item.message)
            raise RuntimeError(
                f"stream error ({item.kind or 'unknown'}): {item.message}")
        return Annotated.from_dict(unpack(item))

    async def stop_generating(self) -> None:
        self.context.stop_generating()
        await self._pending.send_ctrl("stop")

    async def kill(self) -> None:
        self.context.kill()
        await self._pending.send_ctrl("kill")

    def close(self) -> None:
        self._pending.close()


class Client:
    """Endpoint client with discovery and routing: watches the instance
    prefix, maintains the live instance list, and routes ``random`` /
    ``round_robin`` / ``direct``."""

    # consecutive stats-plane failures before an instance's breaker opens
    STATS_EVICTION_THRESHOLD = 3
    # an open breaker offers a half-open probe every Nth denied round
    STATS_RETRY_EVERY = 5

    def __init__(self, drt, address: EndpointAddress,
                 retry: Optional[guard.RetryPolicy] = None):
        self.drt = drt
        self.address = address
        # written by the watch loop, snapshotted by routing and stats
        # collection; every post-await consumer re-validates membership
        # against it (collect_stats drops instances that departed during
        # the scrape gather rather than resurrecting their breakers)
        self.instances: Dict[int, EndpointInstance] = {}
        self._watch = None
        self._watch_task: Optional[asyncio.Task] = None
        self._rr = 0
        self._instances_event = asyncio.Event()
        # per-endpoint circuit breakers, one per (plane, instance):
        # "stats" guards the scrape plane (a crashed-but-leased worker
        # stops costing every round a failed probe), "request" guards
        # routing (a dead instance stops receiving picks). Discovery,
        # not breaker state, owns membership: instances stay in
        # ``instances`` and a fresh discovery put resets their breakers.
        self.breakers = guard.BreakerBoard(
            f"client:{address}",
            guard.BreakerConfig(
                threshold=env_int("DYN_BREAKER_THRESHOLD",
                                  self.STATS_EVICTION_THRESHOLD) or 3,
                probe_every=env_int("DYN_BREAKER_PROBE_EVERY",
                                    self.STATS_RETRY_EVERY) or 5,
                reset_after_s=env_float("DYN_BREAKER_RESET_S", 0.0) or 0.0))
        # shared retry policy: route resolution, dispatch, stats scrapes
        self.retry = retry or guard.RetryPolicy.from_env()

    async def _start(self) -> None:
        prefix = instance_prefix(self.address.namespace, self.address.component,
                                 self.address.endpoint)
        items, watch = await self.drt.dcp.kv_watch_prefix(prefix)
        for item in items:
            inst = EndpointInstance.from_dict(unpack(item.value))
            self.instances[inst.instance_id] = inst
        if self.instances:
            self._instances_event.set()
        self._watch = watch
        self._watch_task = spawn_tracked(
            self._watch_loop(), name=f"client-watch-{self.address}")

    async def _watch_loop(self) -> None:
        async for ev in self._watch:
            if ev.event == "put":
                inst = EndpointInstance.from_dict(unpack(ev.value))
                # a fresh discovery record closes the instance's
                # breakers: the worker re-registered, so probe it again
                self.breakers.reset("stats", inst.instance_id)
                self.breakers.reset("request", inst.instance_id)
                self.instances[inst.instance_id] = inst
                self._instances_event.set()
            elif ev.event == "delete":
                lease_hex = ev.key.rsplit(":", 1)[-1]
                try:
                    wid = int(lease_hex, 16)
                except ValueError:
                    continue
                self.instances.pop(wid, None)
                self.breakers.drop("stats", wid)
                self.breakers.drop("request", wid)
                if not self.instances:
                    self._instances_event.clear()

    async def close(self) -> None:
        if self._watch:
            await self._watch.stop()
        await cancel_join(self._watch_task)

    def instance_ids(self) -> List[int]:
        return sorted(self.instances)

    async def wait_for_instances(self, timeout: float = 30.0) -> List[int]:
        await asyncio.wait_for(self._instances_event.wait(), timeout)
        return self.instance_ids()

    # ------------------------------------------------------------- routing

    def _pick(self, mode: str, instance_id: Optional[int]
              ) -> Tuple[int, str]:
        """Returns ``(instance_id, subject)`` for the chosen route.
        Instances whose request-plane breaker is open are skipped
        (half-open single probes are admitted); when the breaker blocks
        every live instance the caller gets a typed :class:`NoCapacity`
        (HTTP 503), not a hang or a 500."""
        ids = self.instance_ids()
        if mode == "direct":
            if instance_id not in self.instances:
                raise RuntimeError(
                    f"instance {instance_id:x} of {self.address} not found"
                    if instance_id is not None else "direct() needs instance_id")
            if not self.breakers.get("request", instance_id).allow():
                raise guard.NoCapacity(
                    f"instance {instance_id:x} of {self.address} is "
                    f"circuit-broken")
            return instance_id, self.instances[instance_id].subject
        if not ids:
            raise NoRespondersError(f"no live instances of {self.address}")
        avail = [i for i in ids if self.breakers.get("request", i).allow()]
        if not avail:
            raise guard.NoCapacity(
                f"all {len(ids)} instances of {self.address} are "
                f"circuit-broken")
        if mode == "random":
            wid = random.choice(avail)
        elif mode == "round_robin":
            wid = avail[self._rr % len(avail)]
            self._rr += 1
        else:
            raise ValueError(f"unknown routing mode {mode}")
        for i in avail:  # hand back unused half-open probe permits
            if i != wid:
                self.breakers.get("request", i).release_probe()
        return wid, self.instances[wid].subject

    async def generate(self, request: Any, *, mode: str = "round_robin",
                       instance_id: Optional[int] = None,
                       context: Optional[Context] = None,
                       timeout: Optional[float] = None,
                       retry: Optional[guard.RetryPolicy] = None
                       ) -> AsyncResponseStream:
        """Issue a request; returns the streaming response.

        Registers the local response stream, sends the request (with
        call-home connection info) over the request plane, awaits the
        worker's ack.

        Route resolution and dispatch run under the shared
        :class:`~dynamo_tpu_torch.runtime.guard.RetryPolicy` (budget-aware:
        attempts never outlive ``context.deadline``); each attempt's ack
        wait is capped by the remaining deadline, and per-instance
        request breakers record the outcome. ``direct`` mode never
        retries — the caller (the processor) owns its fallback.
        """
        ctx = context or Context()
        deadline = ctx.deadline
        if timeout is None:
            timeout = env_float("DYN_REQUEST_TIMEOUT", 60.0) or 60.0
        policy = retry or self.retry
        last: Optional[BaseException] = None
        async for _attempt in policy.attempts(deadline):
            try:
                wid, subject = self._pick(mode, instance_id)
            except (NoRespondersError, guard.NoCapacity) as e:
                if mode == "direct":
                    raise
                last = e
                continue  # instances may (re)appear within the budget
            try:
                return await self._dispatch(wid, subject, request, ctx,
                                            timeout, deadline)
            except asyncio.CancelledError:
                raise
            except guard.DeadlineExceeded:
                raise
            except Exception as e:
                self.breakers.get("request", wid).record_failure()
                if mode == "direct":
                    raise
                last = e
                log.warning("dispatch to instance %x of %s failed (%s); "
                            "retrying within budget", wid, self.address, e)
        raise last if last is not None else NoRespondersError(
            f"no live instances of {self.address}")

    async def _dispatch(self, wid: int, subject: str, request: Any,
                        ctx: Context, timeout: float,
                        deadline) -> AsyncResponseStream:
        """One dispatch attempt: register the response stream, send the
        envelope (deadline budget re-stamped at send time), await the
        worker's ack bounded by min(timeout, remaining budget)."""
        server: TcpStreamServer = await self.drt.tcp_server()
        pending = server.register()
        env_dict = {
            "req_id": ctx.id,
            "conn": TcpConnectionInfo(server.address, pending.subject).to_dict(),
            "payload": pack(request),
        }
        if deadline is not None:  # absent on the wire = no deadline
            env_dict["deadline_ms"] = deadline.to_wire_ms()
        trace_ctx = tracing.get_tracer().current_trace_ctx()
        if trace_ctx is not None:  # omitted entirely when not sampled
            env_dict["trace"] = trace_ctx
        envelope = pack(wire.checked(wire.DCP_REQUEST_ENVELOPE, env_dict))
        try:
            ack = wire.decoded(wire.DCP_REQUEST_ACK, unpack(
                await guard.bound(
                    self.drt.dcp.request(subject, envelope,
                                         timeout=timeout),
                    timeout=timeout, deadline=deadline,
                    what=f"request ack from {self.address}")))
            if not ack.get("accepted"):
                raise RuntimeError(f"request rejected: {ack}")
        except BaseException:
            pending.close()
            raise
        self.breakers.get("request", wid).record_success()
        return AsyncResponseStream(pending, ctx)

    async def round_robin(self, request: Any, **kw) -> AsyncResponseStream:
        return await self.generate(request, mode="round_robin", **kw)

    async def random(self, request: Any, **kw) -> AsyncResponseStream:
        return await self.generate(request, mode="random", **kw)

    async def direct(self, request: Any, instance_id: int, **kw) -> AsyncResponseStream:
        return await self.generate(request, mode="direct", instance_id=instance_id, **kw)

    # ------------------------------------------------------------- stats

    def evicted_ids(self) -> List[int]:
        """Instances whose stats-plane breaker is not closed (crashed-
        but-leased or blacked-out workers): off the scrape targets until
        a half-open probe succeeds or a fresh discovery put resets them.
        Only live-discovered instances are reported."""
        return sorted(wid for wid in self.instances
                      if self.breakers.get("stats", wid).state
                      != guard.BREAKER_CLOSED)

    async def collect_stats(self, timeout: Optional[float] = None
                            ) -> Dict[int, dict]:
        """Scrape per-instance stats over the request plane.

        Each instance's probe runs behind its stats-plane circuit
        breaker: ``STATS_EVICTION_THRESHOLD`` consecutive failed rounds
        open it (the instance stops costing every round a failed probe),
        an open breaker admits a single half-open re-probe every
        ``STATS_RETRY_EVERY``-th round, and a success closes it again.
        A failed probe is retried within the round under the shared
        RetryPolicy before it counts against the breaker."""
        if timeout is None:
            timeout = env_float("DYN_STATS_TIMEOUT", 2.0) or 2.0
        targets = [i for i in sorted(self.instances.values(),
                                     key=lambda i: i.instance_id)
                   if self.breakers.get("stats", i.instance_id).allow()]

        async def _probe(inst: EndpointInstance) -> dict:
            return wire.decoded(wire.DCP_STATS_REPLY, unpack(
                await self.drt.dcp.request(
                    f"stats.{inst.subject}", b"", timeout=timeout)))

        async def _one(inst: EndpointInstance) -> Optional[dict]:
            try:
                return await self.retry.run(
                    lambda: _probe(inst), retry_on=(Exception,),
                    what=f"stats probe {inst.instance_id:x}")
            except Exception:
                log.debug("stats probe failed for instance %x of %s",
                          inst.instance_id, self.address, exc_info=True)
                return None

        replies = await asyncio.gather(*(_one(i) for i in targets))
        # assemble in instance-id order (not completion order) so metric
        # consumers — router scheduler, planner — see a deterministic view
        out: Dict[int, dict] = {}
        for inst, resp in zip(targets, replies):
            if inst.instance_id not in self.instances:
                # departed during the gather (watch-loop delete dropped
                # its breakers): recording would resurrect a breaker for
                # a dead instance and leak a ghost gauge row
                continue
            br = self.breakers.get("stats", inst.instance_id)
            was_open = br.state != guard.BREAKER_CLOSED
            if resp is None:
                br.record_failure()
                if not was_open and br.state == guard.BREAKER_OPEN:
                    log.warning(
                        "instance %x of %s failed %d consecutive stats "
                        "rounds; breaker open (off the scrape targets)",
                        inst.instance_id, self.address, br.cfg.threshold)
            else:
                br.record_success()
                if was_open:
                    log.info("instance %x of %s answered again; breaker "
                             "closed", inst.instance_id, self.address)
                out[inst.instance_id] = resp
        return out
