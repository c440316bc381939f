"""The KV router, a copy of ``dynamo_tpu/llm/kv_router/router.py``.

It subscribes the component's ``kv_events`` subject into the
:class:`KvIndexer`, scrapes worker stats into the scheduler, and answers
``schedule(token_ids) -> worker_id`` under a ``route`` span. It prunes
dead workers from the index when they leave discovery, and publishes a
KVHitRateEvent per decision on ``<namespace>.kv-hit-rate``. Each routed
request's predicted overlap is parked until its finish cost block
passes the attribution listener (``runtime/profiling.py``), which
compares it with the engine's realized prefix hit and feeds the
scheduler's ``load_balance_weight`` autotuner.
"""

from __future__ import annotations

import asyncio
import logging
import random
import threading
from collections import OrderedDict
from typing import Dict, Optional, Sequence

from ...runtime import guard, profiling, tracing, wire
from ...runtime.component import Client
from ...runtime.dcp_client import NoRespondersError, pack, unpack
from ...runtime.runtime import DistributedRuntime
from ...runtime.tasks import backoff_interval, cancel_join, spawn_tracked
from .indexer import KvIndexer
from .protocols import (KV_EVENT_SUBJECT, KV_HIT_RATE_SUBJECT,
                        ForwardPassMetrics, KvCacheEventWire)
from .scheduler import KvScheduler

log = logging.getLogger("dynamo_tpu_torch.kv_router")


class KvRouter:
    """Routes requests onto the workers of one component using the global
    prefix index and the load cost function."""

    def __init__(self, drt: DistributedRuntime, namespace: str,
                 component: str, *, block_size: int = 64,
                 load_balance_weight: float = 0.3,
                 scrape_interval: float = 1.0,
                 seed: Optional[int] = None):
        self.drt = drt
        self.namespace = namespace
        self.component = component
        # the event subscription, the scrape loop and every schedule()
        # share these; each touch is one sync call on the event loop
        self.indexer = KvIndexer(block_size)
        self.scheduler = KvScheduler(
            block_size=block_size, load_balance_weight=load_balance_weight,
            on_hit_rate_event=self._on_hit_rate,
            rng=random.Random(seed) if seed is not None else random.Random())
        self.scrape_interval = scrape_interval
        self.client: Optional[Client] = None
        self._sid: Optional[int] = None
        self._scrape_task: Optional[asyncio.Task] = None
        self._hit_events = 0
        self._overlap_blocks_total = 0
        self._isl_blocks_total = 0
        # calibration: per-request predicted overlap parked at
        # schedule() time, compared against the engine's REALIZED prefix
        # split when the finish cost block passes the attribution
        # listener — the first direct measurement of whether overlap
        # routing is right. The listener fires on the engine's executor
        # thread in-process, so this state takes a real lock (not the
        # loop-affinity discipline the indexer/scheduler use).
        self._calib_lock = threading.Lock()
        self._pending_pred: "OrderedDict[str, dict]" = OrderedDict()
        self._pending_cap = 2048
        self.calib_compared = 0
        self.calib_predicted_blocks = 0
        self.calib_realized_blocks = 0
        self.calib_abs_error_blocks = 0

    async def start(self, endpoint: str = "generate_tokens",
                    *, run_loop: bool = True) -> None:
        """``run_loop=False`` skips the periodic scrape task; callers that
        step time themselves call ``scrape_once`` directly."""
        drt = self.drt
        self.client = await drt.namespace(self.namespace) \
            .component(self.component).endpoint(endpoint).client()
        self._sid = await drt.dcp.subscribe(
            f"{self.namespace}.{self.component}.{KV_EVENT_SUBJECT}",
            self._on_events)
        if run_loop:
            self._scrape_task = spawn_tracked(self._scrape_loop(),
                                              name="kv-router-scrape")
        # calibration feed: finish cost blocks (engine-local or re-registered
        # from a remote worker's finish chunk by the Backend) flow past here
        profiling.add_attribution_listener(self._on_attribution)
        profiling.register_cache(f"kv-router-{id(self):x}", self)

    async def stop(self) -> None:
        profiling.remove_attribution_listener(self._on_attribution)
        if self._sid is not None:
            try:
                await self.drt.dcp.unsubscribe(self._sid)
            except Exception:
                log.debug("unsubscribe failed during stop", exc_info=True)
        await cancel_join(self._scrape_task)
        if self.client:
            await self.client.close()

    # ------------------------------------------------------------- inputs

    async def _on_events(self, msg) -> None:
        try:
            for raw in unpack(msg.payload):
                self.indexer.apply_event(KvCacheEventWire.from_dict(raw))
        except Exception:
            log.exception("bad kv event payload")

    async def _scrape_loop(self) -> None:
        failures = 0
        while True:
            try:
                await self.scrape_once()
                failures = 0
            except Exception:
                # bounded backoff: a worker pool that stays unreachable
                # gets probed gently, and every failure is on the record
                failures += 1
                log.exception("stats scrape failed "
                              "(%d consecutive failures)", failures)
            await asyncio.sleep(
                backoff_interval(self.scrape_interval, failures))

    async def scrape_once(self) -> None:
        """Scrape worker stats and reconcile live instances."""
        stats = await self.client.collect_stats(timeout=self.scrape_interval)
        metrics: Dict[int, ForwardPassMetrics] = {}
        for wid, payload in stats.items():
            payload = wire.decoded(wire.DCP_STATS_REPLY, payload)
            metrics[wid] = ForwardPassMetrics.from_dict(payload.get("data", {}))
        self.scheduler.update_metrics(metrics)
        # prune index entries of workers that disappeared from discovery
        live = set(self.client.instance_ids())
        for wid in self.indexer.workers():
            if wid not in live:
                log.info("pruning dead worker %x from KV index", wid)
                self.indexer.remove_worker(wid)

    # ------------------------------------------------------------ routing

    async def schedule(self, token_ids: Sequence[int],
                       request_id: Optional[str] = None,
                       exclude=None) -> int:
        """token_ids -> worker instance id. ``request_id`` keys the
        predicted-vs-realized calibration entry for this decision.
        ``exclude`` (mid-stream failover) drops candidate workers — the
        dead worker a resume must avoid even while its discovery record
        and warm prefix index entries linger."""
        with tracing.get_tracer().start_span("route", attributes={
                "tokens": len(token_ids)}) as span:
            if not self.scheduler.workers:
                await self.scrape_once()
            if not self.scheduler.workers:
                # no stats yet: fall back to any live instance. An EMPTY
                # pool is typed NoResponders (HTTP 503 + Retry-After),
                # not a raw timeout: draining the last worker must leave
                # new requests the retryable no-capacity shape
                try:
                    ids = await self.client.wait_for_instances(timeout=10)
                except asyncio.TimeoutError:
                    raise NoRespondersError(
                        f"no live instances of {self.namespace}."
                        f"{self.component}") from None
                if not self.scheduler.workers:
                    # re-check after the wait: a scrape may have landed
                    # real occupancy during it, and zeroed fallback
                    # metrics must not clobber that view (the router
                    # would dogpile the busiest worker)
                    self.scheduler.update_metrics(
                        {wid: ForwardPassMetrics() for wid in ids})
            overlaps = self.indexer.find_matches_for_request(token_ids)
            # only consider overlaps from live workers
            wid = self.scheduler.schedule(len(token_ids), overlaps,
                                          request_id=request_id,
                                          exclude=exclude)
            if request_id:
                bs = self.scheduler.block_size
                isl_blocks = max((len(token_ids) + bs - 1) // bs, 1)
                with self._calib_lock:
                    self._pending_pred[request_id] = {
                        "worker": wid,
                        "overlap_blocks": min(
                            overlaps.scores.get(wid, 0), isl_blocks),
                        "isl_blocks": isl_blocks,
                        "compared": False,
                    }
                    while len(self._pending_pred) > self._pending_cap:
                        self._pending_pred.popitem(last=False)
            span.set_attribute("worker_id", f"{wid:x}")
            span.set_attribute("overlap_blocks",
                               overlaps.scores.get(wid, 0))
            return wid

    def overlap_for(self, token_ids: Sequence[int], worker_id: int) -> int:
        """Matched prefix BLOCKS on ``worker_id``."""
        scores = self.indexer.find_matches_for_request(token_ids).scores
        return scores.get(worker_id, 0)

    # -------------------------------------------------------- observability

    def _on_attribution(self, request_id: str, cost: dict) -> None:
        """Attribution listener (calibration): when a routed
        request's finish cost block arrives, merge this router's predicted
        overlap into the block (so /v1/traces/{rid} shows
        router_overlap_blocks next to the engine's realized split) and
        accumulate predicted-vs-realized counters. Sync, idempotent per
        request (the engine-local record and the Backend's re-register of
        the same finish both pass through here), and callable from any
        thread."""
        if "device_hit_blocks" not in cost:
            return  # not an engine prefix-split cost block
        with self._calib_lock:
            ent = self._pending_pred.get(request_id)
            if ent is None:
                return
            cost.setdefault("router_overlap_blocks", ent["overlap_blocks"])
            if ent["compared"]:
                return
            ent["compared"] = True
            realized = (int(cost.get("device_hit_blocks", 0))
                        + int(cost.get("host_restored_blocks", 0)))
            predicted = ent["overlap_blocks"]
            self.calib_compared += 1
            self.calib_predicted_blocks += predicted
            self.calib_realized_blocks += realized
            self.calib_abs_error_blocks += abs(predicted - realized)
            # feed the scheduler's load_balance_weight
            # autotuner (no-op unless enabled; bounded adjustment once
            # per calibration window)
            self.scheduler.observe_calibration(predicted, realized,
                                               ent["isl_blocks"])
        guard.counter_inc("dyn_kv_router_predicted_vs_realized_blocks",
                          float(predicted), view="predicted")
        guard.counter_inc("dyn_kv_router_predicted_vs_realized_blocks",
                          float(realized), view="realized")

    def _on_hit_rate(self, ev) -> None:
        self._hit_events += 1
        self._overlap_blocks_total += ev.overlap_blocks
        self._isl_blocks_total += ev.isl_blocks
        spawn_tracked(self._publish_hit_rate(ev), name="kv-hit-rate-pub")

    async def _publish_hit_rate(self, ev) -> None:
        try:
            await self.drt.dcp.publish(
                f"{self.namespace}.{KV_HIT_RATE_SUBJECT}",
                pack(ev.to_dict()))
        except Exception:
            log.debug("hit-rate publish failed", exc_info=True)

    def stats(self) -> dict:
        with self._calib_lock:
            calib = {
                "compared": self.calib_compared,
                "predicted_blocks_total": self.calib_predicted_blocks,
                "realized_blocks_total": self.calib_realized_blocks,
                "abs_error_blocks_total": self.calib_abs_error_blocks,
                "mean_abs_error_blocks": (
                    self.calib_abs_error_blocks
                    / max(self.calib_compared, 1)),
            }
        return {
            "decisions": self._hit_events,
            "avg_hit_rate": (self._overlap_blocks_total /
                             max(self._isl_blocks_total, 1)),
            "indexed_blocks": self.indexer.tree.block_count(),
            "workers": len(self.scheduler.workers),
            # predicted (overlap scoring) vs realized (engine prefix
            # split) blocks over requests whose cost block came back
            "calibration": calib,
            # autotune: the live (possibly self-tuned) cost
            # weight and how often calibration bias actually moved it
            "load_balance_weight": round(
                self.scheduler.load_balance_weight, 4),
            "autotune": {
                "enabled": bool(self.scheduler.autotune),
                "adjustments": self.scheduler.autotune_adjustments,
            },
        }

    def cache_snapshot(self) -> dict:
        """/debug/cache view of the routing side: index size,
        hit-rate aggregates, and the calibration counters."""
        return {"kind": "kv_router", **self.stats()}
