"""The KV router, a copy of ``dynamo_tpu/llm/kv_router/router.py``.

It subscribes the component's ``kv_events`` subject into the
:class:`KvIndexer`, scrapes worker stats into the scheduler, and answers
``schedule(token_ids) -> worker_id``. It prunes dead workers from the
index when they leave discovery, and publishes a KVHitRateEvent per
decision on ``<namespace>.kv-hit-rate``. The reference's calibration
listener (predicted against realized overlap, fed by its profiling
attribution plane) and its routing span are not part of the port.
"""

from __future__ import annotations

import asyncio
import logging
import random
from typing import Dict, Optional, Sequence

from ...runtime import wire
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

    async def stop(self) -> None:
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
        """token_ids -> worker instance id. ``exclude`` drops candidate
        workers."""
        if not self.scheduler.workers:
            await self.scrape_once()
        if not self.scheduler.workers:
            # no stats yet: fall back to any live instance; an EMPTY pool
            # is a typed NoRespondersError, not a raw timeout
            try:
                ids = await self.client.wait_for_instances(timeout=10)
            except asyncio.TimeoutError:
                raise NoRespondersError(
                    f"no live instances of {self.namespace}."
                    f"{self.component}") from None
            if not self.scheduler.workers:
                # re-check after the wait: a scrape may have landed real
                # occupancy meanwhile, which zeroed metrics must not clobber
                self.scheduler.update_metrics(
                    {wid: ForwardPassMetrics() for wid in ids})
        overlaps = self.indexer.find_matches_for_request(token_ids)
        return self.scheduler.schedule(len(token_ids), overlaps,
                                       request_id=request_id,
                                       exclude=exclude)

    def overlap_for(self, token_ids: Sequence[int], worker_id: int) -> int:
        """Matched prefix BLOCKS on ``worker_id``."""
        scores = self.indexer.find_matches_for_request(token_ids).scores
        return scores.get(worker_id, 0)

    # -------------------------------------------------------- observability

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
        return {
            "decisions": self._hit_events,
            "avg_hit_rate": (self._overlap_blocks_total /
                             max(self._isl_blocks_total, 1)),
            "indexed_blocks": self.indexer.tree.block_count(),
            "workers": len(self.scheduler.workers),
            "load_balance_weight": round(
                self.scheduler.load_balance_weight, 4),
        }
