"""KV-aware worker selection, a copy of ``dynamo_tpu/llm/kv_router/scheduler.py``.

Pick the worker minimizing

    cost = alpha * load_deviation              (KV usage vs fleet mean)
         + (1 - alpha) * normalized_new_tokens (1 - prefix overlap ratio)
         + gamma * request_load_ratio          (active / total slots)

with alpha 0.3 favouring cache reuse and 0.7 load balancing. Saturated
workers (no free request slots or KV blocks), draining workers and
prefill-role workers are skipped; optimistic local accounting bumps the
chosen worker's slots and blocks so a burst of schedules between metric
scrapes does not pile onto one worker; every decision emits a
KVHitRateEvent. Ties break on ``rng`` (seed it for replayable runs).
``load_balance_weight`` tunes itself from the router's
predicted-vs-realized overlap (:meth:`KvScheduler.observe_calibration`,
``DYN_ROUTER_AUTOTUNE``, on by default as in the reference).
"""

from __future__ import annotations

import random
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ...runtime import guard
from ...runtime.config import env_bool, env_float
from .indexer import OverlapScores
from .protocols import ForwardPassMetrics, KVHitRateEvent


@dataclass
class WorkerState:
    metrics: ForwardPassMetrics
    # optimistic deltas applied since the last scrape
    extra_requests: int = 0
    extra_blocks: int = 0

    @property
    def active_slots(self) -> int:
        return self.metrics.request_active_slots + self.extra_requests

    @property
    def active_blocks(self) -> int:
        return self.metrics.kv_active_blocks + self.extra_blocks

    @property
    def usage(self) -> float:
        total = max(self.metrics.kv_total_blocks, 1)
        return self.active_blocks / total

    def saturated(self) -> bool:
        m = self.metrics
        slots_full = (m.request_total_slots > 0
                      and self.active_slots >= m.request_total_slots)
        blocks_full = (m.kv_total_blocks > 0
                       and self.active_blocks >= m.kv_total_blocks)
        return slots_full or blocks_full


@dataclass
class KvScheduler:
    block_size: int
    load_balance_weight: float = 0.3   # alpha: 0.3 favors cache reuse,
    #                                     0.7 favors load balancing
    slot_weight: float = 0.25          # gamma
    on_hit_rate_event: Optional[Callable[[KVHitRateEvent], None]] = None
    workers: Dict[int, WorkerState] = field(default_factory=dict)
    rng: random.Random = field(default_factory=random.Random)
    # the last N decisions: every candidate's capped overlap and the pick
    decisions: deque = field(default_factory=lambda: deque(maxlen=256))
    # autotune: load_balance_weight self-adjusts from the
    # predicted-vs-realized overlap calibration error the router feeds
    # back through observe_calibration(). Systematic OVER-prediction (the
    # index promises overlap the engines no longer hold — evicted or
    # stale blocks) means the overlap term is over-trusted, so weight
    # shifts toward load; under-prediction shifts it back. None reads
    # DYN_ROUTER_AUTOTUNE / DYN_ROUTER_AUTOTUNE_GAIN.
    autotune: Optional[bool] = None
    autotune_gain: Optional[float] = None
    autotune_window: int = 64          # compared requests per adjustment
    alpha_min: float = 0.1             # hard bounds on the tuned weight
    alpha_max: float = 0.9
    autotune_adjustments: int = 0      # times the weight actually moved
    _tune_pred: int = 0                # window accumulators
    _tune_real: int = 0
    _tune_isl: int = 0
    _tune_seen: int = 0

    def __post_init__(self) -> None:
        if self.autotune is None:
            self.autotune = env_bool("DYN_ROUTER_AUTOTUNE", True)
        if self.autotune_gain is None:
            self.autotune_gain = env_float("DYN_ROUTER_AUTOTUNE_GAIN",
                                           0.05) or 0.0

    def observe_calibration(self, predicted: int, realized: int,
                            isl_blocks: int) -> None:
        """One compared request's predicted vs realized overlap blocks
        (called by KvRouter._on_attribution under its calibration lock).
        Every ``autotune_window`` observations the window bias
        ``(pred − real) / isl`` nudges ``load_balance_weight`` by
        ``gain · bias · range``, clamped to [alpha_min, alpha_max]; zero
        bias (perfect calibration) moves nothing. The current weight is
        exported as the ``dyn_kv_router_load_balance_weight`` gauge."""
        if not self.autotune:
            return
        self._tune_pred += predicted
        self._tune_real += realized
        self._tune_isl += isl_blocks
        self._tune_seen += 1
        if self._tune_seen < self.autotune_window:
            return
        bias = (self._tune_pred - self._tune_real) / max(self._tune_isl, 1)
        self._tune_pred = self._tune_real = self._tune_isl = 0
        self._tune_seen = 0
        step = self.autotune_gain * bias * (self.alpha_max - self.alpha_min)
        if step == 0.0:
            return
        new_w = min(max(self.load_balance_weight + step, self.alpha_min),
                    self.alpha_max)
        if new_w != self.load_balance_weight:
            self.load_balance_weight = new_w
            self.autotune_adjustments += 1
        # gauge semantics over the counter store: set-by-delta so the
        # exposition always shows the CURRENT weight
        guard.counter_inc(
            "dyn_kv_router_load_balance_weight",
            new_w - guard.counter_value("dyn_kv_router_load_balance_weight"))

    def update_metrics(self, metrics: Dict[int, ForwardPassMetrics]) -> None:
        """Replace worker snapshots (periodic scrape) and reset the
        optimistic deltas."""
        self.workers = {wid: WorkerState(m) for wid, m in metrics.items()}

    def schedule(self, num_tokens: int, overlaps: OverlapScores,
                 request_id: Optional[str] = None,
                 exclude=None) -> int:
        """Pick a worker for a request of ``num_tokens`` prompt tokens.
        Raises RuntimeError when no worker is available. ``exclude``
        drops candidates outright."""
        if not self.workers:
            raise RuntimeError("no workers registered with the KV scheduler")
        isl_blocks = max((num_tokens + self.block_size - 1) // self.block_size, 1)
        usages = [w.usage for w in self.workers.values()]
        mean_usage = sum(usages) / len(usages)

        alpha = self.load_balance_weight
        excluded = set(exclude) if exclude else ()
        best_cost = None
        best: List[int] = []
        for wid, w in self.workers.items():
            if wid in excluded:
                continue
            if getattr(w.metrics, "draining", 0):
                continue
            if getattr(w.metrics, "role", "") == "prefill":
                continue
            if w.saturated():
                continue
            overlap = min(overlaps.scores.get(wid, 0), isl_blocks)
            new_ratio = 1.0 - overlap / isl_blocks
            load_dev = w.usage - mean_usage
            slots = w.active_slots / max(w.metrics.request_total_slots, 1)
            cost = alpha * load_dev + (1 - alpha) * new_ratio \
                + self.slot_weight * slots
            if best_cost is None or cost < best_cost - 1e-9:
                best_cost, best = cost, [wid]
            elif abs(cost - best_cost) <= 1e-9:
                best.append(wid)
        if not best:
            raise RuntimeError("all workers saturated")
        chosen = self.rng.choice(best)
        scores = overlaps.scores
        chosen_overlap = min(scores.get(chosen, 0), isl_blocks)
        self.decisions.append({
            "request_id": request_id,
            "chosen": chosen,
            "isl_blocks": isl_blocks,
            "overlap_blocks": chosen_overlap,
            "candidates": {wid: min(scores.get(wid, 0), isl_blocks)
                           for wid in self.workers},
        })
        # optimistic accounting until the next scrape
        w = self.workers[chosen]
        w.extra_requests += 1
        w.extra_blocks += isl_blocks - chosen_overlap
        if self.on_hit_rate_event:
            self.on_hit_rate_event(KVHitRateEvent(
                worker_id=chosen, isl_blocks=isl_blocks,
                overlap_blocks=chosen_overlap))
        return chosen
