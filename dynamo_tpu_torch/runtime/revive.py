"""dynarevive, the admission half: SLO-aware admission control and the
drain budget.

A copy of that half of ``dynamo_tpu/runtime/revive.py`` (pure Python):

- **SLO-aware admission control** (:class:`AdmissionController`) — the
  HTTP frontend sheds load *before* the engine melts, using signals the
  stack already exports (admission queue depth, loop-lag p99,
  kv_free_blocks), answering early 503s with a load-derived, jittered
  ``Retry-After`` instead of queueing requests it will deadline anyway.
  The jitter (injectable rng) decorrelates client retries so a
  recovering fleet is not re-stampeded at one synchronized instant.
- **The drain budget** (:func:`drain_timeout_s`, ``DYN_DRAIN_TIMEOUT_MS``)
  that ``POST /drain`` gives an engine's ``drain()``.

The other half — the emitted-token journal and mid-stream failover
(``ReviveJournal``, ``ReviveSession``) and the worker drain sequence on
SIGTERM (``drain_worker``) — comes with the runtime plane's fault
handling.
"""

from __future__ import annotations

import logging
import math
import random
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

from . import guard
from .config import env_float, env_int

log = logging.getLogger("dynamo_tpu_torch.revive")


# ------------------------------------------------------------------- drain


def drain_timeout_s(timeout_ms: Optional[float] = None) -> float:
    ms = timeout_ms if timeout_ms is not None else \
        (env_float("DYN_DRAIN_TIMEOUT_MS", 10000.0) or 10000.0)
    return max(ms, 0.0) / 1000.0


# -------------------------------------------------------- admission control


@dataclass(frozen=True)
class ShedConfig:
    """Shed thresholds. 0 disables the corresponding signal entirely —
    the default frontend sheds on nothing until configured."""

    queue_depth: int = 0          # waiting requests per live worker
    loop_lag_ms: float = 0.0      # engine loop-lag p99 (worst worker)
    kv_free_blocks: int = 0       # min free KV blocks (worst worker)
    retry_after_cap_s: float = 8.0

    @classmethod
    def from_env(cls) -> "ShedConfig":
        return cls(
            queue_depth=env_int("DYN_SHED_QUEUE_DEPTH", 0) or 0,
            loop_lag_ms=env_float("DYN_SHED_LOOP_LAG_MS", 0.0) or 0.0,
            kv_free_blocks=env_int("DYN_SHED_KV_FREE_BLOCKS", 0) or 0,
            retry_after_cap_s=env_float("DYN_SHED_RETRY_CAP_S", 8.0)
            or 8.0)

    @property
    def enabled(self) -> bool:
        return bool(self.queue_depth or self.loop_lag_ms
                    or self.kv_free_blocks)


@dataclass
class LoadSignals:
    """One snapshot of the signals the stack already exports."""

    queue_depth: int = 0              # summed admission queue depth
    workers: int = 1                  # live workers contributing
    loop_lag_p99_ms: float = 0.0      # worst per-worker loop-lag p99
    kv_free_blocks: Optional[int] = None  # min free blocks; None=unknown


def signals_from_stats(stats: dict) -> LoadSignals:
    """LoadSignals from one engine's ``stats()`` dict (in-process
    frontend serving its own engine)."""
    return LoadSignals(
        queue_depth=int(stats.get("num_requests_waiting", 0) or 0),
        workers=1,
        loop_lag_p99_ms=float(stats.get("loop_lag_p99_seconds", 0.0)
                              or 0.0) * 1000.0,
        kv_free_blocks=stats.get("kv_free_blocks"))


def signals_from_metrics(worker_metrics: Dict[Any, Any]) -> LoadSignals:
    """LoadSignals from an aggregator's per-worker ForwardPassMetrics
    view (standalone frontend over remote workers). Duck-typed so the
    runtime layer never imports llm protocols."""
    metrics = [m for wid, m in sorted(worker_metrics.items(),
                                      key=lambda kv: repr(kv[0]))
               if not getattr(m, "draining", 0)]
    if not metrics:
        return LoadSignals()
    return LoadSignals(
        queue_depth=sum(int(getattr(m, "num_requests_waiting", 0))
                        for m in metrics),
        workers=len(metrics),
        loop_lag_p99_ms=max(
            float(getattr(m, "loop_lag_p99_seconds", 0.0)) * 1000.0
            for m in metrics),
        kv_free_blocks=min(int(getattr(m, "kv_free_blocks", 0))
                           for m in metrics))


class AdmissionController:
    """Shed-before-melt: evaluate the current load signals against the
    thresholds and either admit or answer an early 503 whose
    ``Retry-After`` is derived from the shed pressure with deterministic
    (injectable-rng) jitter.

    ``signals`` is any zero-arg callable returning :class:`LoadSignals`
    — an engine ``stats()`` adapter in-process, an aggregator view on a
    standalone frontend, or a literal in tests.

    Decisions use a **peak-hold window** over recent observations, not
    just the instantaneous read: batched engines complete requests in
    lockstep, so arrival instants anti-correlate with queue depth — an
    instantaneous read admits a whole wave at the exact moment the queue
    drained into the freed slots. (The reference's optional background
    sampler, ``start()``/``stop()``, has no caller and is not copied.)
    """

    def __init__(self, signals: Callable[[], LoadSignals],
                 cfg: Optional[ShedConfig] = None,
                 rng: Optional[random.Random] = None,
                 window: int = 32):
        self.signals = signals
        self.cfg = cfg or ShedConfig.from_env()
        self.rng = rng if rng is not None else random.Random()
        self.shed_total = 0
        self.shed_by_signal: Dict[str, int] = {}
        self.admitted_total = 0
        self._window: Any = deque(maxlen=max(window, 1))

    def observe(self) -> Optional[LoadSignals]:
        """Read the signal source once into the peak-hold window."""
        try:
            sig = self.signals()
        except Exception:  # noqa: BLE001 — a broken signal source must
            # never turn into a shed storm (or an admit storm): admit
            log.debug("admission signal source failed", exc_info=True)
            return None
        self._window.append(sig)
        return sig

    def _effective(self) -> Optional[LoadSignals]:
        """Fresh read + peak over the recent window."""
        now = self.observe()
        if now is None:
            return None
        window = list(self._window)
        frees = [s.kv_free_blocks for s in window
                 if s.kv_free_blocks is not None]
        return LoadSignals(
            queue_depth=max(s.queue_depth for s in window),
            workers=now.workers,
            loop_lag_p99_ms=max(s.loop_lag_p99_ms for s in window),
            kv_free_blocks=min(frees) if frees else None)

    def evaluate(self) -> Tuple[Optional[str], float]:
        """(shedding signal name | None, pressure). Pressure 1.0 = at
        the threshold; the worst offending signal wins."""
        cfg = self.cfg
        if not cfg.enabled:
            return None, 0.0
        sig = self._effective()
        if sig is None:
            return None, 0.0
        worst: Tuple[Optional[str], float] = (None, 0.0)
        if cfg.queue_depth > 0:
            cap = cfg.queue_depth * max(sig.workers, 1)
            pressure = sig.queue_depth / cap
            if pressure > worst[1]:
                worst = ("queue_depth", pressure)
        if cfg.loop_lag_ms > 0 and sig.loop_lag_p99_ms > 0:
            pressure = sig.loop_lag_p99_ms / cfg.loop_lag_ms
            if pressure > worst[1]:
                worst = ("loop_lag", pressure)
        if cfg.kv_free_blocks > 0 and sig.kv_free_blocks is not None:
            pressure = cfg.kv_free_blocks / max(sig.kv_free_blocks, 1)
            if pressure > worst[1]:
                worst = ("kv_free_blocks", pressure)
        name, pressure = worst
        if name is not None and pressure >= 1.0:
            return name, pressure
        return None, pressure

    def admit(self) -> Optional[int]:
        """None = admit; otherwise the Retry-After (seconds) for the
        shed 503."""
        name, pressure = self.evaluate()
        if name is None:
            self.admitted_total += 1
            return None
        self.shed_total += 1
        self.shed_by_signal[name] = self.shed_by_signal.get(name, 0) + 1
        guard.counter_inc("dyn_shed_requests_total", signal=name)
        return self.retry_after(pressure)

    def retry_after(self, pressure: float = 1.0) -> int:
        return retry_after_s(pressure, rng=self.rng,
                             cap_s=self.cfg.retry_after_cap_s)

    def snapshot(self) -> dict:
        name, pressure = self.evaluate()
        return {
            "enabled": self.cfg.enabled,
            "shedding": name,
            "pressure": round(pressure, 4),
            "shed_total": self.shed_total,
            "shed_by_signal": dict(sorted(self.shed_by_signal.items())),
            "admitted_total": self.admitted_total,
        }


# process-default rng for Retry-After jitter on paths with no controller
_RETRY_RNG = random.Random()


def retry_after_s(pressure: float = 1.0,
                  rng: Optional[random.Random] = None,
                  cap_s: Optional[float] = None) -> int:
    """Load-derived, jittered Retry-After: grows with shed pressure,
    capped, and jittered ±40% so synchronized client retries spread out
    instead of re-stampeding a recovering fleet at one instant. Always
    at least 1 (the HTTP delta-seconds floor)."""
    if cap_s is None:
        cap_s = env_float("DYN_SHED_RETRY_CAP_S", 8.0) or 8.0
    r = rng if rng is not None else _RETRY_RNG
    base = min(max(pressure, 1.0), cap_s)
    return max(1, int(math.ceil(min(base * r.uniform(0.6, 1.4), cap_s))))
