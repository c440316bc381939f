"""Mid-stream request failover, graceful worker drain and SLO-aware
admission control, a copy of ``dynamo_tpu/runtime/revive.py`` (pure
Python).

- **Mid-stream failover** (:class:`ReviveSession` + :class:`ReviveJournal`)
  — the frontend processor journals every token it has already emitted
  for an in-flight request (bounded host-list appends; nothing on the
  device path). When the upstream stream dies before a finish chunk
  (connection drop, worker crash, breaker open), the processor
  re-dispatches to a sibling worker with ``prompt + emitted_tokens`` as
  the new prompt and splices the continuation into the same client
  stream. Greedy requests resume token-identical up to the numerics of a
  prefill against a decode window (the resumed prefill recomputes the
  model state the dead worker held), and the KV router's overlap scoring
  lands the retry on the replica with the warmest prefix.
- **Graceful drain** (:func:`drain_worker`) — the SIGTERM sequence:
  delete the discovery record (no new admissions), finish in-flight
  sequences bounded by ``DYN_DRAIN_TIMEOUT_MS``, flush KV events, then
  stop serving; the caller releases the lease. Draining is not dead: the
  stats plane keeps answering (with ``draining=1``) and in-flight
  streams complete.
- **SLO-aware admission control** (:class:`AdmissionController`) — the
  HTTP frontend sheds load *before* the engine melts, using signals the
  stack already exports (admission queue depth, loop-lag p99,
  kv_free_blocks), answering early 503s with a load-derived, jittered
  ``Retry-After`` instead of queueing requests it will deadline anyway.
  The jitter (injectable rng) decorrelates client retries so a
  recovering fleet is not re-stampeded at one synchronized instant.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import math
import random
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import guard
from .config import env_float, env_int

log = logging.getLogger("dynamo_tpu_torch.revive")


# ------------------------------------------------------------------ journal


class JournalEntry:
    """Emitted-token journal of one in-flight request. Append-only host
    list bounded by ``DYN_REVIVE_JOURNAL_TOKENS``; overflowing the bound
    marks the request non-resumable (we can no longer reconstruct the
    full resume prompt) rather than silently truncating it."""

    __slots__ = ("request_id", "prompt_tokens", "tokens", "resumes",
                 "resumable", "finished", "opened_at", "_bound")

    def __init__(self, request_id: str, prompt_tokens: int,
                 max_tokens: int):
        self.request_id = request_id
        self.prompt_tokens = prompt_tokens
        self.tokens: List[int] = []
        self.resumes = 0
        self.resumable = True
        self.finished = False
        self.opened_at = time.monotonic()
        self._bound = max_tokens

    def record(self, token_ids: List[int]) -> None:
        if not token_ids:
            return
        if len(self.tokens) + len(token_ids) > self._bound:
            self.resumable = False  # proto: revive.journal open->open
            return
        self.tokens.extend(token_ids)


class ReviveJournal:
    """Process-wide bounded ring of per-request token journals.

    Entries open at dispatch and close at finish/cancel, so steady state
    holds one entry per in-flight request; the ring cap
    (``DYN_REVIVE_RING``) only matters under leak bugs — an evicted
    entry's request simply loses resumability, never correctness."""

    def __init__(self, capacity: Optional[int] = None,
                 max_tokens: Optional[int] = None):
        self.capacity = capacity if capacity is not None else \
            (env_int("DYN_REVIVE_RING", 2048) or 2048)
        self.max_tokens = max_tokens if max_tokens is not None else \
            (env_int("DYN_REVIVE_JOURNAL_TOKENS", 4096) or 4096)
        self._entries: "OrderedDict[str, JournalEntry]" = OrderedDict()
        self.opened_total = 0
        self.resumed_total = 0
        self.evicted_total = 0

    def open(self, request_id: str, prompt_tokens: int) -> JournalEntry:
        entry = JournalEntry(request_id, prompt_tokens, self.max_tokens)
        self._entries[request_id] = entry
        self.opened_total += 1
        while len(self._entries) > self.capacity:
            _, old = self._entries.popitem(last=False)
            old.resumable = False  # proto: revive.journal open->open
            self.evicted_total += 1
        return entry

    def close(self, request_id: str) -> None:
        # an idempotent pop is the close-exactly-once contract of the
        # revive.journal machine
        # proto: revive.journal open->closed
        self._entries.pop(request_id, None)

    def get(self, request_id: str) -> Optional[JournalEntry]:
        return self._entries.get(request_id)

    def __len__(self) -> int:
        return len(self._entries)

    def snapshot(self) -> dict:
        return {
            "inflight": len(self._entries),
            "capacity": self.capacity,
            "max_tokens": self.max_tokens,
            "opened_total": self.opened_total,
            "resumed_total": self.resumed_total,
            "evicted_total": self.evicted_total,
        }


_JOURNAL: Optional[ReviveJournal] = None


def journal() -> ReviveJournal:
    """The process journal (lazily constructed from the env knobs)."""
    global _JOURNAL
    if _JOURNAL is None:
        _JOURNAL = ReviveJournal()
    return _JOURNAL


def reset_journal() -> ReviveJournal:
    """Test hook: fresh journal (re-reads the env knobs)."""
    global _JOURNAL
    _JOURNAL = ReviveJournal()
    return _JOURNAL


# ----------------------------------------------------------------- failover

# upstream failure shapes a failover may recover from: worker crash /
# conn drop (RuntimeError via the stream-error plumbing, ConnectionError
# from a severed transport) and vanished instances. Typed budget/client
# errors (DeadlineExceeded, NoCapacity, ValueError) always propagate —
# resuming cannot help an expired budget or a bad request.
RESUMABLE_ERRORS: Tuple[type, ...] = (RuntimeError, ConnectionError)


def max_resumes() -> int:
    return env_int("DYN_REVIVE_MAX", 2) or 0


class ReviveSession:
    """Per-request failover state machine driven by the processor's
    remote-engine adapter.

    The session journals every emitted token (``observe``), decides
    whether a given upstream failure is worth a re-dispatch
    (``should_resume``), and builds the resume request
    (``resume_request``): ``prompt + emitted`` as the new prompt with the
    stop budget decremented by what was already emitted — the overlap
    dedupe that makes greedy resumes token-identical. ``echo_prompt`` is
    force-cleared on resume (the echo already streamed once).
    """

    def __init__(self, request: Any, context: Any, *,
                 limit: Optional[int] = None,
                 ring: Optional[ReviveJournal] = None):
        self.base = request
        self.context = context
        self.limit = limit if limit is not None else max_resumes()
        self.ring = ring if ring is not None else journal()
        self.entry = self.ring.open(context.id, len(request.token_ids))
        self.finished = False

    @property
    def emitted(self) -> List[int]:
        return self.entry.tokens

    @property
    def resumes(self) -> int:
        return self.entry.resumes

    def observe(self, out: Any) -> None:
        """Journal one upstream chunk (host-list append, off the token
        hot path)."""
        self.entry.record(list(out.token_ids or []))
        if out.finish_reason is not None:
            self.finished = True
            # eager ring close: downstream consumers abandon the stream
            # at the finish chunk, so waiting for the generator finalizer
            # would leak the entry until GC
            self.close()  # proto: revive.journal open->closed

    def close(self) -> None:
        self.ring.close(self.entry.request_id)

    def _budget_left(self) -> Optional[int]:
        mt = self.base.stop.max_tokens
        if mt is None:
            return None
        return mt - len(self.emitted)

    def budget_spent(self) -> bool:
        """The emitted tokens already cover the request's whole budget —
        the worker died between the last token and its finish chunk.
        Resume would dispatch a zero-token generation; synthesize the
        lost ``length`` finish instead."""
        left = self._budget_left()
        return left is not None and left <= 0

    def should_resume(self, exc: BaseException) -> bool:
        if self.finished or not isinstance(exc, RESUMABLE_ERRORS):
            return False
        if isinstance(exc, (guard.DeadlineExceeded, guard.NoCapacity)):
            return False
        if self.context.stopped:
            # client gone / budget spent: nothing to save (the guard of
            # the no-resume-after-kill invariant)
            # proto: request.lifecycle resumed->cancelled
            return False
        if not self.entry.resumable:
            return False
        return self.entry.resumes < self.limit

    def mark_resume(self) -> None:
        # proto: request.lifecycle prefill|decode->resumed
        self.entry.resumes += 1
        self.ring.resumed_total += 1
        guard.counter_inc("dyn_revive_resumes_total")
        # a failover resume means a worker just died mid-stream: capture
        # the evidence of why (cold path — resumes are rare)
        from . import blackbox
        blackbox.notify_trigger("failover_resume", {
            "request_id": self.entry.request_id,
            "resumes": self.entry.resumes,
        })

    def resume_request(self) -> Any:
        """The re-dispatch request: original prompt + journaled tokens,
        stop budget decremented, echo suppressed."""
        pre = self.base
        emitted = list(self.emitted)
        stop = dataclasses.replace(
            pre.stop,
            max_tokens=(None if pre.stop.max_tokens is None
                        else max(pre.stop.max_tokens - len(emitted), 1)),
            min_tokens=(None if not pre.stop.min_tokens
                        else max(pre.stop.min_tokens - len(emitted), 0)))
        output = dataclasses.replace(pre.output, echo_prompt=False)
        return dataclasses.replace(
            pre, token_ids=list(pre.token_ids) + emitted,
            stop=stop, output=output)

    def synthetic_finish(self) -> Any:
        """Finish chunk for the budget-spent edge (every budgeted token
        was emitted, only the finish chunk was lost with the worker)."""
        from ..llm.protocols.common import FINISH_LENGTH, EngineOutput

        return EngineOutput(
            token_ids=[], finish_reason=FINISH_LENGTH,
            prompt_tokens=self.entry.prompt_tokens,
            completion_tokens=len(self.emitted))


# ------------------------------------------------------------------- drain


def drain_timeout_s(timeout_ms: Optional[float] = None) -> float:
    ms = timeout_ms if timeout_ms is not None else \
        (env_float("DYN_DRAIN_TIMEOUT_MS", 10000.0) or 10000.0)
    return max(ms, 0.0) / 1000.0


async def drain_worker(handle, *, engine=None, publisher=None,
                       timeout_s: Optional[float] = None) -> bool:
    """The graceful-drain state machine for one served worker endpoint:

    1. ``begin_drain`` — delete the discovery record (routers stop
       picking this instance; a fresh direct dispatch gets a typed
       ``accepted=False`` nack) while the stats plane keeps answering
       with ``draining=1`` (draining ≠ dead: no breaker opens, no
       eviction);
    2. finish in-flight sequences, bounded by ``DYN_DRAIN_TIMEOUT_MS``
       (engine-level drain when the engine supports it);
    3. flush pending KV events so the router's index reflects the final
       cache state;
    4. full stop — withdraw subscriptions; the caller then releases the
       lease (``drt.shutdown()``).

    Returns True when everything in flight finished inside the budget
    (False = the timeout killed leftovers).
    """
    if timeout_s is None:
        timeout_s = drain_timeout_s()
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    await handle.begin_drain()
    drained = await handle.wait_idle(timeout_s)
    if engine is not None and hasattr(engine, "drain"):
        remaining = max(deadline - loop.time(), 0.0)
        # engine lifecycle drain, itself bounded by `remaining`
        drained = await engine.drain(remaining) and drained
    if publisher is not None and hasattr(publisher, "flush"):
        try:
            await publisher.flush()
        except Exception:  # noqa: BLE001 — flush is best-effort on the way out
            log.debug("KV event flush during drain failed", exc_info=True)
    await handle.stop()
    guard.counter_inc("dyn_revive_drains_total",
                      outcome="clean" if drained else "timeout")
    log.info("worker %s drained (%s)",
             getattr(getattr(handle, "instance", None), "subject", "?"),
             "clean" if drained else "timeout")
    return drained


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
