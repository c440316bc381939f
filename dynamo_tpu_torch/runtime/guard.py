"""Request deadlines, the retry policy and circuit breakers, trimmed
from ``dynamo_tpu/runtime/guard.py`` to what the port's component model,
response plane, router and disaggregation plane use.

- :class:`Deadline` — a monotonic budget that travels with the request:
  stamped into the DCP request envelope as ``deadline_ms`` (the budget
  left at send time, so each hop inherits what is left) and enforced
  wherever time is spent. :func:`bound` is the standard bounded await.
- :class:`RetryPolicy` — bounded attempts with decorrelated-jitter
  backoff that never sleeps or retries past the request's deadline.
- :class:`CircuitBreaker` / :class:`BreakerBoard` — per-endpoint
  closed -> open -> half-open breakers with a count-based and/or
  clock-based probe cadence.
- :func:`counter_inc` / :func:`counter_value` — the guard plane's
  process-wide counters, rendered with the breakers' state gauges by
  :func:`render_prom_lines` into the frontend's ``/metrics``.
- :func:`default_deadline` — the process-default request deadline
  (``DYN_REQUEST_DEADLINE_MS``) the HTTP frontend applies.
- :class:`ChaosInjector` — seeded fault injection on the real
  transports (TCP call-home, KV transfer plane) and the worker: drop,
  delay or sever frames and kill connections at named points, driven by
  the ``DYN_CHAOS`` scenario string, so the fault scenarios run against
  the whole stack on the CPU.

Deadline expiries feed the flight recorder's deadline-storm detector
and a breaker opening trips it (``runtime/blackbox.py``). The breaker's
transitions carry ``proto`` anchors of the ``breaker`` machine
(``runtime/proto.py``).

Chaos spec grammar::

    DYN_CHAOS = "seed=42;sever:kv.send@after=1;delay:tcp.send@ms=50,p=0.25"

    spec  := [seed=N ';'] rule (';' rule)*
    rule  := action ':' point ['@' param (',' param)*]
    action:= drop | delay | sever
    param := nth=N    fire on exactly the Nth hit of the point (1-based)
           | after=N  fire on every hit >= N
           | p=F      fire with probability F (seeded rng)
           | ms=F     delay duration (delay action)
           | times=N  stop after N fires

Injection points: ``tcp.connect``, ``tcp.send`` (call-home response
plane), ``kv.connect``, ``kv.send``, ``kv.recv`` (KV transfer plane),
and two worker-scoped points:

- ``worker.kill`` — consulted once per response frame a served endpoint
  streams. A ``sever``/``drop`` fire turns the serving handle into a
  wedged process: every stream on it dies with a raw connection drop (no
  error frame), the request and stats planes go silent, and the lease
  and discovery record stay behind, the crash shape that mid-stream
  failover and breaker eviction absorb. ``seed=1;sever:worker.kill@nth=4``
  kills the worker under the 4th streamed frame.
- ``engine.stall`` — consulted once per engine scheduler iteration, only
  when chaos is configured. A ``delay`` rule
  (``delay:engine.stall@ms=250,times=3``) stalls the decode loop.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
import weakref
from dataclasses import dataclass, field
from typing import (Any, AsyncIterator, Awaitable, Callable, Dict, List,
                    Optional, Tuple)

from . import proto
from .config import env_float, env_int, env_str

log = logging.getLogger("dynamo_tpu_torch.guard")


class DeadlineExceeded(asyncio.TimeoutError):
    """The request's end-to-end budget is spent. Subclasses TimeoutError
    so existing ``except asyncio.TimeoutError`` waits handle it."""


class NoCapacity(RuntimeError):
    """No instance can take the request right now (none discovered, or
    every breaker is open): the caller should back off and retry."""


# ------------------------------------------------------------------ deadline


class Deadline:
    """Absolute monotonic deadline with an injectable clock.

    The wire representation is the REMAINING budget in ms at encode time
    (:meth:`to_wire_ms`); the receiving hop rebuilds an absolute deadline
    against its own clock (:meth:`from_wire_ms`), so clocks never need to
    agree across hosts and each hop naturally inherits the decremented
    budget.
    """

    __slots__ = ("t_end", "clock")

    def __init__(self, t_end: float,
                 clock: Callable[[], float] = time.monotonic):
        self.t_end = t_end
        self.clock = clock

    @classmethod
    def after_ms(cls, ms: float,
                 clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return cls(clock() + ms / 1000.0, clock)

    @classmethod
    def after_s(cls, seconds: float,
                clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return cls(clock() + seconds, clock)

    @classmethod
    def from_wire_ms(cls, ms: Optional[float],
                     clock: Callable[[], float] = time.monotonic
                     ) -> Optional["Deadline"]:
        """Absent/None/<=0 on the wire = no deadline (legacy peer)."""
        if ms is None or ms <= 0:
            return None
        return cls.after_ms(ms, clock)

    @property
    def expired(self) -> bool:
        return self.clock() >= self.t_end

    def remaining_s(self) -> float:
        return max(0.0, self.t_end - self.clock())

    def remaining_ms(self) -> float:
        return self.remaining_s() * 1000.0

    def to_wire_ms(self) -> int:
        """Remaining budget for the next hop, floored at 1ms so a
        just-about-to-expire request still carries *a* deadline rather
        than silently becoming unbounded."""
        return max(1, int(self.remaining_ms()))

    def cap(self, timeout: Optional[float]) -> float:
        """Bound a per-hop timeout by the remaining budget."""
        rem = self.remaining_s()
        return rem if timeout is None else min(timeout, rem)

    def check(self, what: str = "request") -> None:
        if self.expired:
            counter_inc("dyn_guard_deadline_exceeded_total")
            from . import blackbox
            blackbox.note_deadline()
            raise DeadlineExceeded(f"deadline exceeded before {what}")

    def __repr__(self) -> str:
        return f"Deadline(remaining={self.remaining_s():.3f}s)"


def default_deadline(clock: Callable[[], float] = time.monotonic
                     ) -> Optional[Deadline]:
    """Process-default request deadline from DYN_REQUEST_DEADLINE_MS
    (0/unset = no implicit deadline)."""
    ms = env_float("DYN_REQUEST_DEADLINE_MS", 0.0) or 0.0
    return Deadline.after_ms(ms, clock) if ms > 0 else None


async def bound(awaitable: Awaitable, *, timeout: Optional[float] = None,
                deadline: Optional[Deadline] = None,
                what: str = "wait") -> Any:
    """The standard bounded await: ``min(timeout, deadline remaining)``.

    Raises :class:`DeadlineExceeded` when the deadline (not the plain
    timeout) is what ran out, so callers and the HTTP layer can
    distinguish budget exhaustion (504/"timeout") from a slow hop
    (retryable).
    """
    if deadline is not None:
        if deadline.expired:
            # never awaited: close the coroutine so it doesn't warn
            close = getattr(awaitable, "close", None)
            if close is not None:
                close()
            deadline.check(what)
        eff = deadline.cap(timeout)
    else:
        eff = timeout
    if eff is None:
        return await awaitable
    try:
        return await asyncio.wait_for(awaitable, eff)
    except asyncio.TimeoutError:
        if deadline is not None and deadline.expired:
            counter_inc("dyn_guard_deadline_exceeded_total")
            from . import blackbox
            blackbox.note_deadline()
            raise DeadlineExceeded(f"deadline exceeded during {what}") \
                from None
        raise


# --------------------------------------------------------------- retry policy


@dataclass
class RetryPolicy:
    """Bounded retries with decorrelated-jitter backoff, budget-aware.

    ``attempts(deadline)`` is an async generator yielding attempt indices
    (0-based); it sleeps the backoff BETWEEN attempts and stops early
    when the remaining deadline budget cannot cover the next backoff —
    a retry that must overrun the deadline is never issued.
    """

    max_attempts: int = 3
    base_s: float = 0.05
    cap_s: float = 2.0
    rng: random.Random = field(default_factory=random.Random)
    sleep: Callable[[float], Awaitable[None]] = asyncio.sleep

    @classmethod
    def from_env(cls, rng: Optional[random.Random] = None) -> "RetryPolicy":
        return cls(
            max_attempts=env_int("DYN_RETRY_MAX_ATTEMPTS", 3) or 1,
            base_s=(env_float("DYN_RETRY_BASE_MS", 50.0) or 50.0) / 1000.0,
            cap_s=(env_float("DYN_RETRY_CAP_MS", 2000.0) or 2000.0) / 1000.0,
            rng=rng if rng is not None else random.Random())

    def next_backoff(self, prev: Optional[float]) -> float:
        """Decorrelated jitter (AWS architecture-blog variant):
        ``min(cap, uniform(base, prev * 3))``."""
        hi = self.base_s if prev is None else prev * 3.0
        return min(self.cap_s, self.rng.uniform(self.base_s, max(hi, self.base_s)))

    async def attempts(self, deadline: Optional[Deadline] = None
                       ) -> AsyncIterator[int]:
        backoff: Optional[float] = None
        for i in range(max(1, self.max_attempts)):
            if deadline is not None and deadline.expired:
                if i == 0:
                    deadline.check("first attempt")
                return  # budget spent mid-retry: stop, caller raises last error
            yield i
            if i + 1 >= max(1, self.max_attempts):
                return
            backoff = self.next_backoff(backoff)
            if deadline is not None and deadline.remaining_s() <= backoff:
                return  # never retry past the deadline
            counter_inc("dyn_guard_retries_total")
            await self.sleep(backoff)

    async def run(self, fn: Callable[[], Awaitable[Any]], *,
                  deadline: Optional[Deadline] = None,
                  retry_on: Tuple[type, ...] = (Exception,),
                  what: str = "operation") -> Any:
        """Call ``fn`` under the policy; re-raises the last error when
        attempts (or budget) run out. CancelledError and
        DeadlineExceeded always propagate immediately."""
        last: Optional[BaseException] = None
        async for attempt in self.attempts(deadline):
            try:
                return await fn()
            except asyncio.CancelledError:
                raise
            except DeadlineExceeded:
                raise
            except retry_on as exc:
                last = exc
                log.debug("%s attempt %d failed: %r", what, attempt, exc)
        if last is None:
            raise DeadlineExceeded(f"no budget left for {what}")
        raise last


# ------------------------------------------------------------ circuit breaker

BREAKER_CLOSED = 0
BREAKER_OPEN = 1
BREAKER_HALF_OPEN = 2

_STATE_NAMES = {BREAKER_CLOSED: "closed", BREAKER_OPEN: "open",
                BREAKER_HALF_OPEN: "half_open"}


@dataclass(frozen=True)
class BreakerConfig:
    """``threshold`` consecutive failures open the breaker; an open
    breaker offers a single half-open probe every ``probe_every``-th
    denied call (deterministic, works on stepped/virtual time) and/or
    once ``reset_after_s`` has elapsed (0 = count-based only)."""

    threshold: int = 3
    probe_every: int = 5
    reset_after_s: float = 0.0

    @classmethod
    def from_env(cls) -> "BreakerConfig":
        return cls(threshold=env_int("DYN_BREAKER_THRESHOLD", 3) or 3,
                   probe_every=env_int("DYN_BREAKER_PROBE_EVERY", 5) or 5,
                   reset_after_s=env_float("DYN_BREAKER_RESET_S", 0.0) or 0.0)


class CircuitBreaker:
    """closed → open after N consecutive failures → half-open single
    probe → closed on success / open on failure. Clock injectable for
    deterministic tests."""

    __slots__ = ("cfg", "clock", "state", "failures", "opened_at",
                 "denied_since_open", "opened_total", "_probe_inflight")

    def __init__(self, cfg: Optional[BreakerConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg or BreakerConfig()
        self.clock = clock
        self.state = BREAKER_CLOSED
        self.failures = 0
        self.opened_at = 0.0
        self.denied_since_open = 0
        self.opened_total = 0
        self._probe_inflight = False

    def allow(self) -> bool:
        """May a call go through now? In OPEN, denials are counted and
        every ``probe_every``-th one (or clock expiry) converts to the
        single half-open probe permit."""
        if self.state == BREAKER_CLOSED:
            return True
        if self.state == BREAKER_HALF_OPEN:
            if not self._probe_inflight:
                self._probe_inflight = True  # proto: breaker half_open->half_open
                return True
            return False
        # OPEN
        self.denied_since_open += 1  # proto: breaker open->open
        due = (self.cfg.probe_every > 0
               and self.denied_since_open % self.cfg.probe_every == 0)
        if self.cfg.reset_after_s > 0 and \
                self.clock() - self.opened_at >= self.cfg.reset_after_s:
            due = True
        if due:
            proto.step("breaker", "open", "half_open")
            self.state = BREAKER_HALF_OPEN
            self._probe_inflight = True
            return True
        return False

    def release_probe(self) -> None:
        """A half-open permit was granted but the caller chose a
        different instance: hand the single probe slot back."""
        if self.state == BREAKER_HALF_OPEN:
            self._probe_inflight = False  # proto: breaker half_open->half_open

    def record_success(self) -> None:
        # proto: breaker closed|open|half_open->closed
        self.state = BREAKER_CLOSED
        self.failures = 0
        self.denied_since_open = 0
        self._probe_inflight = False

    def record_failure(self) -> None:
        if self.state == BREAKER_HALF_OPEN:
            self._open()  # failed probe: straight back to open
            return
        self.failures += 1
        if self.state == BREAKER_CLOSED and \
                self.failures >= self.cfg.threshold:
            self._open()

    def _open(self) -> None:
        self.state = BREAKER_OPEN  # proto: breaker closed|half_open->open
        self.opened_at = self.clock()
        self.opened_total += 1
        self.denied_since_open = 0
        self._probe_inflight = False
        # a breaker opening is an incident; cold path by definition
        from . import blackbox
        blackbox.notify_trigger("breaker_open", {
            "failures": self.failures,
            "opened_total": self.opened_total,
        })

    def reset(self) -> None:
        """External evidence of recovery (fresh discovery put): close."""
        self.record_success()

    @property
    def state_name(self) -> str:
        return _STATE_NAMES[self.state]


# every live board, for the dyn_client_breaker_state exposition
_BOARDS: "weakref.WeakSet[BreakerBoard]" = weakref.WeakSet()


class BreakerBoard:
    """Keyed breaker collection for one client (key = (plane, id))."""

    def __init__(self, name: str, cfg: Optional[BreakerConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.cfg = cfg or BreakerConfig.from_env()
        self.clock = clock
        # shared by every task routing/scraping through one client; all
        # board methods are sync (atomic under the event loop)
        self.breakers: Dict[Tuple[str, Any], CircuitBreaker] = {}
        _BOARDS.add(self)

    def get(self, plane: str, key: Any) -> CircuitBreaker:
        br = self.breakers.get((plane, key))
        if br is None:
            br = CircuitBreaker(self.cfg, self.clock)
            self.breakers[(plane, key)] = br
        return br

    def drop(self, plane: str, key: Any) -> None:
        self.breakers.pop((plane, key), None)

    def reset(self, plane: str, key: Any) -> None:
        br = self.breakers.get((plane, key))
        if br is not None:
            br.reset()

    def not_closed(self, plane: str) -> List[Any]:
        """Keys of ``plane`` whose breaker is open or half-open."""
        return sorted(
            (k for (p, k), br in self.breakers.items()
             if p == plane and br.state != BREAKER_CLOSED),
            key=repr)

    def opened_total(self, plane: Optional[str] = None) -> int:
        return sum(br.opened_total for (p, _k), br in self.breakers.items()
                   if plane is None or p == plane)

    def states(self) -> Dict[Tuple[str, Any], int]:
        return {k: br.state for k, br in self.breakers.items()}


# ------------------------------------------------------------------- counters
# Process-wide counters of the guard plane (route fallbacks, deadline
# exhaustions, retries).

_COUNTERS: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}


def counter_inc(name: str, value: float = 1.0, **labels: str) -> None:
    key = (name, tuple(sorted(labels.items())))
    _COUNTERS[key] = _COUNTERS.get(key, 0.0) + value


def counter_value(name: str, **labels: str) -> float:
    return _COUNTERS.get((name, tuple(sorted(labels.items()))), 0.0)


def reset_counters() -> None:
    """Test hook."""
    _COUNTERS.clear()


def counters_snapshot() -> Dict[str, float]:
    """Guard-plane counters as one flat JSON-safe dict (dynablack incident
    bundles). Label sets fold into the key: ``name{k="v"}``."""
    out: Dict[str, float] = {}
    for (name, labels), val in sorted(_COUNTERS.items()):
        if labels:
            lbl = ",".join(f'{k}="{v}"' for k, v in labels)
            out[f"{name}{{{lbl}}}"] = val
        else:
            out[name] = val
    return out


def boards_snapshot() -> Dict[str, Dict[str, Any]]:
    """Per-board breaker state for dynablack incident bundles: state name,
    consecutive failures and lifetime opens per (plane, instance)."""
    out: Dict[str, Dict[str, Any]] = {}
    for board in sorted(_BOARDS, key=lambda b: b.name):
        rows: Dict[str, Any] = {}
        for (plane, key), br in sorted(board.breakers.items(),
                                       key=lambda kv: repr(kv[0])):
            ident = f"{key:x}" if isinstance(key, int) else str(key)
            rows[f"{plane}/{ident}"] = {
                "state": br.state_name,
                "failures": br.failures,
                "opened_total": br.opened_total,
            }
        out[board.name] = rows
    return out


def render_prom_lines() -> List[str]:
    """Guard-plane exposition: the named counters plus one
    ``dyn_client_breaker_state`` gauge per (board, plane, instance)."""
    lines: List[str] = []
    by_name: Dict[str, List[str]] = {}
    for (name, labels), val in sorted(_COUNTERS.items()):
        lbl = ",".join(f'{k}="{v}"' for k, v in labels)
        v = int(val) if float(val).is_integer() else val
        by_name.setdefault(name, []).append(
            f"{name}{{{lbl}}} {v}" if lbl else f"{name} {v}")
    for name in sorted(by_name):
        lines.append(f"# HELP {name} dynaguard counter")
        lines.append(f"# TYPE {name} counter")
        lines.extend(by_name[name])
    rows = []
    for board in sorted(_BOARDS, key=lambda b: b.name):
        for (plane, key), state in sorted(board.states().items(),
                                          key=lambda kv: repr(kv[0])):
            ident = f"{key:x}" if isinstance(key, int) else str(key)
            rows.append(
                f'dyn_client_breaker_state{{board="{board.name}",'
                f'plane="{plane}",instance="{ident}"}} {state}')
    if rows:
        lines.append("# HELP dyn_client_breaker_state per-endpoint circuit "
                     "breaker state (0=closed, 1=open, 2=half_open)")
        lines.append("# TYPE dyn_client_breaker_state gauge")
        lines.extend(rows)
    return lines


# ------------------------------------------------------------------- chaos


class ChaosError(ConnectionError):
    """Raised by a ``drop`` rule: the transport pretends the peer died."""


@dataclass
class ChaosRule:
    action: str                      # drop | delay | sever
    point: str                       # e.g. kv.send
    nth: Optional[int] = None        # fire on exactly the Nth hit
    after: Optional[int] = None      # fire on every hit >= N
    p: Optional[float] = None        # fire probability (seeded rng)
    ms: float = 0.0                  # delay duration
    times: Optional[int] = None      # max fires
    hits: int = 0
    fired: int = 0

    def should_fire(self, rng: random.Random) -> bool:
        self.hits += 1
        if self.times is not None and self.fired >= self.times:
            return False
        if self.nth is not None and self.hits != self.nth:
            return False
        if self.after is not None and self.hits < self.after:
            return False
        if self.p is not None and rng.random() >= self.p:
            return False
        self.fired += 1
        return True


_ACTIONS = ("drop", "delay", "sever")


def parse_chaos(spec: str) -> Tuple[int, List[ChaosRule]]:
    """Parse a ``DYN_CHAOS`` scenario string (grammar in the module
    docstring); raises ValueError on malformed specs so a typo fails the
    process loudly instead of silently running without chaos."""
    seed = 0
    rules: List[ChaosRule] = []
    for part in (p.strip() for p in spec.split(";") if p.strip()):
        if part.startswith("seed="):
            seed = int(part[len("seed="):])
            continue
        head, _, params = part.partition("@")
        action, _, point = head.partition(":")
        if action not in _ACTIONS or not point:
            raise ValueError(
                f"bad chaos rule {part!r}: want action:point[@params] "
                f"with action in {_ACTIONS}")
        rule = ChaosRule(action=action, point=point)
        for kv in (p.strip() for p in params.split(",") if p.strip()):
            k, _, v = kv.partition("=")
            if k == "nth":
                rule.nth = int(v)
            elif k == "after":
                rule.after = int(v)
            elif k == "p":
                rule.p = float(v)
            elif k == "ms":
                rule.ms = float(v)
            elif k == "times":
                rule.times = int(v)
            else:
                raise ValueError(f"bad chaos param {kv!r} in {part!r}")
        rules.append(rule)
    return seed, rules


class ChaosInjector:
    """Seeded fault injector the transport layers consult at their
    named points (see :func:`chaos_point`)."""

    def __init__(self, spec: str):
        self.spec = spec
        seed, self.rules = parse_chaos(spec)
        self.rng = random.Random(seed)
        self.injected: Dict[Tuple[str, str], int] = {}

    async def point(self, name: str, writer=None) -> None:
        for rule in self.rules:
            if rule.point != name:
                continue
            if not rule.should_fire(self.rng):
                continue
            self.injected[(name, rule.action)] = \
                self.injected.get((name, rule.action), 0) + 1
            counter_inc("dyn_guard_chaos_injections_total",
                        point=name, action=rule.action)
            log.warning("chaos: %s at %s (hit %d)", rule.action, name,
                        rule.hits)
            if rule.action == "delay":
                await asyncio.sleep(rule.ms / 1000.0)
            elif rule.action == "drop":
                raise ChaosError(f"chaos: dropped at {name}")
            elif rule.action == "sever":
                if writer is not None:
                    try:
                        writer.close()
                    except Exception:  # noqa: BLE001 — already dead is fine
                        log.debug("chaos sever: close failed", exc_info=True)
                raise ConnectionResetError(f"chaos: severed at {name}")


# module-level injector, parsed lazily from DYN_CHAOS; tests swap it via
# set_chaos(). ``False`` = not yet resolved (None is a valid resolution).
_CHAOS: Any = False


def chaos() -> Optional[ChaosInjector]:
    global _CHAOS
    if _CHAOS is False:
        spec = env_str("DYN_CHAOS")
        _CHAOS = ChaosInjector(spec) if spec else None
    return _CHAOS


def set_chaos(spec: Optional[str]) -> Optional[ChaosInjector]:
    """Install (or clear, with None) the process chaos injector — the
    test hook; production resolves DYN_CHAOS on first use."""
    global _CHAOS
    _CHAOS = ChaosInjector(spec) if spec else None
    return _CHAOS


async def chaos_point(name: str, writer=None) -> None:
    """Transport-layer hook: no-op unless a chaos rule targets ``name``.
    ``writer`` (if given) is the connection a ``sever`` rule kills."""
    c = chaos()
    if c is not None:
        await c.point(name, writer)
