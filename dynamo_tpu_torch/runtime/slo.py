"""dynaslo — fleet-wide SLO engine: mergeable latency histograms,
multi-window burn-rate alerts, goodput accounting and pressure signals.

A copy of ``dynamo_tpu/runtime/slo.py`` (pure Python): the same bucket
grid, wire forms, objective grammar and Prometheus names, so histograms
of both engines merge and a dashboard built for one reads the other.

The serving stack exports raw latency signals everywhere (frontend TTFT/
ITL, engine queue wait, per-stage spans) but until dynaslo nothing could
*aggregate* them across workers or judge them against an objective. This
module provides the four layers, all dependency-free and clock-injectable
so the fleet simulator evaluates them on its virtual clock byte-for-byte:

1. :class:`Histogram` — a fixed-bucket, **mergeable** latency histogram.
   Merging is lossless (bucket counts add) because every histogram of a
   metric shares the same bucket bounds, so N workers' histograms fold
   into one fleet-wide distribution; quantiles are nearest-bucket with
   error bounded by one bucket width. Rendering follows Prometheus
   cumulative-bucket semantics.

2. :class:`SloObjective` / :class:`SloRegistry` — declared objectives
   ("fraction of observations with metric <= threshold must be >= target
   over a window"), parsed from the ``DYN_SLO_OBJECTIVES`` grammar or a
   file (``DYN_SLO_FILE``).

3. :class:`SloEngine` — continuous evaluation over any cumulative
   histogram source: windowed attainment, error budget, and SRE-style
   **multi-window burn-rate alerts** (fast + slow windows must both burn
   above ``burn_threshold``), plus the ``ttft_pressure``/``itl_pressure``
   signals the planner's P/D rebalance policy consumes.

4. :class:`GoodputTracker` — per-request met-all-objectives accounting
   (DistServe's serving metric: requests that met their latency
   objectives, not raw tok/s).

``nearest_rank`` is the one shared exact-percentile implementation.
"""

from __future__ import annotations

import math
import time
from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

# ----------------------------------------------------------------- buckets

# Shared bucket bounds (seconds) for every latency metric: log-spaced from
# token cadence (1 ms) through request scale (minutes). One shared grid is
# what makes cross-worker merging lossless — never change bounds without a
# wire-compat plan (merge refuses mismatched grids instead of guessing).
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0)

# The request-latency metric names dynaslo understands, and what they
# measure. Objectives may only name these (the sync-gate test additionally
# pins each one to a rendered /metrics family).
METRICS: Tuple[str, ...] = ("ttft", "itl", "queue_wait", "e2e")

# Worker roles a latency histogram can be labeled with (dynashard/disagg):
ROLES: Tuple[str, ...] = ("prefill", "decode", "unified")


def nearest_rank(values: List[float], q: float) -> Optional[float]:
    """Deterministic nearest-rank percentile (``q`` in [0, 100]).

    The single exact-percentile implementation of the package."""
    if not values:
        return None
    vs = sorted(values)
    rank = max(int(math.ceil(q / 100.0 * len(vs))), 1)
    return vs[rank - 1]


class Histogram:
    """Fixed-bucket mergeable histogram (Prometheus cumulative semantics).

    ``counts`` holds per-bucket (NON-cumulative) counts plus a trailing
    +Inf bucket; cumulative sums are derived at render time. Two
    histograms with the same bounds merge losslessly by adding counts."""

    __slots__ = ("ubs", "counts", "sum", "count")

    def __init__(self, ubs: Iterable[float] = LATENCY_BUCKETS):
        self.ubs: Tuple[float, ...] = tuple(ubs)
        self.counts: List[int] = [0] * (len(self.ubs) + 1)
        self.sum: float = 0.0
        self.count: int = 0

    def observe(self, value: float, n: int = 1) -> None:
        """Record ``n`` observations of ``value`` seconds."""
        if n <= 0:
            return
        i = bisect_left(self.ubs, value)
        self.counts[i] += n          # i == len(ubs) → +Inf bucket
        self.sum += value * n
        self.count += n

    def merge(self, other: "Histogram") -> None:
        """Lossless in-place merge; bucket grids must match exactly."""
        if other.ubs != self.ubs:
            raise ValueError(
                f"cannot merge histograms with different bucket grids "
                f"({len(self.ubs)} vs {len(other.ubs)} bounds)")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count

    def copy(self) -> "Histogram":
        h = Histogram(self.ubs)
        h.counts = list(self.counts)
        h.sum = self.sum
        h.count = self.count
        return h

    def diff(self, earlier: "Histogram") -> "Histogram":
        """Window view between two snapshots of one cumulative histogram
        (``self`` must be the later snapshot of the same series)."""
        if earlier.ubs != self.ubs:
            raise ValueError("diff across different bucket grids")
        h = Histogram(self.ubs)
        h.counts = [max(a - b, 0)
                    for a, b in zip(self.counts, earlier.counts)]
        h.sum = max(self.sum - earlier.sum, 0.0)
        h.count = max(self.count - earlier.count, 0)
        return h

    def cumulative(self) -> List[int]:
        """Cumulative counts per bound (excluding +Inf; total = count)."""
        out, run = [], 0
        for c in self.counts[:-1]:
            run += c
            out.append(run)
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-bucket quantile (``q`` in [0, 1]): the upper bound of
        the bucket holding the exact nearest-rank observation — error is
        bounded by one bucket width. Observations past the last bound
        report the last bound (the histogram cannot see further)."""
        if self.count <= 0:
            return None
        rank = max(int(math.ceil(q * self.count)), 1)
        run = 0
        for i, c in enumerate(self.counts[:-1]):
            run += c
            if run >= rank:
                return self.ubs[i]
        return self.ubs[-1]

    def fraction_le(self, threshold: float) -> Optional[float]:
        """Fraction of observations <= ``threshold`` (attainment). The
        threshold is resolved to the largest bucket bound <= threshold,
        so snap objective thresholds onto the grid (see
        :func:`snap_threshold`) for exact evaluation."""
        if self.count <= 0:
            return None
        idx = bisect_left(self.ubs, threshold * (1.0 + 1e-9))
        good = sum(self.counts[:idx])
        return good / self.count

    # ------------------------------------------------------------- wire

    def to_wire(self) -> dict:
        """Compact stats-plane form. Bounds ride along so a peer with a
        different grid fails loudly at merge instead of silently skewing
        fleet quantiles."""
        return {"ubs": list(self.ubs), "counts": list(self.counts),
                "sum": round(self.sum, 6), "count": self.count}

    @classmethod
    def from_wire(cls, d: dict) -> "Histogram":
        h = cls(tuple(d.get("ubs") or LATENCY_BUCKETS))
        counts = list(d.get("counts") or [])
        if len(counts) == len(h.counts):
            h.counts = [int(c) for c in counts]
        h.sum = float(d.get("sum", 0.0))
        h.count = int(d.get("count", 0))
        return h

    # ----------------------------------------------------------- render

    def render_prom(self, name: str, labels: str) -> List[str]:
        """Prometheus text lines (cumulative ``_bucket`` + ``_sum`` +
        ``_count``). ``labels`` is the pre-rendered label body without
        braces (may be empty)."""
        sep = "," if labels else ""
        lines = []
        run = 0
        for i, ub in enumerate(self.ubs):
            run += self.counts[i]
            lines.append(f'{name}_bucket{{{labels}{sep}le="{ub}"}} {run}')
        lines.append(f'{name}_bucket{{{labels}{sep}le="+Inf"}} {self.count}')
        lines.append(f'{name}_sum{{{labels}}} {round(self.sum, 6)}')
        lines.append(f'{name}_count{{{labels}}} {self.count}')
        return lines


def snap_threshold(threshold: float,
                   ubs: Tuple[float, ...] = LATENCY_BUCKETS) -> float:
    """Snap an objective threshold onto the nearest bucket bound (log
    distance) so attainment evaluation is exact rather than bounded."""
    if threshold <= 0:
        return ubs[0]
    best = min(ubs, key=lambda ub: abs(math.log(ub) - math.log(threshold)))
    return best


# ------------------------------------------------------- latency recording


class LatencyRecorder:
    """Per-role latency histograms for one worker (engine-side).

    ``observe`` is host-side counter arithmetic only (no device work, no
    syncs) so it is safe on the engine's hot path. The wire form is
    ``{role: {metric: histogram}}`` so a worker that changes role
    mid-lifetime (fleet P/D rebalance) keeps earlier observations
    attributed to the role that produced them."""

    def __init__(self, role: str = "unified"):
        self.role = role
        self.hists: Dict[str, Dict[str, Histogram]] = {}

    def observe(self, metric: str, value: float, n: int = 1) -> None:
        # bounded-by: keyed by role then metric, both fixed vocabularies
        per_role = self.hists.setdefault(self.role, {})
        h = per_role.get(metric)
        if h is None:
            h = per_role[metric] = Histogram()
        h.observe(value, n)

    def to_wire(self) -> dict:
        return {role: {m: h.to_wire() for m, h in sorted(per.items())}
                for role, per in sorted(self.hists.items())}

    @classmethod
    def wire_to_hists(cls, wire: dict) -> Dict[str, Dict[str, Histogram]]:
        out: Dict[str, Dict[str, Histogram]] = {}
        for role, per in (wire or {}).items():
            out[role] = {m: Histogram.from_wire(d) for m, d in per.items()}
        return out


def merge_latency_wire(wires: Iterable[dict]
                       ) -> Dict[str, Dict[str, Histogram]]:
    """Fold many workers' ``latency_hist`` wire dicts into one
    ``{role: {metric: merged histogram}}`` view (the aggregator's
    fleet-wide latency plane)."""
    merged: Dict[str, Dict[str, Histogram]] = {}
    for wire in wires:
        for role, per in (wire or {}).items():
            dst = merged.setdefault(role, {})
            for metric, d in per.items():
                h = Histogram.from_wire(d)
                if metric in dst:
                    dst[metric].merge(h)
                else:
                    dst[metric] = h
    return merged


def collapse_roles(merged: Dict[str, Dict[str, Histogram]]
                   ) -> Dict[str, Histogram]:
    """Merge a role-labeled latency view down to ``{metric: histogram}``
    (the SLO engine evaluates objectives fleet-wide across roles)."""
    out: Dict[str, Histogram] = {}
    for per in merged.values():
        for metric, h in per.items():
            if metric in out:
                out[metric].merge(h)
            else:
                out[metric] = h.copy()
    return out


# ----------------------------------------------------------- SLO registry


@dataclass(frozen=True)
class SloObjective:
    """One objective: P(metric <= threshold_s) >= target over window_s."""

    name: str
    metric: str            # one of METRICS
    threshold_s: float     # snapped onto the histogram bucket grid
    target: float          # required attainment fraction in (0, 1)
    window_s: float        # error-budget (slow) window, seconds

    def to_dict(self) -> dict:
        return {"name": self.name, "metric": self.metric,
                "threshold_s": self.threshold_s, "target": self.target,
                "window_s": self.window_s}


def parse_objective(spec: str) -> SloObjective:
    """Parse one objective from the grammar

        [name=]metric<=threshold_s@target/window_s

    e.g. ``ttft<=0.5@0.95/300`` ("95% of TTFTs under 500 ms over 5 min")
    or ``tail=itl<=0.1@0.99/600``. The threshold is snapped onto the
    histogram bucket grid so windowed attainment is exact."""
    body = spec.strip()
    if not body:
        raise ValueError("empty SLO objective")
    name = None
    if "=" in body.split("<=", 1)[0]:
        name, body = body.split("=", 1)
        name = name.strip()
    try:
        metric, rest = body.split("<=", 1)
        thr, rest = rest.split("@", 1)
        target, window = rest.split("/", 1)
        metric = metric.strip()
        obj = SloObjective(
            name=name or metric, metric=metric,
            threshold_s=snap_threshold(float(thr)),
            target=float(target), window_s=float(window))
    except ValueError as e:
        raise ValueError(
            f"bad SLO objective {spec!r} (grammar: "
            f"[name=]metric<=threshold_s@target/window_s): {e}") from e
    if obj.metric not in METRICS:
        raise ValueError(f"SLO objective {spec!r}: unknown metric "
                         f"{obj.metric!r} (known: {METRICS})")
    if not 0.0 < obj.target < 1.0:
        raise ValueError(f"SLO objective {spec!r}: target must be in "
                         f"(0, 1), got {obj.target}")
    if obj.window_s <= 0:
        raise ValueError(f"SLO objective {spec!r}: window must be > 0")
    return obj


@dataclass
class SloRegistry:
    """The declared objectives plus the burn-rate alert policy."""

    objectives: List[SloObjective] = field(default_factory=list)
    # fast window = fast_fraction * objective window (SRE multi-window
    # pattern: the fast window catches the spike, the slow window proves
    # it is sustained — both must burn above threshold to alert)
    fast_fraction: float = 0.1
    burn_threshold: float = 2.0

    @classmethod
    def parse(cls, spec: str, *, fast_fraction: Optional[float] = None,
              burn_threshold: Optional[float] = None) -> "SloRegistry":
        objectives = [parse_objective(p)
                      for p in spec.split(";") if p.strip()]
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO objective names in {spec!r}")
        reg = cls(objectives=objectives)
        if fast_fraction is not None:
            reg.fast_fraction = fast_fraction
        if burn_threshold is not None:
            reg.burn_threshold = burn_threshold
        return reg

    @classmethod
    def from_env(cls) -> "SloRegistry":
        """Build from DYN_SLO_OBJECTIVES (inline grammar) or DYN_SLO_FILE
        (one objective per line, '#' comments). Absent → empty registry
        (no objectives, histograms still recorded/rendered)."""
        from .config import env_float, env_str

        spec = env_str("DYN_SLO_OBJECTIVES") or ""
        path = env_str("DYN_SLO_FILE")
        if not spec and path:
            # one-shot tiny config read at component construction (the
            # registry is parsed once per Metrics/aggregator instance),
            # not on any serving path — same class as the tracer's
            # JSONL sink
            with open(path) as f:
                lines = [ln.split("#", 1)[0].strip() for ln in f]
            spec = ";".join(ln for ln in lines if ln)
        return cls.parse(
            spec,
            fast_fraction=env_float("DYN_SLO_FAST_FRACTION"),
            burn_threshold=env_float("DYN_SLO_BURN_THRESHOLD"))

    def for_metric(self, metric: str) -> List[SloObjective]:
        return [o for o in self.objectives if o.metric == metric]

    def to_dict(self) -> dict:
        return {"objectives": [o.to_dict() for o in self.objectives],
                "fast_fraction": self.fast_fraction,
                "burn_threshold": self.burn_threshold}


# -------------------------------------------------------------- SLO engine


class SloEngine:
    """Continuous SLO evaluation over a cumulative-histogram source.

    ``source()`` returns the CURRENT cumulative ``{metric: Histogram}``
    view (fleet-merged at the aggregator, process-local at the frontend).
    ``tick()`` snapshots it; windowed attainment/burn rates are computed
    by diffing the newest snapshot against the one nearest the window
    edge. The clock is injectable: wall time in serving, virtual time in
    the fleet simulator (where seeded runs must stay byte-identical)."""

    def __init__(self, registry: SloRegistry,
                 source: Callable[[], Dict[str, Histogram]],
                 clock: Callable[[], float] = time.monotonic,
                 max_snapshots: int = 512):
        self.registry = registry
        self.source = source
        self.clock = clock
        self.max_snapshots = max_snapshots
        # (t, {metric: Histogram}) snapshots, oldest first
        self._snaps: List[Tuple[float, Dict[str, Histogram]]] = []
        self._alerting: Dict[str, bool] = {}
        self.alert_events: List[dict] = []     # fired/cleared transitions

    # ------------------------------------------------------------ intake

    def tick(self) -> List[dict]:
        """Snapshot the source and re-evaluate every objective. Returns
        the alert transitions (fired/cleared) caused by this tick."""
        now = self.clock()
        snap = {m: h.copy() for m, h in self.source().items()}
        if self._snaps and self._snaps[-1][0] >= now:
            self._snaps[-1] = (now, snap)    # same instant: replace
        else:
            self._snaps.append((now, snap))
        if len(self._snaps) > self.max_snapshots:
            del self._snaps[:len(self._snaps) - self.max_snapshots]
        events = []
        for obj in self.registry.objectives:
            ev = self._evaluate_objective(obj, now)
            was = self._alerting.get(obj.name, False)
            if ev["alert"] != was:
                self._alerting[obj.name] = ev["alert"]
                events.append({"at": round(now, 6), "objective": obj.name,
                               "state": "fired" if ev["alert"]
                               else "cleared",
                               "burn_fast": ev["burn_fast"],
                               "burn_slow": ev["burn_slow"]})
        self.alert_events.extend(events)
        for ev in events:
            if ev["state"] == "fired":
                # burn-rate trip: the canonical dynablack trigger (cold
                # path — at most one transition per objective per tick)
                from . import blackbox
                blackbox.notify_trigger("slo_burn_rate", ev)
        return events

    # -------------------------------------------------------- evaluation

    def _window_hist(self, metric: str, window_s: float,
                     now: float) -> Optional[Histogram]:
        """Observations inside ``[now - window_s, now]``: newest snapshot
        minus the snapshot nearest the window edge (older-or-equal when
        one exists, else the oldest available)."""
        if not self._snaps:
            return None
        latest = self._snaps[-1][1].get(metric)
        if latest is None:
            return None
        cutoff = now - window_s
        base = None
        for t, snap in self._snaps:
            if t <= cutoff:
                base = snap.get(metric)
            else:
                break
        if base is None:
            # window predates history: everything ever seen is "inside"
            base = Histogram(latest.ubs)
        return latest.diff(base)

    def _evaluate_objective(self, obj: SloObjective, now: float) -> dict:
        reg = self.registry
        fast_w = max(obj.window_s * reg.fast_fraction, 1e-9)
        slow = self._window_hist(obj.metric, obj.window_s, now)
        fast = self._window_hist(obj.metric, fast_w, now)
        budget = max(1.0 - obj.target, 1e-9)

        def burn(h: Optional[Histogram]) -> Tuple[Optional[float], float]:
            if h is None or h.count == 0:
                return None, 0.0
            att = h.fraction_le(obj.threshold_s)
            return att, (1.0 - att) / budget

        att_slow, burn_slow = burn(slow)
        att_fast, burn_fast = burn(fast)
        alert = (burn_fast >= reg.burn_threshold
                 and burn_slow >= reg.burn_threshold)
        return {
            "objective": obj.name,
            "metric": obj.metric,
            "threshold_s": obj.threshold_s,
            "target": obj.target,
            "attainment": None if att_slow is None else round(att_slow, 6),
            "attainment_fast": (None if att_fast is None
                                else round(att_fast, 6)),
            "window_count": 0 if slow is None else slow.count,
            "burn_slow": round(burn_slow, 6),
            "burn_fast": round(burn_fast, 6),
            "error_budget_remaining": round(1.0 - burn_slow, 6),
            "alert": alert,
        }

    def evaluate(self) -> Dict[str, dict]:
        """Current evaluation of every objective (keyed by name). Uses
        the snapshots laid down by ``tick()``; call ``tick()`` first when
        driving manually."""
        now = self._snaps[-1][0] if self._snaps else self.clock()
        return {o.name: self._evaluate_objective(o, now)
                for o in self.registry.objectives}

    def pressures(self) -> Dict[str, float]:
        """Planner-facing pressure signals: per metric, the max over its
        objectives of ``min(burn_fast, burn_slow)`` — the continuous
        form of the multi-window alert conjunction, so pressure crosses
        a threshold exactly when the same-threshold alert would fire
        (a fast spike alone, or a stale slow window alone, never
        actuates the planner). The P/D rebalance policy compares
        ``ttft_pressure`` (prefill capacity short) against
        ``itl_pressure`` (decode capacity short)."""
        ev = self.evaluate()
        out = {}
        for metric in METRICS:
            vals = [min(e["burn_fast"], e["burn_slow"])
                    for e in ev.values() if e["metric"] == metric]
            out[f"{metric}_pressure"] = round(max(vals), 6) if vals else 0.0
        return out

    def window_quantiles(self, metric: str, window_s: float,
                         qs: Tuple[float, ...] = (0.5, 0.95, 0.99)
                         ) -> Dict[str, Optional[float]]:
        now = self._snaps[-1][0] if self._snaps else self.clock()
        h = self._window_hist(metric, window_s, now)
        if h is None:
            return {f"p{int(q * 100)}": None for q in qs}
        return {f"p{int(q * 100)}": h.quantile(q) for q in qs}

    def snapshot(self) -> dict:
        """The ``/debug/slo`` payload."""
        return {
            "registry": self.registry.to_dict(),
            "evaluation": self.evaluate(),
            "pressures": self.pressures(),
            "alerts": list(self.alert_events),
        }

    # ------------------------------------------------------------ render

    def render_prom_lines(self, labels: str = "") -> List[str]:
        """Objective gauges for a /metrics plane: attainment, error
        budget, fast/slow burn rates, alert state, pressure signals."""
        if not self.registry.objectives:
            return []
        sep = "," if labels else ""
        lines = [
            "# HELP dyn_slo_attainment windowed fraction of observations "
            "meeting the objective threshold",
            "# TYPE dyn_slo_attainment gauge",
        ]
        ev = self.evaluate()
        for name, e in sorted(ev.items()):
            if e["attainment"] is not None:
                lines.append(f'dyn_slo_attainment{{{labels}{sep}'
                             f'objective="{name}"}} {e["attainment"]}')
        lines.append("# HELP dyn_slo_error_budget_remaining remaining "
                     "error-budget fraction over the objective window "
                     "(1 - slow burn; negative = budget overspent)")
        lines.append("# TYPE dyn_slo_error_budget_remaining gauge")
        for name, e in sorted(ev.items()):
            lines.append(f'dyn_slo_error_budget_remaining{{{labels}{sep}'
                         f'objective="{name}"}} '
                         f'{e["error_budget_remaining"]}')
        lines.append("# HELP dyn_slo_burn_rate error-budget burn rate "
                     "(1.0 = spending exactly the budget)")
        lines.append("# TYPE dyn_slo_burn_rate gauge")
        for name, e in sorted(ev.items()):
            lines.append(f'dyn_slo_burn_rate{{{labels}{sep}'
                         f'objective="{name}",window="fast"}} '
                         f'{e["burn_fast"]}')
            lines.append(f'dyn_slo_burn_rate{{{labels}{sep}'
                         f'objective="{name}",window="slow"}} '
                         f'{e["burn_slow"]}')
        lines.append("# HELP dyn_slo_alert_active multi-window burn-rate "
                     "alert state (1 = both windows burning above "
                     "threshold)")
        lines.append("# TYPE dyn_slo_alert_active gauge")
        for name, e in sorted(ev.items()):
            lines.append(f'dyn_slo_alert_active{{{labels}{sep}'
                         f'objective="{name}"}} {int(e["alert"])}')
        lines.append("# HELP dyn_slo_pressure planner-facing pressure "
                     "signals (max fast burn per metric)")
        lines.append("# TYPE dyn_slo_pressure gauge")
        for sig, val in sorted(self.pressures().items()):
            lines.append(f'dyn_slo_pressure{{{labels}{sep}'
                         f'signal="{sig}"}} {val}')
        return lines


# ----------------------------------------------------------------- goodput


class GoodputTracker:
    """Per-request met-all-objectives accounting.

    A request is *good* when every registered objective whose metric the
    request reported is met (objectives on metrics a request cannot
    report — e.g. TTFT for unary — are skipped for that request)."""

    def __init__(self, registry: SloRegistry):
        self.registry = registry
        self.good = 0
        self.total = 0
        self.misses: Dict[str, int] = {
            o.name: 0 for o in registry.objectives}

    def observe_request(self, metrics: Dict[str, float]) -> bool:
        """``metrics`` maps metric name → the request's scalar (seconds);
        for ITL pass the request's mean gap. Returns the verdict."""
        good = True
        for obj in self.registry.objectives:
            val = metrics.get(obj.metric)
            if val is None:
                continue
            if val > obj.threshold_s:
                self.misses[obj.name] = self.misses.get(obj.name, 0) + 1
                good = False
        self.total += 1
        if good:
            self.good += 1
        return good

    def observe_failed(self) -> None:
        """Count a request that never produced latency metrics (failed /
        shed before serving) — it consumed goodput without being good."""
        self.total += 1

    @property
    def rate(self) -> Optional[float]:
        return self.good / self.total if self.total else None

    def snapshot(self) -> dict:
        return {"good": self.good, "total": self.total,
                "rate": None if self.rate is None else round(self.rate, 6),
                "misses_by_objective": dict(sorted(self.misses.items()))}

    def render_prom_lines(self, labels: str = "") -> List[str]:
        if not self.registry.objectives:
            return []
        sep = "," if labels else ""
        lines = [
            "# HELP dyn_slo_goodput_requests_total requests judged "
            "against the registered objectives (goodput = good/total)",
            "# TYPE dyn_slo_goodput_requests_total counter",
            f'dyn_slo_goodput_requests_total{{{labels}{sep}'
            f'verdict="good"}} {self.good}',
            f'dyn_slo_goodput_requests_total{{{labels}{sep}'
            f'verdict="bad"}} {self.total - self.good}',
            "# HELP dyn_slo_objective_miss_total requests that missed "
            "each objective",
            "# TYPE dyn_slo_objective_miss_total counter",
        ]
        for name, n in sorted(self.misses.items()):
            lines.append(f'dyn_slo_objective_miss_total{{{labels}{sep}'
                         f'objective="{name}"}} {n}')
        return lines


# ------------------------------------------------------------ render helper


def render_role_histograms(merged: Dict[str, Dict[str, Histogram]],
                           prefix: str = "dyn_slo",
                           labels: str = "") -> List[str]:
    """Prometheus text for a role-labeled latency view: one histogram
    family per metric (``<prefix>_<metric>_seconds{role=...}``) plus
    nearest-bucket quantile gauges."""
    lines: List[str] = []
    sep = "," if labels else ""
    metrics = sorted({m for per in merged.values() for m in per})
    for metric in metrics:
        name = f"{prefix}_{metric}_seconds"
        lines.append(f"# HELP {name} fleet-merged {metric} latency "
                     f"(mergeable fixed-bucket histogram, per worker "
                     f"role)")
        lines.append(f"# TYPE {name} histogram")
        for role in sorted(merged):
            h = merged[role].get(metric)
            if h is not None:
                lines.extend(h.render_prom(
                    name, f'{labels}{sep}role="{role}"'))
    if metrics:
        qname = f"{prefix}_latency_quantile_seconds"
        lines.append(f"# HELP {qname} nearest-bucket quantiles of the "
                     f"merged per-role latency histograms (error <= one "
                     f"bucket)")
        lines.append(f"# TYPE {qname} gauge")
        for metric in metrics:
            for role in sorted(merged):
                h = merged[role].get(metric)
                if h is None or h.count == 0:
                    continue
                for q, tag in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                    lines.append(
                        f'{qname}{{{labels}{sep}metric="{metric}",'
                        f'role="{role}",quantile="{tag}"}} '
                        f'{h.quantile(q)}')
    return lines
