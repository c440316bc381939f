"""Mergeable latency histograms and the engine's latency recorder.

The port's copy of the part of ``dynamo_tpu/runtime/slo.py`` the engine
uses: :class:`Histogram` (fixed buckets, nearest-bucket quantiles, the
same wire form), the shared bucket grid
:data:`LATENCY_BUCKETS`, the metric names :data:`METRICS` and
:class:`LatencyRecorder`, whose ``to_wire()`` is what ``stats()`` exports
as ``latency_hist``. The objective registry, the burn-rate engine and
goodput accounting are not ported.
"""

from __future__ import annotations

import math
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Tuple

# Shared bucket bounds (seconds) for every latency metric, log-spaced from
# token cadence (1 ms) to request scale (minutes); the JAX package's grid,
# so histograms of both engines merge.
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0)

# The request-latency metrics the engine observes.
METRICS: Tuple[str, ...] = ("ttft", "itl", "queue_wait", "e2e")


class Histogram:
    """Fixed-bucket mergeable histogram (Prometheus cumulative semantics).

    ``counts`` holds per-bucket (non-cumulative) counts plus a trailing
    +Inf bucket; histograms with the same bounds merge by adding counts."""

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

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-bucket quantile (``q`` in [0, 1]): the upper bound of
        the bucket holding the exact nearest-rank observation (error
        bounded by one bucket width); past the last bound, the last
        bound."""
        if self.count <= 0:
            return None
        rank = max(int(math.ceil(q * self.count)), 1)
        run = 0
        for i, c in enumerate(self.counts[:-1]):
            run += c
            if run >= rank:
                return self.ubs[i]
        return self.ubs[-1]

    def to_wire(self) -> dict:
        """The stats-plane form (bounds ride along, so a peer with another
        grid fails at merge)."""
        return {"ubs": list(self.ubs), "counts": list(self.counts),
                "sum": round(self.sum, 6), "count": self.count}


class LatencyRecorder:
    """Per-role latency histograms for one engine. ``observe`` is host
    arithmetic only (no device work), so it is safe on the hot path. The
    wire form is ``{role: {metric: histogram}}``."""

    def __init__(self, role: str = "unified"):
        self.role = role
        self.hists: Dict[str, Dict[str, Histogram]] = {}

    def observe(self, metric: str, value: float, n: int = 1) -> None:
        # bounded: keyed by role, then metric, both fixed vocabularies
        per_role = self.hists.setdefault(self.role, {})
        h = per_role.get(metric)
        if h is None:
            h = per_role[metric] = Histogram()
        h.observe(value, n)

    def to_wire(self) -> dict:
        return {role: {m: h.to_wire() for m, h in sorted(per.items())}
                for role, per in sorted(self.hists.items())}
