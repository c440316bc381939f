"""Sampled dispatch profiler: the host/device split per bucket.

The port's copy of ``dynamo_tpu/engine/profiler.py`` ``EngineProfiler``
and ``memory_snapshot``. Every ``sample``-th scheduler iteration is a
sampled one: each dispatch on it is bracketed — start, the dispatch
returns (host cost), the device drains (device cost) — and the figures
accumulate in a cost table keyed by ``kind:B..xT..xP..`` (the bucket,
i.e. the captured graph that served it).

The drain is the one deliberate sync: an event recorded on the current
stream (the engine's stream) and ``synchronize()`` on it. It serialises
that iteration's pipeline, the documented sampling overhead, and it is
absent at ``sample=0`` (the default), where the whole per-iteration cost
is one integer compare and ``begin`` returns None, so the dispatch path
makes no host read.

Each profiler registers itself with ``runtime/profiling.py`` (the HTTP
frontend's ``/debug/profile`` lists every live engine's cost table), and
``mean_device_ms_per_step`` scales a request's step share into the
``device_ms_est`` of its cost attribution. :func:`trace_profiler` is the
``torch.profiler`` session the launcher's ``--profile-dir`` and the
frontend's ``/debug/profile/start`` both open.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Tuple

import torch

from ..runtime import profiling

log = logging.getLogger("dynamo_tpu_torch.engine.profiler")


class EngineProfiler:
    """Per-engine sampled dispatch timer and cost table. All mutation
    happens on the engine's single step thread; ``summary()`` reads are
    snapshot dict builds."""

    def __init__(self, name: str, device: torch.device, sample: int = 0,
                 timeline=None):
        self.name = name
        self.timeline = timeline
        self.device = device
        self.sample = max(int(sample), 0)
        self.sampling = False      # True while the current iteration samples
        self._iter = 0
        self.profiled_steps = 0
        self.device_seconds_total = 0.0
        self.dispatch_seconds_total = 0.0
        # "kind:B8xT512xP64" -> {samples, device_us, dispatch_us, tokens}
        self.buckets: Dict[str, dict] = {}
        profiling.register_profile(name, self)

    # ------------------------------------------------------------ sampling

    def tick(self) -> None:
        """Once per scheduler iteration. At sample=0 this is the whole
        hot-path cost: one compare, no syncs."""
        if self.sample <= 0:
            self.sampling = False
            return
        self._iter += 1
        self.sampling = (self._iter % self.sample) == 0

    def begin(self) -> Optional[float]:
        """Dispatch-bracket start, or None when this iteration is not
        sampled (``end`` is then a no-op)."""
        return time.perf_counter() if self.sampling else None

    def end(self, t0: Optional[float], kind: str, key: Tuple[int, ...],
            tokens: int = 0, drain: bool = False) -> None:
        """Dispatch-bracket end: host cost = return from dispatch − t0;
        device cost (``drain``) = the wait until the stream has run
        everything enqueued so far (queue + compute: under pipelining it
        includes work enqueued earlier, the honest figure for what the
        device is doing while the host dispatches)."""
        if self.sampling and t0 is not None:
            t1 = time.perf_counter()
            if drain:
                self._drain()
            t2 = time.perf_counter()
            self._record(kind, key, t1 - t0, t2 - t1, tokens)

    def _drain(self) -> None:
        """The deliberate sampled sync (module docstring)."""
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            event.synchronize()

    def _record(self, kind: str, key: Tuple[int, ...], dispatch_s: float,
                device_s: float, tokens: int) -> None:
        label = f"{kind}:" + "x".join(str(k) for k in key)
        # bounded: labels are bucket shapes (a fixed vocabulary)
        row = self.buckets.setdefault(label, {
            "samples": 0, "device_us": 0.0, "dispatch_us": 0.0,
            "tokens": 0})
        row["samples"] += 1
        row["device_us"] += device_s * 1e6
        row["dispatch_us"] += dispatch_s * 1e6
        row["tokens"] += int(tokens)
        self.profiled_steps += 1
        self.device_seconds_total += device_s
        self.dispatch_seconds_total += dispatch_s
        if self.timeline is not None:
            # bounded: the step timeline is a deque(maxlen=) ring
            self.timeline.add(
                "prof_sample", bucket=label,
                dispatch_us=round(dispatch_s * 1e6, 1),
                device_us=round(device_s * 1e6, 1), tokens=int(tokens))

    # ------------------------------------------------------------- exports

    def device_time_fraction(self) -> float:
        total = self.device_seconds_total + self.dispatch_seconds_total
        return self.device_seconds_total / total if total > 0 else 0.0

    def mean_device_ms_per_step(self) -> Optional[float]:
        """Mean sampled device drain per dispatch: what turns a request's
        occupancy-weighted step share into an estimated device-ms figure.
        None when nothing has been sampled (sample=0)."""
        if self.profiled_steps == 0:
            return None
        return self.device_seconds_total / self.profiled_steps * 1000.0

    def cost_table(self) -> Dict[str, dict]:
        """Per-bucket means: dispatch and device µs per dispatch, and
        device-side tokens/s."""
        out: Dict[str, dict] = {}
        for label, row in sorted(self.buckets.items()):
            n = max(row["samples"], 1)
            dev_s = row["device_us"] / 1e6
            out[label] = {
                "samples": row["samples"],
                "dispatch_us": round(row["dispatch_us"] / n, 1),
                "device_us": round(row["device_us"] / n, 1),
                "tokens_per_s": (round(row["tokens"] / dev_s, 1)
                                 if dev_s > 0 and row["tokens"] else 0.0),
            }
        return out

    def summary(self) -> dict:
        return {
            "sample_every": self.sample,
            "profiled_steps": self.profiled_steps,
            "device_time_fraction": round(self.device_time_fraction(), 4),
            "device_seconds_total": round(self.device_seconds_total, 6),
            "dispatch_seconds_total": round(self.dispatch_seconds_total, 6),
            "buckets": self.cost_table(),
        }


def memory_snapshot(pm, page_bytes: int) -> dict:
    """Page-pool occupancy from a PageManager: live (allocated), cached
    (reusable prefix pages) and free, in pages and KV bytes, plus the
    host tier when configured. Host-side reads only."""
    free = len(pm.free)
    cached = len(pm.reusable)
    live = pm.num_pages - 1 - free - cached
    out = {
        "page_bytes": page_bytes,
        "hbm": {
            "live_pages": live, "cached_pages": cached, "free_pages": free,
            "live_bytes": live * page_bytes,
            "cached_bytes": cached * page_bytes,
            "free_bytes": free * page_bytes,
        },
    }
    if pm.host_pages > 0:
        host_free = len(pm.host_free)
        host_used = pm.host_pages - host_free
        out["host"] = {
            "used_pages": host_used, "free_pages": host_free,
            "used_bytes": host_used * page_bytes,
        }
    return out


def trace_profiler(cuda: bool):
    """A started ``torch.profiler.profile`` of host ops and, with
    ``cuda``, the card's activity, over every thread of the process (the
    engine's work runs on its executor's and asyncio's threads). Raises
    when the profiler cannot start; with ``cuda`` it never falls back to
    a host-only trace."""
    from torch.profiler import ProfilerActivity, profile

    from torch._C._profiler import _ExperimentalConfig

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    try:
        config = _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        log.warning("this torch's profiler records the host ops of the "
                    "main thread only")
        config = _ExperimentalConfig()
    prof = profile(activities=activities, experimental_config=config)
    prof.start()
    return prof
