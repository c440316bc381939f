"""CUDA graphs of the fused decode window, one per warmed (B, P) bucket.

This module plays the part of ``jax.jit``'s executable cache in the JAX
engine (``dynamo_tpu/engine/jax_engine.py`` ``warmup``, which compiles
one decode-window program per (batch, page) bucket of
``EngineConfig.warmed_grid``). Each bucket owns static input buffers —
the carry (tok, pos, done, steps, remaining), the page table [B, P], the
sampler parameters and the stop table [B, E] — and the static outputs of
its last launch (toks [B, K], emitted [B], the carry). On a CUDA device
the window is captured once per bucket into a ``torch.cuda.CUDAGraph``
and each launch is one replay; on the CPU the same buffers feed a direct
call of the window function, so the CPU tests reach the bucket choice,
padding, copy-in and copy-out around the graphs.

Rules the caller keeps (the engine does):

- every launch runs on :attr:`DecodeGraphs.stream`, the stream the
  graphs were warmed and captured on (the bf16 decode kernel's arrival
  counters are per stream and are baked into the graphs); a launch from
  another stream raises;
- a bucket's outputs are overwritten by its next launch, and since the
  graphs share one memory pool, by the launch of another bucket too:
  copy what is needed (:func:`to_host`, or the next window's carry
  merge) right after the launch, in stream order, before the next one;
- a capture after :meth:`CompileFence.arm` is a serving stall and is
  reported to the fence (``engine/jit_fence.py``).

A capture or replay error raises: there is no eager fallback on the card.
Kernel launch counts (``ops.paged_attention.LAUNCHES`` and
``DECODE_ROUTE_LAUNCHES``) count Python calls, and a replay makes none:
each graph records the counts its capture added (and takes them back,
since a capture launches nothing) and adds them again at every replay.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..ops import paged_attention as ops
from .jit_fence import CompileFence

_COUNTS = (ops.LAUNCHES, ops.DECODE_ROUTE_LAUNCHES)


def upload(dst: torch.Tensor, a: np.ndarray) -> None:
    """Copy a host array into a device buffer without waiting for the
    device: through pinned staging memory, ``non_blocking`` (a pageable
    or blocking copy would synchronise the stream). The caching host
    allocator keeps the staging block until the copy has run."""
    src = torch.from_numpy(np.ascontiguousarray(a))
    if dst.is_cuda:
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A new device tensor holding ``a``, uploaded as :func:`upload`
    does."""
    src = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return src.pin_memory().to(device, non_blocking=True)
    return src.to(device)


def to_host(*tensors: torch.Tensor
            ) -> Tuple[List[torch.Tensor], Optional[torch.cuda.Event]]:
    """Enqueue device-to-host copies of ``tensors`` into pinned buffers
    on the current stream, then an event: read the buffers only after
    ``event.synchronize()``. CPU tensors are cloned and the event is
    None."""
    if not tensors[0].is_cuda:
        return [t.clone() for t in tensors], None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _snapshot() -> List[Dict[str, int]]:
    return [dict(c) for c in _COUNTS]


@dataclass(eq=False)
class DecodeBucket:
    """Static buffers of one (B, P) bucket; see the module docstring."""

    B: int
    P: int
    tok: torch.Tensor            # [B] int32
    pos: torch.Tensor            # [B] int32, -1 = padding row
    done: torch.Tensor           # [B] bool
    steps: torch.Tensor          # [B] int32
    rem: torch.Tensor            # [B] int32
    table: torch.Tensor          # [B, P] int32
    temperature: torch.Tensor    # [B] float32
    top_k: torch.Tensor          # [B] int32
    top_p: torch.Tensor          # [B] float32
    seeds: torch.Tensor          # [B] int64
    eos: torch.Tensor            # [B, E] int32
    rows: torch.Tensor           # [6, B] int32 host rows (engine staging)
    toks: Optional[torch.Tensor] = None      # outputs of the last launch
    emitted: Optional[torch.Tensor] = None
    carry: Optional[tuple] = None
    graph: Optional["torch.cuda.CUDAGraph"] = None
    # launch counts one replay adds (the capture's own)
    counts: List[Dict[str, int]] = field(default_factory=list)

    @property
    def carry_in(self) -> tuple:
        return self.tok, self.pos, self.done, self.steps, self.rem


class DecodeGraphs:
    """One fused decode window per (B, P) bucket: captured CUDA graphs on
    the card, direct calls on the CPU (module docstring)."""

    def __init__(self, window_fn: Callable, params, kv_k: torch.Tensor,
                 kv_v: torch.Tensor, *, k_steps: int, max_eos_ids: int,
                 fence: Optional[CompileFence] = None):
        self.window_fn = window_fn
        self.params = params
        self.kv_k, self.kv_v = kv_k, kv_v
        self.k_steps = k_steps
        self.max_eos_ids = max_eos_ids
        self.fence = fence
        self.device = kv_k.device
        self.on_card = self.device.type == "cuda"
        self.buckets: Dict[Tuple[int, int], DecodeBucket] = {}
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.on_card else None)
        self.pool = torch.cuda.graph_pool_handle() if self.on_card else None
        self.capture_seconds = 0.0   # warm calls and captures, summed
        self.pool_bytes = 0          # device memory reserved by captures

    def stream_ctx(self):
        """Context that makes :attr:`stream` current, after the work
        already queued on the caller's stream (no-op on the CPU)."""
        if not self.on_card:
            return contextlib.nullcontext()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(self.stream)

    # ------------------------------------------------------------ buckets

    def _new_bucket(self, B: int, P: int) -> DecodeBucket:
        """Buffers holding padding rows: a launch over them writes
        nothing to the pool."""
        dev = self.device

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        i32 = torch.int32
        return DecodeBucket(
            B=B, P=P, tok=full((B,), 0, i32), pos=full((B,), -1, i32),
            done=full((B,), False, torch.bool), steps=full((B,), 0, i32),
            rem=full((B,), 1, i32), table=full((B, P), 0, i32),
            temperature=full((B,), 0.0, torch.float32),
            top_k=full((B,), 0, i32), top_p=full((B,), 1.0, torch.float32),
            seeds=full((B,), 0, torch.int64),
            eos=full((B, self.max_eos_ids), -1, i32),
            rows=full((6, B), 0, i32))

    def _call(self, bk: DecodeBucket) -> None:
        """The window on the bucket's static inputs; outputs into it."""
        bk.toks, bk.emitted, bk.carry, _, _ = self.window_fn(
            self.params, *bk.carry_in, self.kv_k, self.kv_v, bk.table,
            bk.temperature, bk.top_k, bk.top_p, bk.seeds, bk.eos,
            k_steps=self.k_steps)

    def capture(self, grid: Iterable[Tuple[int, int]]) -> None:
        """Capture every (B, P) of ``grid``, the largest first (so the
        shared pool is sized by the first capture and the smaller ones
        fit in it)."""
        t0 = time.monotonic()
        if self.on_card:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
        for B, P in sorted(set(grid), reverse=True):
            if (B, P) not in self.buckets:
                self._capture(B, P)
        if self.on_card:
            torch.cuda.synchronize(self.device)
            self.pool_bytes += torch.cuda.memory_reserved(
                self.device) - reserved
        self.capture_seconds += time.monotonic() - t0

    def _capture(self, B: int, P: int) -> DecodeBucket:
        """Warm the window eagerly once on the stream over padding rows
        (library loads, the decode kernel's per-stream counters, cuBLAS
        workspaces), then capture it on the same stream."""
        with self.stream_ctx():
            bk = self._new_bucket(B, P)
            self._call(bk)
        if self.on_card:
            self.stream.synchronize()
            before = _snapshot()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=self.pool,
                                      stream=self.stream):
                    self._call(bk)
            finally:
                after = _snapshot()
                # a capture launches nothing: take its counts back
                for counts, old in zip(_COUNTS, before):
                    counts.update(old)
            bk.counts = [{k: a[k] - b[k] for k in a}
                         for a, b in zip(after, before)]
            bk.graph = graph
        self.buckets[(B, P)] = bk
        return bk

    def bucket(self, B: int, P: int) -> DecodeBucket:
        """The bucket of (B, P), captured now if warmup did not (a fenced
        capture: counted, and warned or raised per DYN_JIT_FENCE)."""
        bk = self.buckets.get((B, P))
        if bk is None:
            if self.fence is not None:
                self.fence.on_compile(f"decode window (B={B}, P={P})")
            t0 = time.monotonic()
            bk = self._capture(B, P)
            self.capture_seconds += time.monotonic() - t0
        return bk

    def launch(self, bk: DecodeBucket) -> None:
        """Run the bucket's window on its current inputs: one replay on
        the card (the stream must be :attr:`stream`), a direct call on
        the CPU."""
        if bk.graph is None:
            self._call(bk)
            return
        current = torch.cuda.current_stream(self.device)
        if current != self.stream:
            raise RuntimeError(
                f"decode graph (B={bk.B}, P={bk.P}) launched on stream "
                f"{current.cuda_stream:#x}, which was never warmed; its "
                f"graphs run on {self.stream.cuda_stream:#x} only")
        bk.graph.replay()
        for counts, delta in zip(_COUNTS, bk.counts):
            for k, n in delta.items():
                counts[k] += n
