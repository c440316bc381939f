"""The host KV tier's storage and copies (``jax_engine.py`` host pools,
``_gather_pages`` / ``_inject_pages`` and the drain's copy halves).

Pages evicted from the device pools ``[L, pages, ...]`` move into host
pools allocated once, when the engine is built: pinned memory on the
card, plain tensors on the CPU. The host layout is slot-major,
``[host_pages, L, ...]``, so every slot is one contiguous block and a
run of consecutive slots one ``non_blocking`` copy, with no staging
buffer between the device and the pool. With ``int8`` a slot holds the
page's int8 rows and their float32 scales ``[..., 1]``
(``engine/kv_compress.py``): quantized on the device before the
device-to-host copy, dequantized on the device after the copy back.

The scheduling (which pages, when, and the gating of sequences) is the
engine's (``TorchEngine._drain_kv_tier``); this module only moves bytes,
and orders every copy on a CUDA stream:

- an offload's gather, quantize and device-to-host copies are enqueued
  on the caller's (the engine's) stream, so they read what every earlier
  dispatch left in the pages and run before any later one overwrites
  them; the returned :class:`Offload` lands (``wait``) once its event has
  completed, and keeps its device temporaries alive until then;
- a restore's host-to-device copies and dequantize run on the caller's
  stream, or on the tier's copy stream (``stage(..., side=True)``, the
  overlapped restore), whose event the caller's stream waits for before
  the rows are injected (``inject``);
- page indices reach the card through a ring of pinned buffers
  (``_IndexRing``), each reused only after its last copy has run.

Every pinned allocation is counted (``pinned_allocs``); once the engine
has warmed up (``armed``) any further one also counts in
``pinned_after_warmup``, which the tier's design keeps at 0."""

from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import torch

from .kv_compress import dequantize_pages, quantize_pages


def slot_runs(slots: Sequence[int]) -> List[Tuple[int, int, int]]:
    """Runs of consecutive slots as (first slot, row of the batch, count):
    each run is one copy to or from the host pool."""
    runs: List[Tuple[int, int, int]] = []
    for row, slot in enumerate(slots):
        if runs and runs[-1][0] + runs[-1][2] == slot:
            first, at, n = runs[-1]
            runs[-1] = (first, at, n + 1)
        else:
            runs.append((slot, row, 1))
    return runs


class _IndexRing:
    """Pinned int64 staging for page indices: ``upload`` writes a list
    into the next buffer and copies it to the device ``non_blocking``;
    a buffer is rewritten only after the event of its last copy."""

    def __init__(self, tier: "HostTier", depth: int, width: int):
        self.bufs = [tier._alloc((width,), torch.int64)
                     for _ in range(depth)]
        self.events: List[Optional[torch.cuda.Event]] = [None] * depth
        self.device = tier.device
        self.at = 0

    def upload(self, values: Sequence[int]) -> torch.Tensor:
        i, self.at = self.at, (self.at + 1) % len(self.bufs)
        if self.events[i] is not None:
            self.events[i].synchronize()
        buf = self.bufs[i][:len(values)]
        buf.numpy()[:] = values
        if self.device.type != "cuda":
            return buf.clone()
        out = buf.to(self.device, non_blocking=True)
        self.events[i] = torch.cuda.Event()
        self.events[i].record()
        return out


@dataclass
class Offload:
    """An offload batch in flight: its host slots hold the pages once
    ``event`` has completed; ``keep`` holds the device sources until
    then."""

    slots: List[int]
    event: Optional[torch.cuda.Event]
    keep: List[torch.Tensor] = field(default_factory=list)

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()
        self.keep = []


@dataclass
class Staged:
    """A restore batch on the device: ``rows`` (K, V) slot-major
    ``[n, L, ...]`` in the pools' dtypes, complete once the caller's
    stream has waited for ``event`` (None: made on the caller's
    stream)."""

    rows: Tuple[torch.Tensor, torch.Tensor]
    event: Optional[torch.cuda.Event] = None


class HostTier:
    """The host pools of one engine's two device pools, and the copies
    between them (module docstring)."""

    RING_DEPTH = 8

    def __init__(self, kv_k: torch.Tensor, kv_v: torch.Tensor,
                 host_pages: int, int8: bool):
        self.device = kv_k.device
        self.on_card = self.device.type == "cuda"
        self.int8 = bool(int8)
        self.host_pages = host_pages
        self.pinned_allocs = 0
        self.pinned_after_warmup = 0
        self.armed = False
        t0 = time.perf_counter()
        self.pools = []    # per device pool: (values, scales or None)
        for pool in (kv_k, kv_v):
            # the page geometry comes from the pool as allocated: MLA's
            # latent and rope pools differ in width
            shape = (host_pages, pool.shape[0], *pool.shape[2:])
            if self.int8:
                self.pools.append((self._alloc(shape, torch.int8),
                                   self._alloc(shape[:-1] + (1,),
                                               torch.float32)))
            else:
                self.pools.append((self._alloc(shape, pool.dtype), None))
        self.ring = _IndexRing(self, self.RING_DEPTH, kv_k.shape[1])
        # the host clock's seconds to allocate (and pin) every buffer
        self.alloc_seconds = time.perf_counter() - t0
        self.copy_stream = (torch.cuda.Stream(device=self.device)
                            if self.on_card else None)

    def _alloc(self, shape, dtype) -> torch.Tensor:
        self.pinned_allocs += 1
        if self.armed:
            self.pinned_after_warmup += 1
        return torch.empty(shape, dtype=dtype, pin_memory=self.on_card)

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for p in self.pools for t in p if t is not None)

    def warm(self, pools: Tuple[torch.Tensor, torch.Tensor], n: int) -> None:
        """Run each copy path once at ``n`` pages before serving (the
        engine's warmup, on its stream), so the first offload and
        restore find their device blocks cached: the copy stream's
        allocations come from a pool of their own, and a first one made
        while other pools hold the card's memory waits for the allocator
        to free them. Host slots 0..n-1 take page 0's content, harmless
        while no slot is mapped; nothing is injected."""
        n = min(n, self.host_pages)
        self.offload(pools, [0] * n, list(range(n))).wait()
        for side in (False, True):
            staged = self.stage(list(range(n)), tuple(p.dtype for p in pools),
                                side=side)
            if staged.event is not None:
                staged.event.synchronize()

    # ------------------------------------------------------------ offload

    def offload(self, pools: Tuple[torch.Tensor, torch.Tensor],
                pages: List[int], slots: List[int]) -> Offload:
        """Enqueue, on the current stream, the gather of ``pages`` out of
        both device pools (quantized with ``int8``) and its copy into the
        host ``slots``; no host wait."""
        idx = self.ring.upload(pages)
        keep: List[torch.Tensor] = []
        runs = slot_runs(slots)
        for pool, (hval, hscale) in zip(pools, self.pools):
            g = torch.index_select(pool.transpose(0, 1), 0, idx)
            parts = ((hval, g),)
            if self.int8:
                q, s = quantize_pages(g)
                parts = ((hval, q), (hscale, s))
            for host, src in parts:
                for first, at, n in runs:
                    host[first:first + n].copy_(src[at:at + n],
                                                non_blocking=True)
                keep.append(src)
        event = None
        if self.on_card:
            event = torch.cuda.Event()
            event.record()
        return Offload(slots=list(slots), event=event, keep=keep)

    # ------------------------------------------------------------ restore

    def stage(self, slots: List[int], dtypes: Tuple[torch.dtype, ...],
              side: bool = False) -> Staged:
        """Copy host ``slots`` to the device, dequantized with ``int8``,
        as rows in the pools' ``dtypes``: on the current stream, or with
        ``side`` on the tier's copy stream (the caller's stream must wait
        for the returned event before reading the rows: ``inject`` does).
        The host slots must hold their pages (every offload into them
        landed)."""
        stream = self.copy_stream if side and self.on_card else None
        runs = slot_runs(slots)
        rows = []
        with (torch.cuda.stream(stream) if stream is not None
              else nullcontext()):
            for (hval, hscale), dt in zip(self.pools, dtypes):
                dev = []
                for host in (hval, hscale)[:2 if self.int8 else 1]:
                    d = torch.empty((len(slots), *host.shape[1:]),
                                    dtype=host.dtype, device=self.device)
                    for first, at, n in runs:
                        d[at:at + n].copy_(host[first:first + n],
                                           non_blocking=True)
                    dev.append(d)
                rows.append(dequantize_pages(*dev).to(dt) if self.int8
                            else dev[0])
            event = None
            if stream is not None:
                event = torch.cuda.Event()
                event.record(stream)
        return Staged(rows=tuple(rows), event=event)

    def inject(self, pools: Tuple[torch.Tensor, torch.Tensor],
               staged: Staged, pages: List[int],
               keep: Optional[List[int]] = None) -> None:
        """Write the staged rows into ``pages`` of both device pools, in
        place, on the current stream. ``keep`` lists the rows to write
        (None: all); the others' pages were recycled since staging and
        are left alone (the reference's out-of-range pad target, which
        its scatter drops: torch indexing has no drop mode)."""
        if staged.event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(staged.event)
            for r in staged.rows:
                # the rows were allocated on the copy stream; this stream
                # reads them, so their blocks are not reused before it has
                r.record_stream(cur)
        rows = staged.rows
        if keep is not None and len(keep) < len(pages):
            if not keep:
                return
            pos = self.ring.upload(keep)
            rows = tuple(r.index_select(0, pos) for r in rows)
            pages = [pages[i] for i in keep]
        idx = self.ring.upload(pages)
        for pool, r in zip(pools, rows):
            pool.index_copy_(1, idx, r.transpose(0, 1))
