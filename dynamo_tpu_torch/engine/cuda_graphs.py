"""CUDA graphs of the engine's dispatches, one per warmed bucket: the
fused decode window per (B, P), the prefill chunk per (B, T, P), and on
the synchronous decode arms the single-step decode and the speculative
verify step per (B, P).

This module plays the part of ``jax.jit``'s executable cache in the JAX
engine (``dynamo_tpu/engine/jax_engine.py`` ``warmup``, which compiles
one decode-window program per (batch, page) bucket and one prefill
program per (page, chunk length, prefill batch) bucket of
``EngineConfig.warmed_grid``). Each bucket owns static input buffers and
the static outputs of its last launch. On a CUDA device the function is
captured once per bucket into a ``torch.cuda.CUDAGraph`` and each launch
is one replay; on the CPU the same buffers feed a direct call of the
function, so the CPU tests reach the bucket choice, padding, copy-in and
copy-out around the graphs.

- :class:`DecodeGraphs`: the window's carry (tok, pos, done, steps,
  remaining), page table [B, P], sampler parameters and stop table
  [B, E] in; toks [B, K], emitted [B] and the carry out.
- :class:`PrefillGraphs`: one packed int32 buffer holding every input of
  a chunk (tokens, positions, table, slots, last_idx, pslots and the
  first-token sampler's temperature, top_k, top_p, seeds and steps), so
  a dispatch is one upload, one replay and one copy of the sampled
  tokens; logits [B, V] and sampled [B] out. Each bucket is captured in
  the serving form of its shape, as the JAX engine warms it:
  page-granular commit (``pslots``) when T % page_size == 0, row scatter
  otherwise; the form is part of the key.
- :class:`StepGraphs`: one decode step (``decode_steps=1``, the JAX
  engine's ``decode_fn`` and its ``_sample_device``): tokens, positions,
  write slots, page table and the sampler's inputs packed as a chunk's
  are; the sampled tokens [B] (and their logprobs) out.
- :class:`VerifyGraphs`: the verify forward of self-speculative decoding
  (``models/llama.py make_verify_fn``) and its accept mask
  (``engine/sampling.py verify_greedy_draft``) in one graph: the [B, K+1]
  tokens, positions and slots, the table and the drafts packed; out
  [B, K+1] and accepted [B] out.

A set is one VARIANT of its function, the JAX engine's static
arguments: a bucket's full key is (variant, shape). A decode variant is
the logprobs width (``logprobs_topn``: 0, or the engine's
``max_top_logprobs``; aux = (lp [B, K], top_vals [B, K, n], top_ids
[B, K, n]) out) and the penalty form (:data:`PENALTY_FORMS`: none, or
the sampler's penalty tuple), whose inputs are views of one
:class:`PenaltyBuffers` at the largest batch; a prefill variant is
whether the first-token draw also gives its logprobs.

Every set shares one stream and one memory pool (each is built over the
plain decode set's). Rules the caller keeps (the engine does):

- every launch runs on :attr:`stream`, the stream the graphs were warmed
  and captured on, where the caller writes a bucket's static inputs and
  reads its outputs, and whose order alone keeps one launch's use of the
  shared memory pool from overlapping the next; a launch from another
  stream raises;
- a bucket's outputs are overwritten by its next launch, and since the
  graphs share one memory pool, by the launch of another bucket too:
  copy what is needed (:func:`to_host`, or the next window's carry
  merge) right after the launch, in stream order, before the next one;
- a capture after :meth:`CompileFence.arm` is a serving stall and is
  reported to the fence (``engine/jit_fence.py``), a prefill miss as
  much as a decode one.

A capture or replay error raises: there is no eager fallback on the card.
Kernel launch counts (``ops.paged_attention.LAUNCHES``,
``DECODE_ROUTE_LAUNCHES``, ``PREFILL_ROUTE_LAUNCHES`` and
``ops.int8_gemm.INT8_GEMM_LAUNCHES``, the last by route and form:
small_m, wgmma and the float16 and float32 forms small_m_f16,
wgmma_f16, small_m_f32, wgmma_f32) count
Python calls, and a replay
makes none:
each graph records the counts its capture added (and takes them back,
since a capture launches nothing) and adds them again at every replay.

Under tensor parallelism the captured functions hold NCCL collectives
(``models/llama.py``). Each rank captures the same buckets in the same
order at warmup (:meth:`_GraphSet.capture` sorts its keys), and a rank
captures a missing bucket only when rank 0 has announced the dispatch
that needs it, so the collectives of the warm calls, the captures and
the replays pair up across ranks. The device group's communicator is
made by an eager collective before any capture (``parallel/mesh.py``
``MeshSpec.build``).
:attr:`pool_bytes` is the growth of the pool's own segments (the caching
allocator's segments of the pool, ``torch.cuda.memory_snapshot``) over
the set's captures, so blocks the eager warm calls leave cached outside
the pool do not count.
"""

from __future__ import annotations

import collections
import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..models.llama import DROP_SLOT
from ..ops import int8_gemm
from ..ops import paged_attention as ops
from .jit_fence import CompileFence
from .sampling import (fill_penalty_state, logprob_aux, sample_tokens,
                       verify_greedy_draft)

_COUNTS = (ops.LAUNCHES, ops.DECODE_ROUTE_LAUNCHES,
           ops.PREFILL_ROUTE_LAUNCHES, int8_gemm.INT8_GEMM_LAUNCHES)

# a decode window's penalty form: none, or the sampler's penalty tuple
# (the [B, V] counts and presence, the per-row rep, freq and pres and the
# [B, V] logit_bias rows), for a batch with any penalty or logit_bias
PEN_NONE, PEN_FULL = 0, 1
PENALTY_FORMS = {PEN_NONE: "no penalties", PEN_FULL: "penalties"}


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


def pool_segment_bytes(pool, device: torch.device) -> int:
    """Device memory held by the graph memory pool ``pool``: the sizes
    of the caching allocator's segments that belong to it."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if s["device"] == index
               and tuple(s["segment_pool_id"]) == tuple(pool))


def _snapshot() -> List[Dict[str, int]]:
    return [dict(c) for c in _COUNTS]


class _GraphSet:
    """One function captured per bucket key over a shared stream and
    pool; subclasses make a bucket's static buffers (``_new_bucket``)
    and call the function on them (``_call``). Buckets carry ``graph``
    and ``counts``."""

    kind = ""

    def __init__(self, device: torch.device,
                 fence: Optional[CompileFence] = None,
                 share: Optional["_GraphSet"] = None):
        self.device = device
        self.fence = fence
        self.on_card = device.type == "cuda"
        self.buckets: Dict[tuple, object] = {}
        if share is not None:
            self.stream, self.pool = share.stream, share.pool
        else:
            self.stream = (torch.cuda.Stream(device=device)
                           if self.on_card else None)
            self.pool = (torch.cuda.graph_pool_handle()
                         if self.on_card else None)
        self.capture_seconds = 0.0   # warm calls and captures, summed
        self.pool_bytes = 0          # pool segments added by this set
        self.replays = 0             # graph launches (card only)
        # graph launches by bucket key (a MoE model's cost model picks its
        # expert dispatch from the bucket's shape)
        self.replays_by_key: Dict[tuple, int] = collections.Counter()

    def stream_ctx(self):
        """Context that makes :attr:`stream` current, after the work
        already queued on the caller's stream (no-op on the CPU)."""
        if not self.on_card:
            return contextlib.nullcontext()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(self.stream)

    def _new_bucket(self, *key):
        raise NotImplementedError

    def _call(self, bk) -> None:
        raise NotImplementedError

    def _form(self, key: tuple) -> str:
        raise NotImplementedError

    def capture(self, keys: Iterable[tuple]) -> None:
        """Capture every bucket of ``keys``, the largest first (so the
        first capture sizes the shared pool and the smaller ones fit in
        it)."""
        t0 = time.monotonic()
        for key in sorted(set(keys), reverse=True):
            if key not in self.buckets:
                self._capture(key)
        self.capture_seconds += time.monotonic() - t0

    def bucket(self, *key):
        """The bucket of ``key``, captured now if warmup did not (a
        fenced capture: counted, and warned or raised per
        DYN_JIT_FENCE)."""
        bk = self.buckets.get(key)
        if bk is None:
            if self.fence is not None:
                self.fence.on_compile(self._form(key))
            t0 = time.monotonic()
            bk = self._capture(key)
            self.capture_seconds += time.monotonic() - t0
        return bk

    def _capture(self, key: tuple):
        """Warm the function eagerly once on the stream over padding
        inputs (library loads, the decode kernels' occupancy queries,
        cuBLAS workspaces, the prefill kernel's driver entry point and
        shared-memory attribute), then capture it on the same stream."""
        with self.stream_ctx():
            bk = self._new_bucket(*key)
            self._call(bk)
        if self.on_card:
            self.stream.synchronize()
            held = pool_segment_bytes(self.pool, self.device)
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
            self.pool_bytes += pool_segment_bytes(self.pool,
                                                  self.device) - held
        self.buckets[key] = bk
        return bk

    def launch(self, bk) -> None:
        """Run the bucket's function on its current inputs: one replay on
        the card (the stream must be :attr:`stream`), a direct call on
        the CPU."""
        if bk.graph is None:
            self._call(bk)
            return
        current = torch.cuda.current_stream(self.device)
        if current != self.stream:
            raise RuntimeError(
                f"{self.kind} graph {self._form(bk.key)} launched on "
                f"stream {current.cuda_stream:#x}, which was never warmed; "
                f"its graphs run on {self.stream.cuda_stream:#x} only")
        bk.graph.replay()
        self.replays += 1
        self.replays_by_key[bk.key] += 1
        for counts, delta in zip(_COUNTS, bk.counts):
            for k, n in delta.items():
                counts[k] += n


# ------------------------------------------------------------------ decode


@dataclass(eq=False)
class PenaltyBuffers:
    """The penalised dispatches' sampler inputs at the largest batch,
    shared by every penalised decode bucket and the prefill's penalised
    first-token draw (each reads views of its first B rows; one dispatch
    runs at a time, on one stream): the (counts, presence) state that
    :meth:`fill` rebuilds from the rows' token ids, and the per-request
    parameters that :meth:`upload` sets. A row whose rep, freq and pres
    are neutral reads nothing of the state (``apply_penalties`` gives
    exactly its logits plus its bias), so a batch without a count-driven
    penalty skips :meth:`fill` and leaves the state as it was. Neutral at
    rest, so a warm call over them changes no logit."""

    counts: torch.Tensor     # [Bmax, V] int32, generated-token counts
    presence: torch.Tensor   # [Bmax, V] int8, context presence
    rep: torch.Tensor        # [Bmax] float32
    freq: torch.Tensor       # [Bmax] float32
    pres: torch.Tensor       # [Bmax] float32
    bias: torch.Tensor       # [Bmax, V] float32, logit_bias rows

    @classmethod
    def make(cls, rows: int, vocab: int,
             device: torch.device) -> "PenaltyBuffers":
        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=device)

        f32 = torch.float32
        return cls(counts=full((rows, vocab), 0, torch.int32),
                   presence=full((rows, vocab), 0, torch.int8),
                   rep=full((rows,), 1.0, f32), freq=full((rows,), 0.0, f32),
                   pres=full((rows,), 0.0, f32),
                   bias=full((rows, vocab), 0.0, f32))

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in (self.counts, self.presence, self.rep,
                                      self.freq, self.pres, self.bias))

    def penalties(self, B: int) -> tuple:
        """The sampler's penalty tuple over the first B rows (views)."""
        return (self.counts[:B], self.presence[:B], self.rep[:B],
                self.freq[:B], self.pres[:B], self.bias[:B])

    def upload(self, B: int, rep: np.ndarray, freq: np.ndarray,
               pres: np.ndarray, bias_at: np.ndarray,
               bias_val: np.ndarray) -> None:
        """Set the first B rows' parameters: rep, freq, pres [B] float32,
        and logit_bias as its N entries (``bias_at`` [2, N] int32 rows
        and token ids, each pair once; ``bias_val`` [N] float32),
        scattered into the zeroed bias rows on the device."""
        for dst, a in ((self.rep, rep), (self.freq, freq),
                       (self.pres, pres)):
            upload(dst[:B], a)
        self.bias[:B].zero_()
        if bias_val.size:
            at = to_device(bias_at, self.bias.device).long()
            self.bias.index_put_((at[0], at[1]),
                                 to_device(bias_val, self.bias.device))

    def fill(self, B: int, ids: np.ndarray, starts: np.ndarray) -> None:
        """Rebuild the first B rows' state on the device from their token
        ids [B, C] (-1 padded) and first generated positions [B]
        (``engine/sampling.py fill_penalty_state``)."""
        dev = self.counts.device
        fill_penalty_state(self.counts[:B], self.presence[:B],
                           to_device(ids, dev), to_device(starts, dev))


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
    # the sampler's penalty tuple (PenaltyBuffers views), None if plain
    pen: Optional[tuple] = None
    toks: Optional[torch.Tensor] = None      # outputs of the last launch
    emitted: Optional[torch.Tensor] = None
    aux: Optional[tuple] = None              # logprobs variants only
    carry: Optional[tuple] = None
    graph: Optional["torch.cuda.CUDAGraph"] = None
    # launch counts one replay adds (the capture's own)
    counts: List[Dict[str, int]] = field(default_factory=list)

    @property
    def key(self) -> Tuple[int, int]:
        return self.B, self.P

    @property
    def carry_in(self) -> tuple:
        return self.tok, self.pos, self.done, self.steps, self.rem


def variant_name(logprobs_topn: int, penalty_form: int = PEN_NONE) -> str:
    """A graph variant's name: "plain", or its logprobs width and its
    penalty form."""
    parts = [f"logprobs {logprobs_topn}"] if logprobs_topn else []
    if penalty_form != PEN_NONE:
        parts.append(PENALTY_FORMS[penalty_form])
    return ", ".join(parts) or "plain"


class DecodeGraphs(_GraphSet):
    """One fused decode window per (B, P) bucket of one variant (module
    docstring): captured CUDA graphs on the card, direct calls on the
    CPU."""

    kind = "decode window"

    def __init__(self, window_fn: Callable, params, kv_k: torch.Tensor,
                 kv_v: torch.Tensor, *, k_steps: int, max_eos_ids: int,
                 logprobs_topn: int = 0, penalty_form: int = PEN_NONE,
                 penalty_buffers: Optional[PenaltyBuffers] = None,
                 fence: Optional[CompileFence] = None,
                 share: Optional[_GraphSet] = None):
        super().__init__(kv_k.device, fence, share)
        if penalty_form != PEN_NONE and penalty_buffers is None:
            raise ValueError("a penalised variant needs PenaltyBuffers")
        self.window_fn = window_fn
        self.params = params
        self.kv_k, self.kv_v = kv_k, kv_v
        self.k_steps = k_steps
        self.max_eos_ids = max_eos_ids
        self.logprobs_topn = logprobs_topn
        self.penalty_form = penalty_form
        self.penalty_buffers = penalty_buffers
        self.variant = variant_name(logprobs_topn, penalty_form)

    def _form(self, key: tuple) -> str:
        extra = "" if self.variant == "plain" else f", {self.variant}"
        return f"decode window (B={key[0]}, P={key[1]}{extra})"

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
            rows=full((6, B), 0, i32),
            pen=(self.penalty_buffers.penalties(B)
                 if self.penalty_form != PEN_NONE else None))

    def _call(self, bk: DecodeBucket) -> None:
        """The window on the bucket's static inputs; outputs into it."""
        out = self.window_fn(
            self.params, *bk.carry_in, self.kv_k, self.kv_v, bk.table,
            bk.temperature, bk.top_k, bk.top_p, bk.seeds, bk.eos, bk.pen,
            k_steps=self.k_steps, logprobs_topn=self.logprobs_topn)
        if self.logprobs_topn:
            bk.toks, bk.emitted, bk.aux, bk.carry, _, _ = out
        else:
            bk.toks, bk.emitted, bk.carry, _, _ = out


# ----------------------------------------------------------------- prefill


def _prefill_layout(B: int, T: int, P: int, n_pages: int, drop_slot: int,
                    num_pages: int) -> List[Tuple[str, Tuple[int, ...],
                                                  np.dtype, float]]:
    """(name, shape, dtype, padding value) of each input of a prefill
    chunk, in packed order: seeds first, so the int64 field starts on an
    8-byte boundary of the int32 buffer."""
    i32, f32 = np.dtype(np.int32), np.dtype(np.float32)
    return [("seeds", (B,), np.dtype(np.int64), 0),
            ("temperature", (B,), f32, 0.0), ("top_p", (B,), f32, 1.0),
            ("top_k", (B,), i32, 0), ("steps", (B,), i32, 0),
            ("last_idx", (B,), i32, 0), ("tokens", (B, T), i32, 0),
            ("positions", (B, T), i32, -1), ("slots", (B, T), i32, drop_slot),
            ("table", (B, P), i32, 0),
            ("pslots", (B, n_pages), i32, num_pages)]


_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.float32): torch.float32}


@dataclass(eq=False)
class PrefillBucket:
    """Static buffers of one (B, T, P, paged) bucket: ``packed`` on the
    device holds every input (``inputs`` are views of it by name);
    ``blank`` is the host image of a chunk of padding rows, which a
    dispatch copies, fills and uploads whole."""

    B: int
    T: int
    P: int
    paged: bool
    packed: torch.Tensor                 # int32 device buffer
    inputs: Dict[str, torch.Tensor]      # views of packed
    blank: np.ndarray                    # int32 host image, padding
    spans: Dict[str, Tuple[int, int, Tuple[int, ...], np.dtype]]
    logits: Optional[torch.Tensor] = None    # outputs of the last launch
    sampled: Optional[torch.Tensor] = None
    aux: Optional[tuple] = None              # logprobs variant only
    graph: Optional["torch.cuda.CUDAGraph"] = None
    counts: List[Dict[str, int]] = field(default_factory=list)

    @property
    def key(self) -> Tuple[int, int, int, bool]:
        return self.B, self.T, self.P, self.paged

    def host_inputs(self) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """A fresh host image of the inputs (padding rows) and numpy
        views of it by name, to fill and pass to :meth:`PrefillGraphs.run`."""
        return _host_image(self.blank, self.spans)


def _host_image(blank: np.ndarray, spans) -> Tuple[np.ndarray,
                                                   Dict[str, np.ndarray]]:
    img = blank.copy()
    return img, {name: img[a:b].view(dt).reshape(shape)
                 for name, (a, b, shape, dt) in spans.items()}


class _PackedGraphs(_GraphSet):
    """A graph set whose inputs are one packed int32 device buffer per
    bucket (``_fields`` lists them for a key), so that a dispatch is one
    upload of a filled host image and one launch."""

    def __init__(self, device, fence=None, share=None):
        super().__init__(device, fence, share)
        self._layouts: Dict[tuple, tuple] = {}

    def _fields(self, key: tuple) -> list:
        raise NotImplementedError

    def _layout(self, key: tuple):
        """(spans, blank) of a bucket's packed inputs: each input's word
        range, shape and dtype, and the host image of padding rows (a
        launch over them writes nothing to the pool)."""
        if key not in self._layouts:
            spans, words = {}, 0
            for name, shape, dt, _ in self._fields(key):
                n = int(np.prod(shape)) * dt.itemsize // 4
                spans[name] = (words, words + n, shape, dt)
                words += n
            blank = np.zeros(words, np.int32)
            for name, _, dt, value in self._fields(key):
                a, b = spans[name][:2]
                blank[a:b].view(dt)[:] = value
            self._layouts[key] = spans, blank
        return self._layouts[key]

    def host_inputs(self, *key) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """A fresh host image of bucket ``key``'s inputs (padding rows)
        and numpy views of it by name, without making the bucket: a
        tensor-parallel rank 0 fills and sends the image before any rank
        captures a missing bucket."""
        spans, blank = self._layout(key)
        return _host_image(blank, spans)

    def _packed(self, key: tuple):
        """(packed device buffer of padding rows, its views by name,
        blank, spans) for a new bucket."""
        spans, blank = self._layout(key)
        packed = torch.from_numpy(blank.copy()).to(self.device)
        inputs = {name: packed[a:b].view(_TORCH_DTYPES[dt]).view(shape)
                  for name, (a, b, shape, dt) in spans.items()}
        return packed, inputs, blank, spans

    def run(self, bk, img: np.ndarray) -> None:
        """Upload a filled host image (:meth:`host_inputs`) into the
        bucket's buffer and launch it."""
        upload(bk.packed, img)
        self.launch(bk)


class PrefillGraphs(_PackedGraphs):
    """One prefill chunk and its first-token draw per (B, T, P, paged)
    bucket of one variant (with ``logprobs_topn`` > 0 the draw's logprobs
    too): captured CUDA graphs on the card, direct calls on the CPU
    (module docstring). Built over ``share``'s stream and pool."""

    kind = "prefill chunk"

    def __init__(self, prefill_fn: Callable, params, kv_k: torch.Tensor,
                 kv_v: torch.Tensor, *, page_size: int, num_pages: int,
                 max_top_k: int, logprobs_topn: int = 0,
                 fence: Optional[CompileFence] = None,
                 share: Optional[_GraphSet] = None):
        super().__init__(kv_k.device, fence, share)
        self.prefill_fn = prefill_fn
        self.params = params
        self.kv_k, self.kv_v = kv_k, kv_v
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_top_k = max_top_k
        self.logprobs_topn = logprobs_topn
        self.variant = variant_name(logprobs_topn)

    def _form(self, key: tuple) -> str:
        B, T, P, paged = key
        extra = "" if self.variant == "plain" else f", {self.variant}"
        return (f"prefill chunk (B={B}, T={T}, P={P}, "
                f"{'page commit' if paged else 'row scatter'}{extra})")

    def _fields(self, key: tuple) -> list:
        B, T, P, _ = key
        return _prefill_layout(B, T, P, max(T // self.page_size, 1),
                               DROP_SLOT, self.num_pages)

    def _new_bucket(self, B: int, T: int, P: int,
                    paged: bool) -> PrefillBucket:
        """Buffers holding padding rows: a launch over them writes nothing
        to the pool."""
        packed, inputs, blank, spans = self._packed((B, T, P, paged))
        return PrefillBucket(B=B, T=T, P=P, paged=paged, packed=packed,
                             inputs=inputs, blank=blank, spans=spans)

    def _call(self, bk: PrefillBucket) -> None:
        """The chunk on the bucket's static inputs, then the first-token
        draw from its logits; outputs into the bucket."""
        f = bk.inputs
        bk.logits, _, _ = self.prefill_fn(
            self.params, f["tokens"], f["positions"], self.kv_k, self.kv_v,
            f["table"], f["slots"], f["last_idx"],
            f["pslots"] if bk.paged else None)
        bk.sampled = sample_tokens(
            bk.logits, f["temperature"], f["top_k"], f["top_p"], f["seeds"],
            f["steps"], max_top_k=self.max_top_k)
        if self.logprobs_topn:
            bk.aux = logprob_aux(bk.logits, bk.sampled, self.logprobs_topn)


# ------------------------------------------- the synchronous decode arms


@dataclass(eq=False)
class PackedBucket:
    """Static buffers of one (B, P) bucket of a :class:`StepGraphs` or
    :class:`VerifyGraphs` set: ``packed`` holds every input (``inputs``
    are views of it by name), ``out`` the outputs of the last launch."""

    B: int
    P: int
    packed: torch.Tensor
    inputs: Dict[str, torch.Tensor]
    blank: np.ndarray
    spans: Dict[str, Tuple[int, int, Tuple[int, ...], np.dtype]]
    pen: Optional[tuple] = None     # penalised variants: PenaltyBuffers views
    out: tuple = ()
    graph: Optional["torch.cuda.CUDAGraph"] = None
    counts: List[Dict[str, int]] = field(default_factory=list)

    @property
    def key(self) -> Tuple[int, int]:
        return self.B, self.P


class StepGraphs(_PackedGraphs):
    """One decode step (one forward and one draw) per (B, P) bucket of
    one variant, the window's variants (logprobs width, penalty form):
    out = (sampled [B]) or, with logprobs, (sampled, lp [B], top_vals
    [B, n], top_ids [B, n])."""

    kind = "decode step"

    def __init__(self, decode_fn: Callable, params, kv_k: torch.Tensor,
                 kv_v: torch.Tensor, *, max_top_k: int,
                 logprobs_topn: int = 0, penalty_form: int = PEN_NONE,
                 penalty_buffers: Optional[PenaltyBuffers] = None,
                 fence: Optional[CompileFence] = None,
                 share: Optional[_GraphSet] = None):
        super().__init__(kv_k.device, fence, share)
        if penalty_form != PEN_NONE and penalty_buffers is None:
            raise ValueError("a penalised variant needs PenaltyBuffers")
        self.decode_fn = decode_fn
        self.params = params
        self.kv_k, self.kv_v = kv_k, kv_v
        self.max_top_k = max_top_k
        self.logprobs_topn = logprobs_topn
        self.penalty_form = penalty_form
        self.penalty_buffers = penalty_buffers
        self.variant = variant_name(logprobs_topn, penalty_form)

    def _form(self, key: tuple) -> str:
        extra = "" if self.variant == "plain" else f", {self.variant}"
        return f"decode step (B={key[0]}, P={key[1]}{extra})"

    def _fields(self, key: tuple) -> list:
        B, P = key
        i32, f32 = np.dtype(np.int32), np.dtype(np.float32)
        return [("seeds", (B,), np.dtype(np.int64), 0),
                ("temperature", (B,), f32, 0.0), ("top_p", (B,), f32, 1.0),
                ("top_k", (B,), i32, 0), ("steps", (B,), i32, 0),
                ("tokens", (B,), i32, 0), ("positions", (B,), i32, -1),
                ("slots", (B,), i32, DROP_SLOT), ("table", (B, P), i32, 0)]

    def _new_bucket(self, B: int, P: int) -> PackedBucket:
        packed, inputs, blank, spans = self._packed((B, P))
        return PackedBucket(
            B=B, P=P, packed=packed, inputs=inputs, blank=blank, spans=spans,
            pen=(self.penalty_buffers.penalties(B)
                 if self.penalty_form != PEN_NONE else None))

    def _call(self, bk: PackedBucket) -> None:
        f = bk.inputs
        logits, _, _ = self.decode_fn(
            self.params, f["tokens"], f["positions"], self.kv_k, self.kv_v,
            f["table"], f["slots"])
        sampled = sample_tokens(logits, f["temperature"], f["top_k"],
                                f["top_p"], f["seeds"], f["steps"],
                                max_top_k=self.max_top_k, penalties=bk.pen)
        bk.out = (sampled,) + (
            logprob_aux(logits, sampled, self.logprobs_topn)
            if self.logprobs_topn else ())


class VerifyGraphs(_PackedGraphs):
    """The verify forward of ``spec_tokens`` = K drafts and its accept
    mask per (B, P) bucket: out = (tokens [B, K+1], accepted [B])."""

    kind = "spec verify"
    variant = "plain"

    def __init__(self, verify_fn: Callable, params, kv_k: torch.Tensor,
                 kv_v: torch.Tensor, *, spec_tokens: int,
                 fence: Optional[CompileFence] = None,
                 share: Optional[_GraphSet] = None):
        super().__init__(kv_k.device, fence, share)
        self.verify_fn = verify_fn
        self.params = params
        self.kv_k, self.kv_v = kv_k, kv_v
        self.spec_tokens = spec_tokens

    def _form(self, key: tuple) -> str:
        return (f"spec verify (B={key[0]}, P={key[1]}, "
                f"K={self.spec_tokens})")

    def _fields(self, key: tuple) -> list:
        B, P = key
        K, i32 = self.spec_tokens, np.dtype(np.int32)
        return [("tokens", (B, K + 1), i32, 0),
                ("positions", (B, K + 1), i32, -1),
                ("slots", (B, K + 1), i32, DROP_SLOT),
                ("table", (B, P), i32, 0), ("draft", (B, K), i32, 0),
                ("draft_len", (B,), i32, 0)]

    def _new_bucket(self, B: int, P: int) -> PackedBucket:
        packed, inputs, blank, spans = self._packed((B, P))
        return PackedBucket(B=B, P=P, packed=packed, inputs=inputs,
                            blank=blank, spans=spans)

    def _call(self, bk: PackedBucket) -> None:
        f = bk.inputs
        logits, _, _ = self.verify_fn(
            self.params, f["tokens"], f["positions"], self.kv_k, self.kv_v,
            f["table"], f["slots"])
        bk.out = verify_greedy_draft(logits, f["draft"], f["draft_len"])
