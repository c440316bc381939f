"""The PyTorch serving engine: continuous batching over a paged KV cache.

The counterpart of ``dynamo_tpu/engine/jax_engine.py`` ``JaxEngine``,
for every model family the port has (``models/registry.py``: the Llama
family and its MoE in ``models/llama.py``, MLA and DeepSeek's MoE in
``models/mla.py``), speaking the same token-level protocol
(``PreprocessedRequest`` in, ``EngineOutput`` chunks out) so it slots
behind ``Backend`` the same way:

- one asyncio scheduler loop owns the device; each iteration runs on a
  single worker thread: a chunked prefill over a batch of prompts
  (prefill priority) or — once nothing is left to prefill — a fused
  K-step decode window over every running sequence, then admission
  (``admit_in_step``). The JAX engine's other arms as it has them
  (``_step``): ``prefill_token_budget`` dispatches a window AND a prefill
  batch trimmed to about that many prompt tokens every iteration
  (budgeted mixing, counted in ``mixed_dispatches``; ``prefill_priority
  =False`` the same untrimmed); ``decode_steps=1`` decodes one token a
  dispatch, synchronously (``_decode_step_single``); ``spec_decode``
  verifies prompt-lookup drafts (``engine/spec_decode.py``) of greedy
  rows in one [B, K+1] forward a step, the other rows taking a window
  or a single step seeded from host state (``_step_spec``);
- decode windows are pipelined (``pipeline_decode``, the JAX default):
  window N+1 is dispatched before window N is read back, and rows
  carried over take their state from window N's device carry
  (:func:`_merge_carry`), so the host's bookkeeping overlaps the device;
  pages of a row that finished in window N are released only once no
  window in flight holds the row (``_release_or_defer``);
- each decode window is one replay of a CUDA graph captured for its
  (batch, page) bucket, and each prefill chunk, its first-token draw
  included, one replay of the graph of its (batch, chunk length, page)
  bucket (``engine/cuda_graphs.py``), a single decode step and a verify
  step (with its accept mask) each one replay of its (batch, page)
  bucket's graph, in the variant the batch needs
  (one graph set per variant, the JAX window's static arguments): the
  logprobs width (0, or ``max_top_logprobs`` when a row asks for
  logprobs) and, for decode, the penalty form (none, or the penalty
  tuple when a row sets a penalty or ``logit_bias``); ``warmup()``
  captures the plain grids, the logprobs variants (``warmup_logprobs``)
  and the penalised one (``warmup_penalties``), then arms the capture
  fence
  (``engine/jit_fence.py``), which counts any later capture in
  ``stats()["post_warmup_compiles_total"]``;
- the OpenAI sampling surface as the JAX engine serves it: logprobs of
  the raw logits (``_lp_entry``) on every emitting path, and repetition,
  frequency and presence penalties and ``logit_bias`` inside the
  windows (``engine/sampling.py``), over one set of shared device
  buffers (``cuda_graphs.PenaltyBuffers``): logit_bias goes up as its
  sparse entries, and the penalty state is rebuilt on the device from
  the host token lists before each dispatch with a count-driven penalty,
  so such a batch lands the in-flight window first (the pipelining
  barrier); a penalised first-token draw samples from the prefill
  graph's logits over the same buffers, eagerly;
- the host never waits on the device except to read back a window's or
  a prefill's sampled tokens, on that dispatch's own event: uploads go
  through pinned staging memory with ``non_blocking`` copies;
- the JAX engine's instruments, under its names in ``stats()``: the
  latency recorder (``runtime/slo.py``; queue wait at admission, TTFT
  and ITL at emission, e2e at the finish) as ``latency_hist``, and the
  sampled dispatch profiler (``engine/profiler.py``; off at the default
  ``prof_sample=0``) as ``bucket_cost``, ``device_time_fraction`` and
  ``profiled_steps_total``;
- the JAX engine's operator hooks, under its names: a step timeline
  (``DYN_STEP_TIMELINE``; admissions, chunks, windows, sampled
  dispatches, captures after warmup) registered for ``/v1/traces``, the
  cache view :meth:`cache_snapshot` registered for ``/debug/cache``, the
  engine as a stats source of the flight recorder, the event loop's lag
  monitor and stall watchdog for as long as the engine runs
  (``loop_lag_p50_seconds`` / ``loop_lag_p99_seconds`` in ``stats()``),
  :meth:`drain`, and per-request cost attribution: each dispatch shares
  one step across its rows (``_account_dispatch``), so the finished
  requests' ``device_step_share`` sums to ``batch_dispatches_total``,
  and each finish carries its ``cost`` block, also recorded for
  ``/v1/traces/{request_id}``;
- per-request state is host-side (token lists, page tables from
  ``PageManager``); the device sees only padded arrays;
- sequences preempt (release pages, requeue) when the pool runs dry,
  after the pipeline is flushed;
- the host KV tier (``host_pages > 0``, ``engine/kv_tier.py``): pages
  evicted from the pool move to pinned host pools, int8 by default
  (``host_tier_int8``), and come back on a prefix hit. The page
  manager queues the copies; ``_drain_kv_tier`` runs them on the
  engine's stream before each step's dispatches (and after a decode
  batch's evictions), in place in the pools the graphs were captured
  on: offloads without a host wait, restores at most
  ``tier_restore_chunk`` pages an iteration, overlapped with the next
  step under ``restore_overlap``, their sequences gated out of prefill
  until their pages have landed. Not at ``tp > 1``;
- tensor parallel (``mesh``, a ``parallel/mesh.py`` ``MeshView`` of
  ``model=N``): every rank holds its Megatron shard of the params and
  the pool and captures the same graphs in the same order at warmup.
  Rank 0 owns what the JAX single controller owns (the scheduler,
  ``PageManager``, the pipeline, and the HTTP front end around it);
  before each dispatch it sends the followers (ranks > 0, :meth:`follow`)
  the dispatch's bucket key and every host input it uploads, packed as
  one int32 message over the gloo control group, so each follower makes
  the same uploads and replays the same graph on its own shard, and the
  collectives inside the graphs pair up. A bucket missing after warmup
  is announced like any dispatch, so every rank captures it (and counts
  it in ``post_warmup_compiles_total``). A follower keeps its own device
  carry, which equals rank 0's: every rank samples the same tokens from
  the same gathered logits.

The disaggregation plane (``jax_engine.py`` ``reserve_remote`` ...
``submit_prefilled``): a prefill worker's engine runs prompts with
:meth:`prefill_only` and hands their pages out through
:meth:`extract_pages` / :meth:`extract_pages_chunked`; a decode engine
reserves pages for a remote prompt (:meth:`reserve_remote`), takes the
shipped pages in with :meth:`inject_pages`, written in place into the
pool the graphs were captured on, and decodes on with
:meth:`submit_prefilled`. Page copies run on the executor and the
engine's stream, ordered with the dispatches around them; the
``PageManager`` calls they make take ``_pm_lock``. Not at ``tp > 1``
(each rank holds only its heads of the pool), and not on an MLA model:
the transfer frame carries one page shape for K and V, and MLA's two
pools differ in width (ROADMAP.md note E).

A model module without a fused window of its own (MLA) decodes through
the generic window :func:`_make_decode_multi`, K full forwards with
per-step pool writes, captured as any window is; with ``spec_decode`` and
no verify forward the engine warns and keeps the standard path, as the
JAX engine does.

Not ported yet: long-prompt ring prefill.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import AsyncIterator, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..llm.protocols.common import (FINISH_CANCELLED, FINISH_EOS,
                                    FINISH_LENGTH, FINISH_TIMEOUT,
                                    EngineOutput, PreprocessedRequest)
from ..models.config import ModelConfig
from ..models.llama import (DROP_SLOT, KVCacheSpec, carry_active,
                            carry_step_update, project_logits)
from ..models.quant import QUANT_KEYS, quantize_int8, quantize_params
from ..models.registry import get_model_module
from ..parallel.mesh import MeshView, quantize_shard, shard_param
from ..runtime import blackbox, guard, profiling, tracing
from ..runtime.config import env_bool, env_int, env_str
from ..runtime.device import resolve_device
from ..runtime.engine import Context
from ..runtime.slo import LatencyRecorder
from .cuda_graphs import (PEN_FULL, PEN_NONE, DecodeGraphs,
                          PenaltyBuffers, PrefillGraphs, StepGraphs,
                          VerifyGraphs, to_device, to_host, upload)
from .jit_fence import CompileFence
from .kv_manager import ChainHashCache, PageManager
from .kv_tier import HostTier, Offload
from .profiler import EngineProfiler, memory_snapshot
from .sampling import SamplingBatch, logprob_aux, sample_tokens
from .spec_decode import propose_ngram_draft

log = logging.getLogger("dynamo_tpu_torch.engine")

# tensor parallel: rank 0's messages to the followers, each an int64
# header [kind, payload words, bucket key, variant and flags ...] then,
# when it has one, an int32 payload (engine docstring): a prefill chunk,
# a decode window, a single decode step, a verify step
_STOP, _PREFILL, _DECODE, _STEP, _VERIFY = 0, 1, 2, 3, 4
_HEADER_WORDS = 13


def _cancel_reason(ctx: Context) -> str:
    return FINISH_TIMEOUT if ctx.expired else FINISH_CANCELLED


def _wants_count_state(s) -> bool:
    """True when the row needs ACCURATE token counts (the three
    count-driven penalties): these force the pipelining barrier.
    logit_bias is static per request and needs neither counts nor the
    barrier."""
    return bool((getattr(s, "repetition_penalty", None) or 1.0) != 1.0
                or getattr(s, "frequency_penalty", None)
                or getattr(s, "presence_penalty", None))


@dataclass
class EngineConfig:
    """A copy of the JAX engine's EngineConfig fields this engine reads
    (same names, defaults and bucket rules)."""

    page_size: int = 64
    num_pages: int = 512
    max_batch: int = 64
    prefill_chunk: int = 512
    max_top_k: int = 64
    max_prefill_batch: int = 8  # prompts packed per prefill dispatch
    # fused decode window: K decode+sample steps per dispatch, stop
    # conditions on device; 1 decodes one token a dispatch, synchronously
    decode_steps: int = 4
    # pipelined dispatch: window N+1 (and the next prefill batch) are
    # enqueued BEFORE window N's tokens are read back; the device-side
    # carry makes this exact, not speculative
    pipeline_decode: bool = True
    # iterations whose prefill sweep dispatched nothing (every candidate
    # cancelled or cache-covered) dispatch a decode window instead of
    # idling the device
    overlap_idle_prefill: bool = True
    # prefill priority: iterations with prompts to prefill skip the
    # decode window (False: a window every iteration beside the prefill)
    prefill_priority: bool = True
    # budgeted mixing: every iteration dispatches a decode window AND a
    # prefill batch trimmed to about this many prompt tokens (the head
    # always ships), so a burst of long prompts cannot starve running
    # decodes; None keeps prefill priority. Overrides prefill_priority
    prefill_token_budget: Optional[int] = None
    # self-speculative decoding: a host prompt-lookup drafter proposes up
    # to spec_tokens tokens a greedy row, ONE [B, spec_tokens + 1] verify
    # forward checks them, the longest matching prefix plus a bonus token
    # is kept; the decode arm then runs synchronously. Sampled, penalised,
    # logit_bias and logprobs rows bypass speculation
    spec_decode: bool = False
    spec_tokens: int = 4      # K: drafts verified a step at most
    spec_ngram_max: int = 4   # longest suffix n-gram the drafter matches
    spec_ngram_min: int = 1   # shortest n-gram worth matching
    # emit each row of a window as one EngineOutput from the device's
    # emitted count (one wakeup a row-window, one bulk page commit); False
    # emits token by token with the host's stop checks, as rows whose
    # stop ids overflow the device table always do
    coalesce_window_emissions: bool = True
    # reuse the uploaded sampler params / page table / stop table while
    # the batch composition is unchanged (freezes the build-time seeds of
    # unseeded sampled rows for the cached span, as in the JAX engine)
    cache_sampler_params: bool = True
    # admission runs inside the step, after the dispatches, so its host
    # work overlaps the window in flight
    admit_in_step: bool = True
    # on-device stop table width (eos + stop ids, -1 padded); rows with
    # more ids fall back to the per-token host check
    max_eos_ids: int = 8
    # sampled dispatch profiling: every Nth scheduler iteration times its
    # dispatches, host and device apart, with one deliberate device sync
    # each (engine/profiler.py); 0 disables (default)
    prof_sample: int = 0
    # top-N alternatives returned per token when a request asks for
    # logprobs (OpenAI's cap of 20): ONE width, so every logprobs request
    # shares a graph variant (the requested count is sliced on the host)
    max_top_logprobs: int = 20
    # capture the logprobs variants at warmup (any OpenAI client can ask
    # for logprobs, so an unwarmed variant is routinely reachable)
    warmup_logprobs: bool = True
    # capture the penalised variants too (off by default: most
    # deployments never send penalties, and a first penalty request pays
    # one fenced capture per bucket)
    warmup_penalties: bool = False
    # host KV tier: pages evicted from the device pool move to pinned
    # host memory and restore on a prefix hit; 0 disables the tier
    host_pages: int = 0
    # at most this many host-to-device page restores a scheduler
    # iteration, so one long host hit cannot stall every other request's
    # step; gated sequences wait in prefilling. 0 = unlimited
    tier_restore_chunk: int = 32
    # int8 host tier (engine/kv_compress.py): pages are quantized on the
    # device before the device-to-host copy and dequantized on the device
    # after the copy back, so the link moves about half the bytes. Lossy.
    # None = on whenever the tier is, unless DYN_HOST_TIER_FP16 is set;
    # an explicit True/False wins
    host_tier_int8: Optional[bool] = None
    # eviction policy of both tiers: "cost" (GreedyDual over the
    # hot-prefix hit table) or "lru"; None reads DYN_EVICT_POLICY
    evict_policy: Optional[str] = None
    # overlapped restores: a drained batch's host-to-device copy and
    # dequantize are enqueued on one drain and its inject lands on the
    # next, overlapping the step between; False injects in the same
    # drain. None reads DYN_RESTORE_OVERLAP
    restore_overlap: Optional[bool] = None
    # bucketing: padded shapes, as the JAX engine pads them; warmup()
    # captures one decode graph per (batch, page) bucket and one prefill
    # graph per (prefill batch, chunk length, page) bucket
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)
    prefill_buckets: Tuple[int, ...] = (16, 64, 512)
    page_buckets: Tuple[int, ...] = (8, 64)
    watermark_pages: int = 4  # keep-free headroom before admitting

    def __post_init__(self) -> None:
        if self.prefill_chunk % self.page_size != 0:
            raise ValueError(
                f"prefill_chunk ({self.prefill_chunk}) must be a multiple "
                f"of page_size ({self.page_size}): chunk starts must stay "
                f"page-aligned for the page-granular KV commit")
        if self.spec_decode and self.spec_tokens < 1:
            raise ValueError(
                f"spec_tokens ({self.spec_tokens}) must be >= 1 when "
                f"spec_decode is enabled")

    @staticmethod
    def _pick(buckets: Tuple[int, ...], n: int) -> int:
        for b in buckets:
            if n <= b:
                return b
        b = buckets[-1]
        while b < n:
            b *= 2
        return b

    def bucket_batch(self, n: int) -> int:
        return min(self._pick(self.batch_buckets, n), self.max_batch)

    def prefill_bucket_batch(self, n: int) -> int:
        small = self.bucket_batch(1)
        return small if n <= small else self.bucket_batch(
            self.max_prefill_batch)

    def bucket_len(self, n: int) -> int:
        return min(self._pick(self.prefill_buckets, n), self.prefill_chunk)

    def bucket_pages(self, n: int) -> int:
        return self._pick(self.page_buckets, n)

    def warmed_grid(self) -> dict:
        """The exact images of the bucket helpers over every admissible
        serving input (enumerated, since ``_pick`` doubles past its last
        bucket): the shapes warmup() runs, and the decode (batch, page)
        buckets it captures, so serving never captures."""
        cap_pages = min(self.page_buckets[-1], max(self.num_pages - 1, 1))
        return {
            "prefill_lens": sorted({
                self.bucket_len(n)
                for n in range(1, self.prefill_chunk + 1)}),
            "decode_batches": sorted({
                self.bucket_batch(n)
                for n in range(1, self.max_batch + 1)}),
            "prefill_batches": sorted({
                self.prefill_bucket_batch(n)
                for n in range(1, max(self.max_prefill_batch,
                                      self.max_batch) + 1)}),
            "page_buckets": sorted({
                self.bucket_pages(n) for n in range(1, cap_pages + 1)}),
        }


@dataclass(eq=False)  # identity semantics: `in`/`==` must never deep-compare
class Sequence:
    req: PreprocessedRequest
    context: Context
    out: asyncio.Queue
    tokens: List[int]            # prompt + generated (host truth)
    num_prompt: int
    pages: List[int] = field(default_factory=list)
    computed: int = 0            # positions already in the KV cache
    generated: int = 0
    finished: Optional[str] = None
    finish_emitted: bool = False
    last_token: int = 0          # next decode input
    arrival: float = field(default_factory=time.monotonic)
    queue_wait_s: float = 0.0    # arrival → admission
    last_emit_t: Optional[float] = None  # last token-bearing emission
    # cost attribution: the occupancy-weighted share of the dispatches the
    # row rode (each dispatch shares 1.0 across its rows), their count,
    # the most pages the row held, and its admission's prefix split
    dispatch_share: float = 0.0
    dispatches: int = 0
    max_pages: int = 0
    prefix_hit: int = 0
    device_hit_blocks: int = 0
    host_restored_blocks: int = 0
    # host-tier restores: admission stamp while the row's restores are
    # queued, then admission -> the prefill sweep that found them landed
    restore_t0: Optional[float] = None
    restore_wait_s: float = 0.0
    hash_cache: Optional[ChainHashCache] = None
    # disagg prefill-only: the finish leaves the pages allocated for the
    # caller to extract, then release (release_pages)
    hold_pages: bool = False
    # the request's eos/stop ids are fixed: built once, on first use (the
    # per-token append and the per-window row check read them)
    _stop_set: Optional[frozenset] = field(default=None, repr=False)
    _stop_ids: Optional[List[int]] = field(default=None, repr=False)
    # the request's logit_bias entries (token ids, values), built on
    # first use
    _bias: Optional[Tuple[np.ndarray, np.ndarray]] = field(default=None,
                                                           repr=False)

    @property
    def stop_set(self) -> frozenset:
        if self._stop_set is None:
            stop = self.req.stop
            eos = () if stop.ignore_eos else (self.req.eos_token_ids or ())
            self._stop_set = (frozenset(eos)
                              | frozenset(stop.stop_token_ids or ()))
        return self._stop_set

    @property
    def stop_ids(self) -> List[int]:
        """The device stop-table row (duplicates kept, as the JAX engine
        seeds it)."""
        if self._stop_ids is None:
            ids: List[int] = []
            if not self.req.stop.ignore_eos:
                ids.extend(self.req.eos_token_ids or [])
            ids.extend(self.req.stop.stop_token_ids or [])
            self._stop_ids = ids
        return self._stop_ids

    def max_new(self) -> int:
        mt = self.req.stop.max_tokens
        return mt if mt is not None else 1 << 30

    @property
    def prefill_extent(self) -> int:
        """Tokens whose KV must exist before decode can run: the whole
        prompt, or, resumed after preemption, everything except the final
        token (the next decode input)."""
        return self.num_prompt if self.generated == 0 else len(self.tokens) - 1


@dataclass
class _PendingWindow:
    """A dispatched-but-unread decode window. ``host`` holds pinned copies
    of (toks [B, K], emitted [B], done [B]) and, in a logprobs variant,
    of its aux (lp [B, K], top_vals [B, K, n], top_ids [B, K, n]), valid
    once ``event`` has completed; ``carry`` is the window's device carry
    (the engine's carry stash: valid until the next window's launch)."""

    batch: List[Sequence]
    host: List[torch.Tensor]
    event: Optional[torch.cuda.Event]
    carry: tuple                    # (tok, pos, done, steps, remaining)
    index: Dict[int, int] = field(default_factory=dict)  # id(seq) → row
    # the window's bucket: (B, P, logprobs_topn, form)
    key: Tuple[int, int, int, int] = (0, 0, 0, 0)
    processed: bool = False


@dataclass
class _PendingPrefill:
    """A dispatched-but-unread prefill batch: ``sampled`` is the pinned
    host copy of the first-token draw for rows that completed their
    prompt this chunk (None when no row drew), ``aux`` that of its
    logprobs (lp [B], top_vals [B, n], top_ids [B, n]) when a row asked,
    valid after ``event``."""

    finishing: List[Tuple[int, Sequence]]
    sampled: Optional[torch.Tensor]
    event: Optional[torch.cuda.Event] = None
    aux: Optional[List[torch.Tensor]] = None
    processed: bool = False


def _merge_carry(c_tok, c_pos, c_done, c_steps, c_rem, src, from_carry,
                 n_tok, n_pos, n_steps, n_rem, out: Optional[tuple] = None):
    """Stitch window N+1's inputs (``_merge_carry`` of the JAX engine):
    rows continuing from the in-flight window gather their state from its
    device carry (``src`` indexes into the previous batch); fresh rows
    take the host-provided values. A few fixed-shape ops, no host sync;
    ``out`` (five tensors) receives the result in place."""
    out = out or (None,) * 5
    src = src.long().clamp(0, c_tok.shape[0] - 1)
    fc = from_carry.to(torch.bool)
    tok = torch.where(fc, c_tok[src], n_tok, out=out[0])
    pos = torch.where(fc, c_pos[src], n_pos, out=out[1])
    done = torch.logical_and(fc, c_done[src], out=out[2])
    steps = torch.where(fc, c_steps[src], n_steps, out=out[3])
    rem = torch.where(fc, c_rem[src], n_rem, out=out[4])
    return tok, pos, done, steps, rem


def _pack_sampler(samp: tuple) -> np.ndarray:
    """The decode bucket's sampler uploads (table, eos, temperature,
    top_k, top_p, seeds, then for a penalised variant rep, freq, pres
    and the logit_bias entries) as one int32 array, for the followers."""
    return np.concatenate([np.ascontiguousarray(a).reshape(-1).view(np.int32)
                           for a in samp])


def _penalty_layout(B: int, NB: int) -> list:
    """The penalty arguments' arrays (rep, freq, pres, the logit_bias
    entries' (row, id) pairs and values), NB = the logit_bias entries."""
    f32 = np.float32
    return [((B,), f32), ((B,), f32), ((B,), f32), ((2, NB), np.int32),
            ((NB,), f32)]


def _sampler_layout(B: int, P: int, E: int, form: int, NB: int) -> list:
    """:func:`_pack_sampler`'s arrays, NB = the logit_bias entries."""
    f32 = np.float32
    layout = [((B, P), np.int32), ((B, E), np.int32), ((B,), f32),
              ((B,), np.int32), ((B,), f32), ((B,), np.int64)]
    if form != PEN_NONE:
        layout += _penalty_layout(B, NB)
    return layout


def _unpack_sampler(words: np.ndarray, layout: list) -> Tuple[tuple, int]:
    """(the arrays of ``layout`` packed at the start of ``words``, the
    words they take)."""
    out, at = [], 0
    for shape, dt in layout:
        n = int(np.prod(shape)) * np.dtype(dt).itemsize // 4
        # a copy, so the int64 field starts on an 8-byte boundary
        out.append(words[at:at + n].copy().view(dt).reshape(shape))
        at += n
    return tuple(out), at


class TorchEngine:
    """AsyncEngine over the PyTorch model (token-level core engine)."""

    def __init__(self, model_cfg: ModelConfig,
                 engine_cfg: Optional[EngineConfig] = None, params=None,
                 seed: int = 0, device="cuda",
                 mesh: Optional[MeshView] = None,
                 quant: Optional[str] = None,
                 worker_label: Optional[str] = None):
        """``mesh``: the rank's view of a tensor-parallel mesh
        (``parallel/mesh.py MeshSpec.build``); the engine then runs on the
        mesh's device, and ``params``, when given, are the rank's shard
        (``models/bridge.py params_from_numpy(rank=, size=)``). Random
        params are drawn whole, one param at a time, and cut to the
        rank's shard, so every tensor-parallel size serves the weights of
        the same seed. ``quant="int8"``: weight-only int8 serving
        (``models/quant.py``; ``jax_engine.py`` ``quant``): given params
        are quantized (a rank's shard to the scales of the whole weight,
        ``parallel/mesh.py quantize_shard``), and random params are
        quantized as each is drawn, whole, then cut (the JAX package's
        ``host_init_quantized``), so the bfloat16 tree never exists whole
        on the card. ``worker_label``: a stable label of this engine
        (a replica's name), carried by ``stats()``. The model module is
        the registry's (``models/registry.py``)."""
        model = get_model_module(model_cfg)
        if quant not in (None, "int8"):
            raise ValueError(f"unknown quant mode {quant!r} (expected "
                             f"'int8')")
        int8 = quant == "int8"

        def keep(name, t):
            if int8 and name in QUANT_KEYS:
                t = quantize_int8(t)
            if mesh is not None:
                t = shard_param(name, t, model_cfg, mesh)
            return t

        ecfg = engine_cfg or EngineConfig()
        if mesh is not None:
            if mesh.data > 1:
                raise NotImplementedError(
                    "the data axis inside one engine is not ported yet")
            if mesh.size > 1 and ecfg.host_pages > 0:
                raise NotImplementedError(
                    "the host KV tier at tp > 1 (ROADMAP.md queue 1 item "
                    "11): each rank holds only its heads of the pool, and "
                    "no dispatch kind carries the tier's copies to the "
                    "followers")
            device = mesh.device
        self.mesh = mesh
        self.worker_label = worker_label or ""
        self.mesh_devices = mesh.size if mesh is not None else 1
        self.mesh_shape = mesh.shape if mesh is not None else "single"
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.ecfg = ecfg
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = model.init_params(model_cfg, gen, shard=keep)
        elif int8:
            params = quantize_params(params, quantize=(
                None if mesh is None else lambda name, w: quantize_shard(
                    name, w, model_cfg, mesh)))
        self.quant = quant
        self.params = params
        if self.device.type == "cuda":
            # a random draw holds a whole param in float32 at a time (and
            # a loader its tensors): hand those blocks back to the card,
            # where ranks that share it would otherwise find them cached
            torch.cuda.empty_cache()
        spec = KVCacheSpec(self.ecfg.num_pages, self.ecfg.page_size)
        self.model = model
        self.kv_k, self.kv_v = model.init_kv_cache(
            model_cfg, spec, device=self.device, mesh=mesh)
        self.prefill_fn, self.decode_fn = model.make_step_fns(model_cfg,
                                                              mesh=mesh)
        if hasattr(model, "make_decode_window_fn"):
            # the module's fused window (read-only pool + window buffer)
            self.decode_multi_fn = model.make_decode_window_fn(
                model_cfg, max_top_k=self.ecfg.max_top_k, mesh=mesh)
        else:
            self.decode_multi_fn = _make_decode_multi(
                model, model_cfg, self.ecfg.max_top_k, mesh=mesh)
        self.verify_fn = None
        if self.ecfg.spec_decode:
            if hasattr(model, "make_verify_fn"):
                self.verify_fn = model.make_verify_fn(model_cfg, mesh=mesh)
            else:
                log.warning("spec_decode enabled but %s has no "
                            "make_verify_fn; speculation disabled",
                            model.__name__)
        # capture fence (armed by warmup) and the graphs per bucket, one
        # set per variant: decode windows, and prefill chunks, all on the
        # plain decode set's stream and pool
        # the step timeline: a bounded ring of scheduler events served by
        # /v1/traces (DYN_STEP_TIMELINE; 0 disables it)
        self.step_timeline = tracing.StepTimeline(
            env_int("DYN_STEP_TIMELINE") or 0)
        tracing.register_timeline(f"torch-engine-{id(self):x}",
                                  self.step_timeline)
        self.fence = CompileFence(f"torch-engine-{id(self):x}",
                                  timeline=self.step_timeline)
        self.graphs = DecodeGraphs(
            self.decode_multi_fn, self.params, self.kv_k, self.kv_v,
            k_steps=self.ecfg.decode_steps, max_eos_ids=self.ecfg.max_eos_ids,
            fence=self.fence)
        self.prefill_graphs = PrefillGraphs(
            self.prefill_fn, self.params, self.kv_k, self.kv_v,
            page_size=self.ecfg.page_size, num_pages=self.ecfg.num_pages,
            max_top_k=self.ecfg.max_top_k, fence=self.fence,
            share=self.graphs)
        # (logprobs_topn, penalty form) → decode set; topn → prefill set
        self.decode_variants: Dict[Tuple[int, int], DecodeGraphs] = {
            (0, PEN_NONE): self.graphs}
        self.prefill_variants: Dict[int, PrefillGraphs] = {
            0: self.prefill_graphs}
        # the synchronous arms: (logprobs_topn, penalty form) → single
        # decode step set; the verify set (spec_decode)
        self.step_variants: Dict[Tuple[int, int], StepGraphs] = {}
        self.verify_graphs = (
            VerifyGraphs(self.verify_fn, self.params, self.kv_k, self.kv_v,
                         spec_tokens=self.ecfg.spec_tokens,
                         fence=self.fence, share=self.graphs)
            if self.verify_fn is not None else None)
        self.penalty_buffers: Optional[PenaltyBuffers] = None
        # a dispatched window's carry, copied out of the graph pool right
        # after its launch: another bucket's replay before the next
        # window's merge (budgeted mixing dispatches a prefill chunk
        # between them) may reuse the pool memory of its static outputs
        rows = self.ecfg.bucket_batch(self.ecfg.max_batch)
        self._carry_stash = tuple(
            torch.zeros(rows, dtype=dt, device=self.device)
            for dt in (torch.int32, torch.int32, torch.bool, torch.int32,
                       torch.int32))
        # sampled host/device split per bucket (sample=0: one compare per
        # iteration, no sync) and the latency histograms
        self.profiler = EngineProfiler(f"torch-engine-{id(self):x}",
                                       self.device,
                                       sample=self.ecfg.prof_sample,
                                       timeline=self.step_timeline)
        self.latency = LatencyRecorder("unified")
        # KV bytes per page (both pools), for the memory snapshot
        self._page_bytes = int(
            (self.kv_k.nbytes + self.kv_v.nbytes) // self.ecfg.num_pages)
        # the scheduler's PageManager calls run on the executor thread;
        # the disagg plane's (reserve, release, submit) and admission take
        # _pm_lock, as the JAX engine's do
        # the tier's None-means-env knobs, resolved once (jax_engine.py)
        if self.ecfg.host_tier_int8 is None:
            self.ecfg.host_tier_int8 = (
                self.ecfg.host_pages > 0
                and not env_bool("DYN_HOST_TIER_FP16"))
        if self.ecfg.evict_policy is None:
            self.ecfg.evict_policy = env_str("DYN_EVICT_POLICY") or "cost"
        if self.ecfg.restore_overlap is None:
            self.ecfg.restore_overlap = env_bool("DYN_RESTORE_OVERLAP", True)
        self.pm = PageManager(self.ecfg.num_pages, self.ecfg.page_size,
                              host_pages=self.ecfg.host_pages,
                              evict_policy=self.ecfg.evict_policy)
        self._pm_lock = threading.Lock()
        self.tier = (HostTier(self.kv_k, self.kv_v, self.ecfg.host_pages,
                              int8=self.ecfg.host_tier_int8)
                     if self.ecfg.host_pages > 0 else None)
        self.offload_pages_total = 0
        self.restore_pages_total = 0
        # offload copies enqueued but not yet landed in the host pool;
        # device pages whose restore has not been injected yet (their
        # sequences are gated out of prefill); the restore batch staged
        # by the last drain under restore_overlap, injected by the next
        self._offload_inflight: List[Offload] = []
        self._unrestored_pages: set = set()
        self._restore_staged: Optional[tuple] = None
        self.waiting: List[Sequence] = []
        self.prefilling: List[Sequence] = []
        self.running: List[Sequence] = []
        # pipelined dispatch state: windows/prefills enqueued on device but
        # not yet read back, plus finished sequences whose pages must stay
        # allocated until every in-flight window containing them completes
        self._inflight: List[_PendingWindow] = []
        self._pending: Optional[_PendingWindow] = None
        self._pending_prefill: Optional[_PendingPrefill] = None
        self._deferred_free: List[Sequence] = []
        # cache_sampler_params: the key of the last decode dispatch (its
        # bucket's static buffers still hold that dispatch's uploads)
        self._samp_cache: Optional[tuple] = None
        # per-sequence max context: the largest page bucket
        self.cap_pages = min(self.ecfg.page_buckets[-1],
                             max(self.ecfg.num_pages - 1, 1))
        self.cap_tokens = self.cap_pages * self.ecfg.page_size
        self._wake = asyncio.Event()
        self._loop_task: Optional[asyncio.Task] = None
        self._aio_loop: Optional[asyncio.AbstractEventLoop] = None
        self._aio_loop_tid: Optional[int] = None
        self._stopped = False
        self._followers_stopped = False
        self._exec = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="torch-step")
        self.batch_dispatches_total = 0
        self.queue_wait_seconds_total = 0.0
        self.prefill_tokens_total = 0
        self.decode_tokens_total = 0
        self.prefix_hit_tokens_total = 0
        self.prompt_tokens_total = 0
        # (prefix-hit tokens, prompt tokens) of the last DYN_CACHE_WINDOW
        # admissions: stats()' windowed hit rate follows recent traffic
        self._hit_window: deque = deque(
            maxlen=max(env_int("DYN_CACHE_WINDOW") or 256, 1))
        # iterations that dispatched decode work beside a prefill batch
        # (the JAX engine's attribute; its stats() carries no such key)
        self.mixed_dispatches = 0
        self.spec_steps = 0
        self.spec_draft_tokens_total = 0
        self.spec_accepted_tokens_total = 0
        # a draining engine refuses new work (guard.NoCapacity) while its
        # sequences run to their finish
        self.draining = False
        # the cache view of /debug/cache, and the engine's stats() in the
        # flight recorder's incident bundles (both held weakly)
        profiling.register_cache(f"torch-engine-{id(self):x}", self)
        blackbox.get_recorder().register_stats_source(
            self.worker_label or f"torch-engine-{id(self):x}", self)

    @property
    def role(self) -> str:
        return self.latency.role

    def set_role(self, role: str) -> None:
        """Label this engine's serving role (prefill|decode|unified) for
        the latency histograms; call before serving (earlier
        observations keep their role)."""
        self.latency.role = role

    # ---------------------------------------------------------- lifecycle

    def warmup(self) -> int:
        """Capture the whole decode grid (every batch x page bucket) in
        each warmed variant, then the whole prefill grid (every prefill
        batch x chunk length x page bucket, in the serving form of its
        chunk length: page-granular commit when it is a multiple of the
        page size) in each, every bucket after an eager warm call over
        padding rows, so nothing is written to the pool; then arm the
        capture fence. The decode grid is of windows, or with
        ``decode_steps=1`` of single decode steps, and with
        ``spec_decode`` also of verify steps (``jax_engine.py`` warmup).
        The variants, as the JAX engine warms them: the
        plain one always, the logprobs one with ``warmup_logprobs``, the
        penalised one with ``warmup_penalties``; one variant
        at a time, so each set's ``pool_bytes`` is what it added to the
        pool. With a host tier, its copy paths run once at a restore
        batch's size (``kv_tier.HostTier.warm``). Returns the number of
        graphs warmed."""
        ecfg = self.ecfg
        grid = ecfg.warmed_grid()
        pages = grid["page_buckets"]
        decode = [(B, P) for P in pages for B in grid["decode_batches"]]
        prefill = [(B, T, P, T % ecfg.page_size == 0) for P in pages
                   for T in grid["prefill_lens"]
                   for B in grid["prefill_batches"]]
        topns = [0]
        if ecfg.warmup_logprobs and ecfg.max_top_logprobs > 0:
            topns.append(ecfg.max_top_logprobs)
        forms = [PEN_NONE] + ([PEN_FULL] if ecfg.warmup_penalties else [])
        make = self.decode_set if ecfg.decode_steps > 1 else self.step_set
        sets = [make(n, f) for f in forms for n in topns]
        if self.verify_graphs is not None:
            sets.append(self.verify_graphs)
        for gs in sets:
            gs.capture(decode)
        psets = [self.prefill_set(n) for n in topns]
        for gs in psets:
            gs.capture(prefill)
        if self.tier is not None:
            with self.graphs.stream_ctx():
                self.tier.warm((self.kv_k, self.kv_v),
                               min(ecfg.tier_restore_chunk or ecfg.num_pages,
                                   ecfg.num_pages))
            self.tier.armed = True
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.fence.arm()
        for gs, n in ([(g, len(decode)) for g in sets]
                      + [(g, len(prefill)) for g in psets]):
            log.info("warmup: %d %s graphs (%s) captured in %.1fs (+%.0f MiB "
                     "of graph pool)", n, gs.kind, gs.variant,
                     gs.capture_seconds, gs.pool_bytes / 2**20)
        if self.penalty_buffers is not None:
            log.info("warmup: penalty buffers %.0f MiB",
                     self.penalty_buffers.nbytes / 2**20)
        return len(decode) * len(sets) + len(prefill) * len(psets)

    def decode_set(self, topn: int, form: int) -> DecodeGraphs:
        """The decode graph set of variant (logprobs width, penalty form),
        made on first use over the plain set's stream and pool."""
        gs = self.decode_variants.get((topn, form))
        if gs is None:
            gs = DecodeGraphs(
                self.decode_multi_fn, self.params, self.kv_k, self.kv_v,
                k_steps=self.ecfg.decode_steps,
                max_eos_ids=self.ecfg.max_eos_ids, logprobs_topn=topn,
                penalty_form=form,
                penalty_buffers=(self.penalties()
                                 if form != PEN_NONE else None),
                fence=self.fence, share=self.graphs)
            self.decode_variants[(topn, form)] = gs
        return gs

    def step_set(self, topn: int, form: int) -> StepGraphs:
        """The single decode step's graph set of variant (logprobs width,
        penalty form), made on first use over the plain set's stream and
        pool."""
        gs = self.step_variants.get((topn, form))
        if gs is None:
            gs = StepGraphs(
                self.decode_fn, self.params, self.kv_k, self.kv_v,
                max_top_k=self.ecfg.max_top_k, logprobs_topn=topn,
                penalty_form=form,
                penalty_buffers=(self.penalties()
                                 if form != PEN_NONE else None),
                fence=self.fence, share=self.graphs)
            self.step_variants[(topn, form)] = gs
        return gs

    def penalties(self) -> PenaltyBuffers:
        """The shared penalty buffers, made on first use."""
        if self.penalty_buffers is None:
            self.penalty_buffers = PenaltyBuffers.make(
                self.ecfg.bucket_batch(self.ecfg.max_batch),
                self.cfg.vocab_size, self.device)
        return self.penalty_buffers

    def prefill_set(self, topn: int) -> PrefillGraphs:
        """The prefill graph set whose draw also gives ``topn``
        logprobs, made on first use over the plain set's stream and
        pool."""
        gs = self.prefill_variants.get(topn)
        if gs is None:
            gs = PrefillGraphs(
                self.prefill_fn, self.params, self.kv_k, self.kv_v,
                page_size=self.ecfg.page_size,
                num_pages=self.ecfg.num_pages, max_top_k=self.ecfg.max_top_k,
                logprobs_topn=topn, fence=self.fence, share=self.graphs)
            self.prefill_variants[topn] = gs
        return gs

    def graph_replays(self) -> Dict[str, int]:
        """Graph launches so far, every variant's, by kind."""
        return {"prefill": sum(gs.replays
                               for gs in self.prefill_variants.values()),
                "decode_window": sum(gs.replays
                                     for gs in self.decode_variants.values()),
                "decode_step": sum(gs.replays
                                   for gs in self.step_variants.values()),
                "spec_verify": (self.verify_graphs.replays
                                if self.verify_graphs is not None else 0)}

    def _graph_sets(self) -> list:
        return (list(self.decode_variants.values())
                + list(self.prefill_variants.values())
                + list(self.step_variants.values())
                + ([self.verify_graphs] if self.verify_graphs is not None
                   else []))

    def graph_pool_mib(self) -> Dict[str, float]:
        """MiB of the shared graph pool each graph set added while it
        captured, by kind and variant."""
        return {f"{gs.kind}, {gs.variant}": gs.pool_bytes / 2**20
                for gs in self._graph_sets()}

    def start(self) -> None:
        if self._loop_task is None:
            self._aio_loop = asyncio.get_running_loop()
            self._aio_loop_tid = threading.get_ident()
            # the serving loop's lag monitor and stall watchdog, for as
            # long as the engine runs on it (refcounted; stop() releases)
            profiling.acquire_loop_profiler()
            self._loop_task = asyncio.ensure_future(self._loop())

    async def stop(self) -> None:
        """Stop the scheduler (its shutdown drain ends every client), then
        release the tensor-parallel followers."""
        self._stopped = True
        self._wake.set()
        if self._loop_task:
            await self._loop_task
            await profiling.release_loop_profiler()
        if self._leads and not self._followers_stopped:
            # the loop has ended: no dispatch is in progress
            self._announce([_STOP])
            self._followers_stopped = True
        self._exec.shutdown(wait=True)

    async def drain(self, timeout_s: float = 10.0) -> bool:
        """Graceful drain (``jax_engine.py`` ``drain``): refuse new work
        (``generate`` raises ``guard.NoCapacity``) and run every sequence
        in flight to its finish, bounded by ``timeout_s``. On timeout the
        leftovers are cancelled on the normal cancel path (their pages
        free once no window in flight holds them). True when everything
        finished in time. The engine keeps running; ``stop()`` ends it."""
        self.draining = True
        loop = asyncio.get_running_loop()
        deadline = loop.time() + max(timeout_s, 0.0)

        def busy() -> bool:
            return bool(self.waiting or self.prefilling or self.running
                        or self._inflight or self._pending_prefill)

        while busy() and loop.time() < deadline:
            await asyncio.sleep(0.02)
        drained = not busy()
        if not drained:
            log.warning("engine drain timed out with work in flight "
                        "(waiting=%d prefilling=%d running=%d); "
                        "cancelling leftovers", len(self.waiting),
                        len(self.prefilling), len(self.running))
            for seq in self.waiting + self.prefilling + self.running:
                seq.context.kill()
            self._wake.set()
        return drained

    # ----------------------------------------------------- tensor parallel

    @property
    def _leads(self) -> bool:
        """Rank 0 of a tensor-parallel mesh, which sends followers their
        dispatches."""
        return (self.mesh is not None and self.mesh.size > 1
                and self.mesh.rank == 0)

    def _announce(self, header: List[int],
                  payload: Optional[np.ndarray] = None) -> None:
        """Rank 0: send one dispatch to the followers, before launching
        or capturing it (a no-op without followers). ``header`` starts
        with the kind; the payload's length goes in as its second word."""
        if not self._leads:
            return
        n = 0 if payload is None else int(payload.size)
        words = [header[0], n, *header[1:]]
        head = torch.zeros(_HEADER_WORDS, dtype=torch.int64)
        head[:len(words)] = torch.tensor(words, dtype=torch.int64)
        dist.broadcast(head, src=0, group=self.mesh.cpu_group)
        if n:
            dist.broadcast(torch.from_numpy(payload), src=0,
                           group=self.mesh.cpu_group)

    def _receive(self) -> Tuple[List[int], Optional[np.ndarray]]:
        """A follower: the next dispatch from rank 0 (header without its
        length word, and the int32 payload)."""
        head = torch.empty(_HEADER_WORDS, dtype=torch.int64)
        dist.broadcast(head, src=0, group=self.mesh.cpu_group)
        words = head.tolist()
        payload = None
        if words[1]:
            buf = torch.empty(words[1], dtype=torch.int32)
            dist.broadcast(buf, src=0, group=self.mesh.cpu_group)
            payload = buf.numpy()
        return [words[0]] + words[2:], payload

    def follow(self) -> None:
        """Ranks > 0 of a tensor-parallel mesh: replay rank 0's dispatches
        on this rank's shard until rank 0 stops (blocking; after
        :meth:`warmup`). Each dispatch takes the bucket rank 0 takes, with
        the host inputs rank 0 uploads; the carry of a pipelined window
        comes from this rank's own previous window, as on rank 0."""
        if self.mesh is None or self.mesh.rank == 0:
            raise RuntimeError("follow() runs on the ranks > 0 of a mesh")
        E = self.ecfg.max_eos_ids
        with self.graphs.stream_ctx():
            while True:
                header, payload = self._receive()
                kind = header[0]
                if kind == _STOP:
                    break
                if kind == _PREFILL:
                    B, T, P, paged, topn = header[1:6]
                    gs = self.prefill_set(topn)
                    gs.run(gs.bucket(B, T, P, bool(paged)), payload)
                elif kind == _DECODE:
                    (B, P, topn, form, samp, C, NB, pB, pP, ptopn,
                     pform) = header[1:12]
                    gs = self.decode_set(topn, form)
                    bk = gs.bucket(B, P)
                    rows, at = payload[:6 * B].reshape(6, B), 6 * B
                    if samp:
                        arrays, n = _unpack_sampler(
                            payload[at:], _sampler_layout(B, P, E, form, NB))
                        self._upload_sampler(bk, arrays)
                        at += n
                    if C:
                        ids = payload[at:at + B * C].reshape(B, C)
                        self.penalty_buffers.fill(
                            B, ids, payload[at + B * C:at + B * C + B])
                    self._launch_window(gs, bk, rows,
                                        self._stashed_carry(pB) if pB
                                        else None)
                elif kind == _STEP:
                    B, P, topn, form, C, NB = header[1:7]
                    gs = self.step_set(topn, form)
                    bk = gs.bucket(B, P)
                    at = bk.packed.numel()
                    if form != PEN_NONE:
                        arrays, n = _unpack_sampler(
                            payload[at:], _penalty_layout(B, NB))
                        self.penalty_buffers.upload(B, *arrays)
                        at += n
                    if C:
                        self.penalty_buffers.fill(
                            B, payload[at:at + B * C].reshape(B, C),
                            payload[at + B * C:at + B * C + B])
                    gs.run(bk, payload[:bk.packed.numel()])
                elif kind == _VERIFY:
                    B, P = header[1:3]
                    gs = self.verify_graphs
                    gs.run(gs.bucket(B, P), payload)
                else:
                    raise RuntimeError(f"unknown dispatch kind {kind}")
                self.batch_dispatches_total += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------ AsyncEngine API

    async def generate(self, request: PreprocessedRequest,
                       context: Context) -> AsyncIterator[EngineOutput]:
        if not isinstance(request, PreprocessedRequest):
            request = PreprocessedRequest.from_dict(request)
        if self.draining:
            # typed refusal (HTTP 503 with Retry-After upstream)
            raise guard.NoCapacity("engine draining")
        self.start()
        if self.worker_label or self.mesh_devices > 1:
            # which replica and mesh serve this request, on the enclosing
            # span (http.request when served in-process)
            span = tracing.current_span()
            if span is not None:
                span.set_attribute("replica", self.worker_label)
                span.set_attribute("mesh_shape", self.mesh_shape)
        seq = Sequence(req=request, context=context, out=asyncio.Queue(),
                       tokens=list(request.token_ids),
                       num_prompt=len(request.token_ids))
        if seq.num_prompt == 0:
            yield EngineOutput(finish_reason="error", text="empty prompt")
            return
        self.waiting.append(seq)
        self._wake.set()
        while True:
            out: EngineOutput = await seq.out.get()
            yield out
            if out.finish_reason is not None:
                return

    def stats(self) -> dict:
        """The subset of the JAX engine's stats() this engine tracks, under
        the same key names."""
        lag = profiling.loop_lag_snapshot()
        return {
            "worker_label": self.worker_label,
            "role": self.role,
            "mesh_shape": self.mesh_shape,
            "mesh_devices": self.mesh_devices,
            "batch_dispatches_total": self.batch_dispatches_total,
            "kv_free_blocks": len(self.pm.free),
            "kv_cached_blocks": len(self.pm.reusable),
            "host_free_blocks": len(self.pm.host_free),
            "request_active_slots": len(self.running) + len(self.prefilling),
            "request_total_slots": self.ecfg.max_batch,
            "kv_active_blocks": self.pm.active,
            "kv_total_blocks": self.ecfg.num_pages - 1,
            "num_requests_waiting": len(self.waiting),
            "queue_wait_seconds_total": round(self.queue_wait_seconds_total,
                                              4),
            "gpu_cache_usage_perc": self.pm.usage(),
            "gpu_prefix_cache_hit_rate": self._windowed_hit_rate(),
            "gpu_prefix_cache_hit_rate_lifetime":
                (self.prefix_hit_tokens_total /
                 max(self.prompt_tokens_total, 1)),
            "prefix_hit_tokens_total": self.prefix_hit_tokens_total,
            "prompt_tokens_total": self.prompt_tokens_total,
            # the page manager's prefix-cache counters, as cache_* keys
            **{f"cache_{k}": v for k, v in self.pm.cache_stats().items()},
            "host_cache_usage_perc": self.pm.host_usage(),
            "host_offload_pages_total": self.offload_pages_total,
            "host_restore_pages_total": self.restore_pages_total,
            # graph captures after warmup() armed the fence (0 = the
            # no-capture serving invariant holds)
            "post_warmup_compiles_total": self.fence.post_warmup_compiles,
            # latency histograms (queue wait, TTFT, ITL, e2e) and the
            # sampled host/device split per bucket (empty at sample 0)
            "latency_hist": self.latency.to_wire(),
            # the serving loop's lag (sampled sleep drift)
            "loop_lag_p50_seconds": lag["p50_s"],
            "loop_lag_p99_seconds": lag["p99_s"],
            "device_time_fraction":
                round(self.profiler.device_time_fraction(), 4),
            "profiled_steps_total": self.profiler.profiled_steps,
            "bucket_cost": self.profiler.cost_table(),
            "memory": memory_snapshot(self.pm, self._page_bytes),
            # speculative decoding: acceptance rate = accepted / drafted;
            # mean accepted length = accepted drafts a verify step (each
            # step also emits its bonus token)
            "spec_decode_steps": self.spec_steps,
            "spec_decode_draft_tokens_total": self.spec_draft_tokens_total,
            "spec_decode_accepted_tokens_total":
                self.spec_accepted_tokens_total,
            "spec_decode_acceptance_rate":
                (self.spec_accepted_tokens_total /
                 max(self.spec_draft_tokens_total, 1)),
            "spec_decode_mean_accepted_len":
                (self.spec_accepted_tokens_total / max(self.spec_steps, 1)),
        }

    def _windowed_hit_rate(self) -> float:
        """Prefix-hit tokens over prompt tokens of the admissions in the
        window (0.0 while it is empty)."""
        hit = total = 0
        for h, p in self._hit_window:
            hit += h
            total += p
        return hit / total if total else 0.0

    def cache_snapshot(self) -> dict:
        """The ``/debug/cache`` view (``jax_engine.py``
        ``cache_snapshot``): pool occupancy, the host tier's, windowed and
        lifetime hit rates, the page manager's counters and the top-K
        hot prefix chains (``DYN_CACHE_TOPK``)."""
        topk = max(env_int("DYN_CACHE_TOPK") or 20, 0)
        with self._pm_lock:
            pm = self.pm
            return {
                "pool": {
                    "total_blocks": self.ecfg.num_pages - 1,
                    "active_blocks": pm.active,
                    "cached_blocks": len(pm.reusable),
                    "free_blocks": len(pm.free),
                    "usage": round(pm.usage(), 4),
                },
                "host_tier": {
                    "total_blocks": pm.host_pages,
                    "used_blocks": len(pm.host_by_hash),
                    "free_blocks": len(pm.host_free),
                    "usage": round(pm.host_usage(), 4),
                },
                "hit_rate_windowed": round(self._windowed_hit_rate(), 4),
                "hit_rate_lifetime": round(
                    self.prefix_hit_tokens_total
                    / max(self.prompt_tokens_total, 1), 4),
                "prefix_hit_tokens_total": self.prefix_hit_tokens_total,
                "prompt_tokens_total": self.prompt_tokens_total,
                **pm.cache_stats(),
                "top_prefixes": pm.top_prefixes(topk),
            }

    # ------------------------------------------------------- scheduler loop

    def _on_stream(self, fn, *args):
        """Run ``fn(*args)`` with the engine's device stream current (the
        stream the decode graphs were captured on), so every dispatch,
        copy and readback of the engine is ordered on it."""
        with self.graphs.stream_ctx():
            return fn(*args)

    async def _loop(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._stopped:
            if not (self.waiting or self.prefilling or self.running
                    or self._inflight or self._pending_prefill):
                self._wake.clear()
                await self._wake.wait()
                continue
            if guard.chaos() is not None:
                # worker-scoped chaos: a delay rule on `engine.stall`
                # freezes the scheduler loop (on the event-loop thread,
                # never the executor) for its ms. The gate keeps the
                # coroutine off the loop when no chaos is configured.
                await guard.chaos_point("engine.stall")
            try:
                if not self.ecfg.admit_in_step:
                    self._admit()
                await loop.run_in_executor(self._exec, self._on_stream,
                                           self._step)
                self._reap()
            except Exception:  # noqa: BLE001 — engine loop must survive
                log.exception("engine step failed")
                await loop.run_in_executor(self._exec, self._on_stream,
                                           self._abort_all)
        # shutdown: drain in-flight windows so no client hangs on a queue
        try:
            await loop.run_in_executor(self._exec, self._on_stream,
                                       self._shutdown_drain)
        except Exception:  # noqa: BLE001
            log.exception("pipeline flush on stop failed")

    def _step(self) -> None:
        """One scheduler iteration (executor thread), in the arms of the
        JAX engine's ``_step``: the spec arm (``spec_decode``), the
        synchronous single-step arm (``decode_steps <= 1``), the
        unpipelined windows, and the pipelined ones, which enqueue the
        next decode window or prefill chunk BEFORE reading back the
        previous ones, so the host's bookkeeping overlaps the device. The
        unpipelined arms read each dispatch back before the next. With a
        ``prefill_token_budget`` every arm also dispatches decode work
        beside a prefill batch trimmed to the budget (``prefill_priority
        =False``: beside an untrimmed one)."""
        self.profiler.tick()  # one compare at sample=0
        self._drain_kv_tier()
        budget = self.ecfg.prefill_token_budget
        mix = budget is not None or not self.ecfg.prefill_priority
        if self.verify_fn is not None:
            if self.ecfg.admit_in_step:
                self._admit_in_step()
            self._step_spec()
            return
        if self.ecfg.decode_steps <= 1 or not self.ecfg.pipeline_decode:
            if self.ecfg.admit_in_step:
                self._admit_in_step()
            if self.prefilling:
                pf = self._dispatch_prefill(budget)
                if pf is not None:
                    self._process_prefill(pf)
            if self.running and (mix or not self.prefilling):
                if mix and self.prefilling:
                    self.mixed_dispatches += 1
                if self.ecfg.decode_steps <= 1:
                    self._decode_step_single()
                else:
                    pend = self._dispatch_decode_window()
                    if pend is not None:
                        self._process_window(pend)
            self._drain_deferred()
            return
        prev = self._pending
        prev_pf = self._pending_prefill
        if self.prefilling and not mix:
            # prefill-priority: prompt batches drain at full cadence; when
            # the sweep dispatches nothing, fill the bubble with a decode
            # window (overlap_idle_prefill)
            self._pending_prefill = self._dispatch_prefill()
            if (self._pending_prefill is None
                    and self.ecfg.overlap_idle_prefill):
                self._pending = self._dispatch_decode_window()
            else:
                self._pending = None
        else:
            # budgeted mixing (or prefill_priority off): decode windows
            # keep their cadence while prompts prefill
            self._pending = self._dispatch_decode_window()
            self._pending_prefill = self._dispatch_prefill(budget)
            if (self._pending is not None
                    and self._pending_prefill is not None):
                self.mixed_dispatches += 1
        if self.ecfg.admit_in_step:
            # admission lands AFTER the dispatches: its host work overlaps
            # the in-flight window; admitted sequences enter prefilling
            # for the next iteration's sweep
            self._admit_in_step()
        if prev is not None:
            self._process_window(prev)
        if prev_pf is not None:
            self._process_prefill(prev_pf)
        self._drain_deferred()
        # idle drain: with no live work left, read back the remaining
        # windows now so final tokens/finishes emit and pages free
        if (not (self.running or self.prefilling or self.waiting)
                and (self._inflight or self._pending_prefill)):
            self._flush_pipeline()

    def _flush_pipeline(self) -> None:
        """Synchronize: read back every in-flight window/prefill so host
        state is current and all page releases are safe. Called before
        preemption (pool pressure) and on shutdown."""
        for w in list(self._inflight):
            self._process_window(w)
        self._pending = None
        if self._pending_prefill is not None:
            self._process_prefill(self._pending_prefill)
            self._pending_prefill = None
        self._drain_deferred()

    def _shutdown_drain(self) -> None:
        """stop(): flush the pipeline (its tokens and finishes emit), then
        end every sequence still queued or running as cancelled, so every
        client sees a finish_reason."""
        self._flush_pipeline()
        for seq in self.waiting + self.prefilling + self.running:
            self._terminate(seq, FINISH_CANCELLED)
        self.waiting.clear()
        self.prefilling.clear()
        self.running.clear()

    def _abort_all(self) -> None:
        """Error path: drop pipeline state, release everything, fail all
        in-flight requests (the loop itself must survive). Covers the
        sequences parked outside prefilling/running: deferred frees and a
        pending prefill's finishing rows."""
        if self.device.type == "cuda":
            try:
                torch.cuda.synchronize(self.device)
            except RuntimeError:
                log.exception("device sync on abort failed")
        # parked offloads land: their host slots are already mapped to
        # their hashes, and a later restore would read stale content
        try:
            self._land_inflight_offloads(self._offload_inflight)
        except RuntimeError:
            log.exception("landing the tier's offloads on abort failed")
        self._offload_inflight.clear()
        parked = list(self._deferred_free)
        if self._pending_prefill is not None:
            parked += [s for _, s in self._pending_prefill.finishing]
        self._inflight.clear()
        self._pending = None
        self._pending_prefill = None
        self._deferred_free.clear()
        self._samp_cache = None
        for seq in parked + self.prefilling + self.running:
            self._release(seq)
            self._finish(seq, "error")
        self.prefilling.clear()
        self.running.clear()

    def _reap(self) -> None:
        """Drop finished sequences that linger in running (safety net)."""
        self.running = [s for s in self.running if s.finished is None]

    # ----------------------------------------------------------- admission

    def _admit(self) -> None:
        while self.waiting and (len(self.running) + len(self.prefilling)
                                < self.ecfg.max_batch):
            seq = self.waiting[0]
            if seq.context.stopped:
                self.waiting.pop(0)
                self._finish(seq, _cancel_reason(seq.context))
                continue
            if seq.num_prompt >= self.cap_tokens:
                self.waiting.pop(0)
                self._emit(seq, EngineOutput(
                    token_ids=[],
                    text=f"prompt length {seq.num_prompt} exceeds engine "
                         f"context capacity {self.cap_tokens}"))
                self._finish(seq, "error")
                continue
            chain = self._chain(seq)
            with self._pm_lock:
                alloc = self.pm.allocate_sequence(seq.tokens, chain=chain)
                if (alloc is None
                        or self.pm.available < self.ecfg.watermark_pages):
                    if alloc is not None:
                        self.pm.release_sequence(alloc[0])
                    break  # out of pages; wait for frees
                if alloc.restores:
                    # gated out of prefill until its restores have landed
                    self._unrestored_pages.update(
                        p for p, _ in alloc.restores)
            self.waiting.pop(0)
            pages, cached_tokens = alloc
            seq.pages = pages
            seq.computed = min(cached_tokens, seq.prefill_extent)
            if alloc.restores:
                seq.restore_t0 = time.monotonic()
            if seq.generated == 0:  # don't double-count resumed sequences
                seq.queue_wait_s = time.monotonic() - seq.arrival
                self.queue_wait_seconds_total += seq.queue_wait_s
                self.latency.observe("queue_wait", seq.queue_wait_s)
                seq.prefix_hit = seq.computed
                seq.device_hit_blocks = alloc.device_hit_blocks
                seq.host_restored_blocks = alloc.host_restored_blocks
                self.step_timeline.add(
                    "admit", queue_wait_ms=round(seq.queue_wait_s * 1000.0,
                                                 3),
                    request_id=seq.context.id,
                    occupancy=len(self.running) + len(self.prefilling) + 1,
                    waiting=len(self.waiting))
                self.prefix_hit_tokens_total += seq.computed
                self.prompt_tokens_total += seq.num_prompt
                self._hit_window.append((seq.computed, seq.num_prompt))
            self.prefilling.append(seq)

    def _admit_in_step(self) -> None:
        """Admission inside the step (admit_in_step), bracketed as its own
        cost-table row; the guard keeps an iteration with no waiters at
        one compare."""
        if not self.waiting:
            return
        at0 = self.profiler.begin()
        self._admit()
        self.profiler.end(at0, "admit", ("host",))

    # ------------------------------------------------------- KV tier drain

    def _land_inflight_offloads(self, entries: List[Offload]) -> None:
        """Wait for parked offload copies: their host slots then hold
        the pages."""
        for off in entries:
            off.wait()

    def _drain_kv_tier(self, full: bool = False) -> None:
        """Run the page manager's queued device<->host page copies
        (``jax_engine.py`` ``_drain_kv_tier``), on the engine's stream,
        before the next device step: offloads then read what every
        earlier dispatch left in their pages, and restores land before
        their pages are read.

        Offload copies are enqueued without a host wait and park in
        ``_offload_inflight`` until a later drain lands them (the newest
        stays in flight under the next step). Restores drain at most
        ``tier_restore_chunk`` pages a call; their sequences stay gated
        out of prefill through ``_unrestored_pages`` until their copy is
        injected. Every parked offload lands before any restore reads
        the host pool.

        With ``restore_overlap`` the drained batch's host-to-device copy
        and dequantize go on the tier's copy stream now, and its inject
        lands at the start of the next drain, so the copy runs under the
        step between; rows whose page was recycled meanwhile are left
        out of the inject. ``full=True`` drains everything now, inject
        included: the disaggregation plane hands pages to a consumer
        with no later drain between."""
        if self.tier is None:
            return
        chunk = None if full else (self.ecfg.tier_restore_chunk or None)
        if self._restore_staged is not None:
            self._inject_staged()
        with self._pm_lock:
            off, res = self.pm.drain_tier_ops(restore_limit=chunk)
            # each drained page's block hash, for the inject-time check
            res_hashes = [self.pm.pages[p].block_hash for p, _ in res]
            # the gate mirrors the restores still queued (a stale one
            # cancelled on reallocation un-gates its page's new owner)
            self._unrestored_pages = {p for p, _ in self.pm.pending_restore}
        if off:
            self._offload_inflight.append(self.tier.offload(
                (self.kv_k, self.kv_v), [p for p, _ in off],
                [s for _, s in off]))
            self.offload_pages_total += len(off)
        # a restore may read a slot whose offload is still in flight, so
        # everything lands before one; otherwise the newest stays in
        # flight under the next step
        land_all = bool(res) or full
        if self._offload_inflight and (land_all
                                       or len(self._offload_inflight) > 1):
            harvest = (self._offload_inflight if land_all
                       else self._offload_inflight[:-1])
            self._offload_inflight = ([] if land_all
                                      else self._offload_inflight[-1:])
            self._land_inflight_offloads(harvest)
        if not res:
            return
        rt0 = time.perf_counter()
        pages = [p for p, _ in res]
        overlap = bool(self.ecfg.restore_overlap) and not full
        staged = self.tier.stage([s for _, s in res],
                                 (self.kv_k.dtype, self.kv_v.dtype),
                                 side=overlap)
        if overlap:
            self._restore_staged = (pages, res_hashes, staged)
            self._unrestored_pages.update(pages)
        else:
            self.tier.inject((self.kv_k, self.kv_v), staged, pages)
        self.restore_pages_total += len(res)
        # a step-timeline event and a span per drained batch (the time
        # to enqueue it; no host wait)
        rdt = time.perf_counter() - rt0
        self.step_timeline.add(
            "cache.restore", pages=len(res),
            queued=len(self._unrestored_pages), staged=int(overlap),
            dispatch_ms=round(rdt * 1000.0, 3))
        tracing.get_tracer().record_span(
            "cache.restore", rdt, parent=None,
            attributes={"pages": len(res), "staged": overlap,
                        "queued": len(self._unrestored_pages)})

    def _inject_staged(self) -> None:
        """Land the staged restore batch (the second half of an
        overlapped restore). A row whose page was recycled since staging
        (its hash no longer maps to it) is left out: the page's content
        now belongs to its new owner."""
        pages, hashes, staged = self._restore_staged
        self._restore_staged = None
        with self._pm_lock:
            keep = [i for i, (p, h) in enumerate(zip(pages, hashes))
                    if self.pm.by_hash.get(h) == p]
        self.tier.inject((self.kv_k, self.kv_v), staged, pages, keep)
        self._unrestored_pages.difference_update(pages)

    # ------------------------------------------------------------- prefill

    def _dispatch_prefill(self, token_budget: Optional[int] = None
                          ) -> Optional[_PendingPrefill]:
        """Enqueue one chunked-prefill step over a BATCH of prefilling
        sequences (each contributes its next chunk) without reading back;
        rows that complete their prompt draw their first token on the
        device. ``token_budget`` trims the batch to about that many
        prompt tokens (the head always ships whole, so chunk starts stay
        page-aligned). None when nothing was dispatched."""
        candidates: List[Sequence] = []
        for seq in list(self.prefilling):
            if seq.context.stopped:
                self.prefilling.remove(seq)
                self._terminate(seq, _cancel_reason(seq.context))
                continue
            if (self._unrestored_pages
                    and not self._unrestored_pages.isdisjoint(seq.pages)):
                # host-tier restores of its pages are still queued or
                # staged: its prefill would read stale pages. It waits
                continue
            if seq.restore_t0 is not None:
                # admission -> its restores landed: the restore wait
                seq.restore_wait_s = time.monotonic() - seq.restore_t0
                seq.restore_t0 = None
            if seq.prefill_extent - seq.computed <= 0:
                # resumed sequence fully covered by the prefix cache
                self.prefilling.remove(seq)
                seq.last_token = seq.tokens[-1]
                self.running.append(seq)
                continue
            candidates.append(seq)
        if not candidates:
            return None
        ecfg = self.ecfg

        def tbucket(s):
            return ecfg.bucket_len(min(s.prefill_extent - s.computed,
                                       ecfg.prefill_chunk))

        # bucket-homogeneous batching: FIFO head, then its bucket-mates,
        # then smaller-bucket prompts (they ride along without raising T)
        head = candidates[0]
        hb = tbucket(head)
        mates = [s for s in candidates[1:] if tbucket(s) == hb]
        batch = [head] + mates + [s for s in candidates[1:]
                                  if s not in mates and tbucket(s) < hb]
        batch = batch[:ecfg.max_prefill_batch]
        if token_budget is not None:
            kept, total = [], 0
            for s in batch:
                c = min(s.prefill_extent - s.computed, ecfg.prefill_chunk)
                if kept and total + c > token_budget:
                    break
                kept.append(s)
                total += c
            batch = kept
        chunks = [min(s.prefill_extent - s.computed, ecfg.prefill_chunk)
                  for s in batch]
        B = ecfg.prefill_bucket_batch(len(batch))
        T = ecfg.bucket_len(max(chunks))
        P = ecfg.bucket_pages(max(len(s.pages) for s in batch))
        ps = ecfg.page_size

        use_paged = T % ps == 0 and all(s.computed % ps == 0 for s in batch)
        key = (B, T, P, use_paged)
        img, f = self.prefill_graphs.host_inputs(*key)  # padding rows
        for i, (seq, chunk) in enumerate(zip(batch, chunks)):
            start = seq.computed
            pos = np.arange(start, start + chunk)
            pages = np.asarray(seq.pages, np.int64)
            f["tokens"][i, :chunk] = seq.tokens[start:start + chunk]
            f["positions"][i, :chunk] = pos
            f["table"][i, :len(seq.pages)] = seq.pages
            f["last_idx"][i] = chunk - 1
            f["slots"][i, :chunk] = pages[pos // ps] * ps + pos % ps
            if use_paged:
                first = start // ps
                npg = (chunk + ps - 1) // ps
                f["pslots"][i, :npg] = pages[first:first + npg]

        finishing: List[Tuple[int, Sequence]] = []
        for i, (seq, chunk) in enumerate(zip(batch, chunks)):
            seq.computed += chunk
            self.prefill_tokens_total += chunk
            if seq.computed >= seq.prefill_extent:
                self.prefilling.remove(seq)
                finishing.append((i, seq))
        # rows that completed their prompt draw their first token inside
        # the graph; mid-prompt chunks and resumed rows (next token already
        # sampled) leave the sampler's inputs at padding and read nothing.
        # A batch with a penalty or logit_bias draws eagerly from the
        # graph's logits instead (_penalised_draw)
        draw = any(s.generated == 0 for _, s in finishing)
        topn = (self.ecfg.max_top_logprobs
                if draw and self._wants_logprobs(batch) else 0)
        penalised = draw and self._penalty_form(batch) != PEN_NONE
        if draw:
            sb = SamplingBatch.build([s.req.sampling for s in batch], B)
            f["temperature"][:] = sb.temperature
            f["top_k"][:] = sb.top_k
            f["top_p"][:] = sb.top_p
            f["seeds"][:] = sb.seeds
            f["steps"][:len(batch)] = [s.generated for s in batch]
        graph_topn = 0 if penalised else topn

        self._announce([_PREFILL, B, T, P, int(use_paged), graph_topn], img)
        gs = self.prefill_set(graph_topn)
        bk = gs.bucket(*key)
        pt0 = self.profiler.begin()
        gs.run(bk, img)
        sampled, aux, event = None, None, None
        if draw:
            toks, dev_aux = bk.sampled, bk.aux
            if penalised:
                toks, dev_aux = self._penalised_draw(
                    bk, self._penalty_args(batch, sb, B),
                    self._penalty_state(batch, B) if sb.has_penalties
                    else None, topn)
            (sampled, *aux), event = to_host(toks, *(dev_aux or ()))
        self.profiler.end(pt0, "prefill", (B, T, P), tokens=sum(chunks),
                          drain=True)
        self._account_dispatch(batch)
        self.step_timeline.add(
            "prefill", batch=len(batch), tokens=int(sum(chunks)),
            occupancy=len(self.running) + len(self.prefilling),
            waiting=len(self.waiting))
        return _PendingPrefill(finishing=finishing, sampled=sampled,
                               event=event, aux=aux or None)

    def _penalised_draw(self, bk, pargs: tuple,
                        state: Optional[Tuple[np.ndarray, np.ndarray]],
                        topn: int):
        """The first-token draw of a prefill batch with a penalty or
        logit_bias (the JAX engine's ``_sample_device`` with its penalty
        tuple), sampled eagerly from the replayed chunk's logits with the
        sampler inputs the chunk uploaded, over the shared penalty
        buffers as a decode window reads them: ``pargs`` and ``state``
        as :meth:`_penalty_args` and :meth:`_penalty_state` give them
        (``state`` None when no row has a count-driven penalty). Returns
        (tokens [B], aux or None)."""
        f, B = bk.inputs, bk.B
        pb = self.penalties()
        pb.upload(B, *pargs)
        if state is not None:
            pb.fill(B, *state)
        # the buffers no longer hold the last decode dispatch's uploads
        self._samp_cache = None
        toks = sample_tokens(bk.logits, f["temperature"], f["top_k"],
                             f["top_p"], f["seeds"], f["steps"],
                             max_top_k=self.ecfg.max_top_k,
                             penalties=pb.penalties(B))
        aux = logprob_aux(bk.logits, toks, topn) if topn else None
        return toks, aux

    def _process_prefill(self, pf: _PendingPrefill) -> None:
        """Read back a dispatched prefill's first-token draws and admit
        the finished prompts into decode."""
        if pf.processed:
            return
        pf.processed = True
        toks = aux = None
        if pf.sampled is not None:
            if pf.event is not None:
                pf.event.synchronize()
            toks = pf.sampled.numpy()
            if pf.aux is not None:
                aux = tuple(a.numpy() for a in pf.aux)
        for i, seq in pf.finishing:
            self._commit_full_pages(seq)
            if seq.generated == 0:
                self._append_token(seq, int(toks[i]),
                                   lp=self._lp_entry(seq, aux, i))
                if seq.finished is None:
                    self.running.append(seq)
            else:
                # resumed after preemption: next token already sampled
                seq.last_token = seq.tokens[-1]
                self.running.append(seq)

    # -------------------------------------------------------------- decode

    def _grow_or_preempt(self, batch: List[Sequence], lookahead: int) -> None:
        """Grow every batch member's pages ``lookahead`` tokens ahead
        (clamped to the capacity); on pool exhaustion, flush the pipeline
        (so releases are safe and deferred frees land) and preempt the
        newest sequences until the batch fits."""
        for seq in list(batch):
            if seq not in batch:
                continue
            if seq.finished is not None or seq.context.stopped:
                # a flush below may have finished earlier batch members
                batch.remove(seq)
                continue
            target = min(len(seq.tokens) + lookahead, self.cap_tokens)
            if self.pm.grow(seq.pages, target):
                continue
            self._flush_pipeline()  # host state current; frees landed
            if seq.finished is not None or seq.context.stopped:
                batch.remove(seq)  # the flush finished/cancelled it
                continue
            target = min(len(seq.tokens) + lookahead, self.cap_tokens)
            while not self.pm.grow(seq.pages, target):
                live = [s for s in self.running if s.finished is None]
                if not live:
                    batch.remove(seq)
                    break
                victim = max(live, key=lambda s: s.arrival)
                log.warning("KV pool exhausted; preempting %s",
                            victim.context.id)
                if victim in batch:
                    batch.remove(victim)
                self.running.remove(victim)
                self._release(victim)
                victim.computed = 0  # keep tokens/generated: resume not redo
                self.waiting.insert(0, victim)
                if victim is seq:
                    break
        # the tier copies these evictions queued go now, before this
        # step's forward: the evicted pages' new owners write them in it,
        # and a drain on the next step would offload overwritten pages
        self._drain_kv_tier()

    def _dispatch_decode_window(self, batch: Optional[List[Sequence]] = None
                                ) -> Optional[_PendingWindow]:
        """Enqueue the next fused K-step decode window (one graph replay)
        WITHOUT reading back. Rows carried over from the in-flight window
        take their (token, position, done, step, budget) state from its
        device carry; newly admitted rows are seeded from host state.
        ``batch`` restricts the window to a subset of running rows (the
        spec arm's bypass rows, cancellations already swept), every row
        seeded from host state: the spec arm reads each window back
        before its next dispatch, and a row's last verify step moved its
        host state past any window carry."""
        ecfg = self.ecfg
        K = ecfg.decode_steps
        carried = batch is None
        if carried:
            for seq in list(self.running):
                if seq.context.stopped:
                    self._terminate(seq, _cancel_reason(seq.context))
            batch = [s for s in self.running if s.finished is None]
        else:
            batch = [s for s in batch
                     if s.finished is None and not s.context.stopped]
        batch = batch[:ecfg.max_batch]
        if not batch:
            return None
        # grow pages to cover this window AND the in-flight one (device
        # positions can lead host state by up to K tokens)
        self._grow_or_preempt(batch, 2 * K)
        # the flush inside _grow_or_preempt may have finished rows
        batch = [s for s in batch
                 if s.finished is None and not s.context.stopped]
        if not batch:
            return None
        # None if _grow_or_preempt flushed
        prev = self._pending if carried else None
        # sampling penalties need ACCURATE host token lists (the state is
        # rebuilt from seq.tokens each dispatch): land the in-flight
        # window first, trading the pipelining overlap away only for
        # batches that use count-driven penalties
        if prev is not None and any(_wants_count_state(s.req.sampling)
                                    for s in batch):
            self._process_window(prev)
            prev = None
            # the read-back may have finished rows (EOS/length) and freed
            # their pages: dispatching them would scatter into page 0
            batch = [s for s in batch
                     if s.finished is None and not s.context.stopped]
            if not batch:
                return None
        B = ecfg.bucket_batch(len(batch))
        P = ecfg.bucket_pages(max(len(s.pages) for s in batch))
        E = ecfg.max_eos_ids
        topn = ecfg.max_top_logprobs if self._wants_logprobs(batch) else 0
        form = self._penalty_form(batch)
        # cache_sampler_params: while the batch composition (rows, page
        # counts, bucket, variant) is unchanged, the page table, stop
        # table and sampler params already sit in the bucket's static
        # buffers (and the shared penalty buffers)
        key = ((B, P, topn, form, list(batch), [len(s.pages) for s in batch])
               if ecfg.cache_sampler_params else None)
        samp = None
        if key is None or self._samp_cache != key:
            table = np.zeros((B, P), np.int32)
            eos = np.full((B, E), -1, np.int32)
            for i, seq in enumerate(batch):
                table[i, :len(seq.pages)] = seq.pages
                ids = seq.stop_ids
                if ids:
                    eos[i, :min(len(ids), E)] = ids[:E]
            sb = SamplingBatch.build([s.req.sampling for s in batch], B)
            samp = (table, eos, sb.temperature.astype(np.float32),
                    sb.top_k.astype(np.int32), sb.top_p.astype(np.float32),
                    sb.seeds.astype(np.int64))
            if form != PEN_NONE:
                samp += self._penalty_args(batch, sb, B)
            self._samp_cache = key
        state = (self._penalty_state(batch, B)
                 if any(_wants_count_state(s.req.sampling) for s in batch)
                 else None)
        # host rows: tok, pos, steps, remaining, src, from_carry
        rows = np.zeros((6, B), np.int32)
        rows[1] = -1
        rows[3] = 1
        for i, seq in enumerate(batch):
            if prev is not None and id(seq) in prev.index:
                rows[4, i] = prev.index[id(seq)]
                rows[5, i] = 1
            else:
                rows[0, i] = seq.last_token
                rows[1, i] = len(seq.tokens) - 1
                rows[2, i] = seq.generated
                rows[3, i] = max(min(seq.max_new() - seq.generated,
                                     self.cap_tokens - len(seq.tokens)), 1)
        pB, pP, ptopn, pform = prev.key if prev is not None else (0,) * 4
        if self._leads:
            parts = [rows.reshape(-1)]
            if samp is not None:
                parts.append(_pack_sampler(samp))
            if state is not None:
                parts += [state[0].reshape(-1), state[1]]
            C = state[0].shape[1] if state is not None else 0
            NB = samp[-1].size if samp is not None and form else 0
            self._announce([_DECODE, B, P, topn, form, int(samp is not None),
                            C, NB, pB, pP, ptopn, pform],
                           np.concatenate(parts))
        gs = self.decode_set(topn, form)
        bk = gs.bucket(B, P)
        if samp is not None:
            self._upload_sampler(bk, samp)
        if state is not None:
            self.penalty_buffers.fill(B, *state)
        pt0 = self.profiler.begin()
        self._launch_window(gs, bk, rows,
                            prev.carry if prev is not None else None)
        host, event = to_host(bk.toks, bk.emitted, self._carry_stash[2][:B],
                              *(bk.aux or ()))
        self.profiler.end(pt0, "decode_window", (B, P, K),
                          tokens=len(batch) * K, drain=True)
        self._account_dispatch(batch)
        pend = _PendingWindow(batch=list(batch), host=host, event=event,
                              carry=self._stashed_carry(B),
                              index={id(s): i for i, s in enumerate(batch)},
                              key=(B, P, topn, form))
        self._inflight.append(pend)
        return pend

    def _upload_sampler(self, bk, samp: tuple) -> None:
        """A decode bucket's page table, stop table and sampler params,
        and for a penalised variant the rows' rep, freq, pres and
        logit_bias entries (into the shared penalty buffers)."""
        dsts = (bk.table, bk.eos, bk.temperature, bk.top_k, bk.top_p,
                bk.seeds)
        for dst, a in zip(dsts, samp):
            upload(dst, a)
        if bk.pen is not None:
            self.penalty_buffers.upload(bk.B, *samp[len(dsts):])

    def _stashed_carry(self, B: int) -> tuple:
        """The last window's carry (its first B rows), as
        :meth:`_launch_window` copied it out of the graph pool."""
        return tuple(t[:B] for t in self._carry_stash)

    def _launch_window(self, gs: DecodeGraphs, bk, rows: np.ndarray,
                       prev_carry: Optional[tuple]) -> None:
        """Upload a window's host rows (tok, pos, steps, remaining, src,
        from_carry) and launch it: rows carried over from the previous
        window take their state from ``prev_carry`` (:func:`_merge_carry`),
        the others from the rows. The window's carry then goes to the
        stash (:meth:`_stashed_carry`), the next window's ``prev_carry``,
        in stream order before any other replay."""
        upload(bk.rows, rows)
        n_tok, n_pos, n_steps, n_rem, src, from_carry = bk.rows
        if prev_carry is not None:
            _merge_carry(*prev_carry, src, from_carry, n_tok, n_pos,
                         n_steps, n_rem, out=bk.carry_in)
        else:
            for dst, new in zip((bk.tok, bk.pos, bk.steps, bk.rem),
                                (n_tok, n_pos, n_steps, n_rem)):
                dst.copy_(new)
            bk.done.zero_()
        gs.launch(bk)
        for dst, c in zip(self._stashed_carry(bk.B), bk.carry):
            dst.copy_(c)

    def _process_window(self, pend: _PendingWindow) -> None:
        """Read back a dispatched window's tokens (waits on its own event
        only) and apply host bookkeeping: emission, stop conditions,
        prefix commits. Rows whose stop ids all fit the device table take
        the device's emitted count and done flag; others check stops token
        by token."""
        if pend.processed:
            return
        pend.processed = True
        if pend.event is not None:
            pend.event.synchronize()
        toks, counts, done, *aux = (h.numpy() for h in pend.host)
        aux = tuple(aux) or None
        if pend in self._inflight:
            self._inflight.remove(pend)
        if self._pending is pend:
            self._pending = None
        K = toks.shape[1]
        # host-segment bracket: bookkeeping only (the read-back wait
        # above shows as the window's device time)
        ht0 = self.profiler.begin()
        before = self.decode_tokens_total
        coalesce = self.ecfg.coalesce_window_emissions
        for i, seq in enumerate(pend.batch):
            if seq.finished is not None:
                continue
            if (coalesce and not seq.context.stopped
                    and len(seq.stop_ids) <= self.ecfg.max_eos_ids):
                self._append_row(seq, toks[i], int(counts[i]), bool(done[i]),
                                 aux, i)
                continue
            for j in range(K):
                if seq.finished is not None or seq.context.stopped:
                    break  # tokens past EOS/stop are discarded
                self._append_token(seq, int(toks[i, j]),
                                   lp=self._lp_entry(seq, aux, i, j))
                self.decode_tokens_total += 1
        self.profiler.end(ht0, "process_window", (len(pend.batch), K),
                          tokens=self.decode_tokens_total - before)
        self.step_timeline.add(
            "decode_window", batch=len(pend.batch),
            tokens=self.decode_tokens_total - before,
            occupancy=len(self.running) + len(self.prefilling),
            waiting=len(self.waiting))

    def _append_row(self, seq: Sequence, row: np.ndarray, n: int,
                    dev_done: bool, aux=None, i: int = 0) -> None:
        """Bulk-append one window row using the device's valid-token count:
        one EngineOutput for the whole window."""
        n = min(n, row.shape[0])
        if n <= 0:
            if dev_done and seq.finished is None:
                self._terminate(seq, FINISH_LENGTH)
            return
        ids = [int(t) for t in row[:n]]
        prev_filled = len(seq.tokens)
        seq.tokens.extend(ids)
        seq.last_token = ids[-1]
        seq.generated += n
        self.decode_tokens_total += n
        lps = tops = None
        if aux is not None and seq.req.output.logprobs is not None:
            entries = [self._lp_entry(seq, aux, i, j) for j in range(n)]
            lps = [e[0] for e in entries]
            tops = [e[1] for e in entries]
        self._emit(seq, EngineOutput(token_ids=ids,
                                     prompt_tokens=seq.num_prompt,
                                     logprobs=lps, top_logprobs=tops))
        # prefix-cache publish when the row crossed a page boundary (the
        # newest token's KV is not written yet: publishable extent is
        # len(tokens) - 1)
        filled = len(seq.tokens)
        ps = self.ecfg.page_size
        if (filled - 1) // ps > max(prev_filled - 1, 0) // ps:
            self.pm.commit_chain(seq.pages, seq.tokens, filled - 1,
                                 chain=self._chain(seq))
        if dev_done:
            self._terminate(seq, FINISH_EOS if ids[-1] in seq.stop_set
                            else FINISH_LENGTH)
        elif (seq.generated >= seq.max_new()
              or len(seq.tokens) >= self.cap_tokens):
            self._terminate(seq, FINISH_LENGTH)

    # ------------------------------------------- the synchronous decode arms

    def _decode_step_single(self, batch: Optional[List[Sequence]] = None
                            ) -> None:
        """One decode step (one graph replay: the forward at T = 1 and
        the draw) over every running row, or over ``batch`` (the spec
        arm's bypass rows), read back at once (``jax_engine.py``
        ``_decode_step_single``)."""
        ecfg = self.ecfg
        if batch is None:
            batch = [s for s in self.running if s.finished is None]
        batch = batch[:ecfg.max_batch]
        for seq in list(batch):
            if seq.context.stopped:
                batch.remove(seq)
                self._terminate(seq, _cancel_reason(seq.context))
        self._grow_or_preempt(batch, 1)
        if not batch:
            return
        B = ecfg.bucket_batch(len(batch))
        P = ecfg.bucket_pages(max(len(s.pages) for s in batch))
        ps = ecfg.page_size
        topn = ecfg.max_top_logprobs if self._wants_logprobs(batch) else 0
        form = self._penalty_form(batch)
        gs = self.step_set(topn, form)
        img, f = gs.host_inputs(B, P)
        sb = SamplingBatch.build([s.req.sampling for s in batch], B)
        f["temperature"][:] = sb.temperature
        f["top_k"][:] = sb.top_k
        f["top_p"][:] = sb.top_p
        f["seeds"][:] = sb.seeds
        for i, seq in enumerate(batch):
            pos = len(seq.tokens) - 1  # position of last_token
            f["tokens"][i] = seq.last_token
            f["positions"][i] = pos
            f["steps"][i] = seq.generated
            f["table"][i, :len(seq.pages)] = seq.pages
            f["slots"][i] = seq.pages[pos // ps] * ps + pos % ps
        pen = state = None
        if form != PEN_NONE:
            pen = self._penalty_args(batch, sb, B)
            if sb.has_penalties:
                state = self._penalty_state(batch, B)
        if self._leads:
            parts = [img]
            if pen is not None:
                parts.append(_pack_sampler(pen))
            if state is not None:
                parts += [state[0].reshape(-1), state[1]]
            self._announce([_STEP, B, P, topn, form,
                            state[0].shape[1] if state is not None else 0,
                            pen[-1].size if pen is not None else 0],
                           np.concatenate(parts))
        bk = gs.bucket(B, P)
        if pen is not None:
            self.penalty_buffers.upload(B, *pen)
            if state is not None:
                self.penalty_buffers.fill(B, *state)
            # the buffers no longer hold the last window's uploads
            self._samp_cache = None
        pt0 = self.profiler.begin()
        gs.run(bk, img)
        (sampled, *aux), event = to_host(*bk.out)
        self.profiler.end(pt0, "decode", (B, P), tokens=len(batch),
                          drain=True)
        self._account_dispatch(batch)
        if event is not None:
            event.synchronize()
        toks = sampled.numpy()
        aux = tuple(a.numpy() for a in aux) or None
        self.decode_tokens_total += len(batch)
        for i, seq in enumerate(batch):
            self._append_token(seq, int(toks[i]),
                               lp=self._lp_entry(seq, aux, i))

    def _step_spec(self) -> None:
        """A scheduler iteration with self-speculative decoding
        (``jax_engine.py`` ``_step_spec``), synchronous: the drafter
        reads the host token lists every step, so they must be exact.
        Prefill keeps its policy (priority, or budgeted mixing). Rows
        whose drafter finds a continuation take the batched verify step;
        the rest (no draft, sampled, penalised, logit_bias, logprobs)
        take a window or a single step, seeded from host state."""
        budget = self.ecfg.prefill_token_budget
        if self.prefilling:
            pf = self._dispatch_prefill(budget)
            if pf is not None:
                self._process_prefill(pf)
        if self.prefilling and budget is None and self.ecfg.prefill_priority:
            return
        for seq in list(self.running):
            if seq.context.stopped:
                self._terminate(seq, _cancel_reason(seq.context))
        batch = [s for s in self.running if s.finished is None]
        batch = batch[:self.ecfg.max_batch]
        if not batch:
            return
        if self.prefilling:
            self.mixed_dispatches += 1
        drafts: Dict[int, List[int]] = {}
        spec_rows: List[Sequence] = []
        rest: List[Sequence] = []
        for seq in batch:
            d = self._draft_for(seq)
            if d:
                spec_rows.append(seq)
                drafts[id(seq)] = d
            else:
                rest.append(seq)
        if spec_rows:
            self._decode_step_spec(spec_rows, drafts)
        # the verify step's pool-pressure preemption can evict rows parked
        # in `rest` (they lose their pages and requeue): never dispatch a
        # row the scheduler no longer runs
        rest = [s for s in rest if s in self.running]
        if rest:
            if self.ecfg.decode_steps > 1:
                pend = self._dispatch_decode_window(batch=rest)
                if pend is not None:
                    self._process_window(pend)
            else:
                self._decode_step_single(batch=rest)
        self._drain_deferred()

    def _draft_for(self, seq: Sequence) -> List[int]:
        """The row's prompt-lookup draft, or [] when it bypasses
        speculation: sampled rows, count-driven penalties and logit_bias
        (their logits depend on tokens accepted earlier in the same
        step), and logprobs requests (the verify step returns none). The
        draft is clamped so that a full accept (K drafts and the bonus)
        stays inside the row's budget and the context capacity."""
        s = seq.req.sampling
        if (not s.greedy or _wants_count_state(s) or s.logit_bias
                or seq.req.output.logprobs is not None):
            return []
        k = min(self.ecfg.spec_tokens, seq.max_new() - seq.generated - 1,
                self.cap_tokens - len(seq.tokens) - 1)
        if k <= 0:
            return []
        return propose_ngram_draft(seq.tokens, k, self.ecfg.spec_ngram_max,
                                   self.ecfg.spec_ngram_min)

    def _decode_step_spec(self, batch: List[Sequence],
                          drafts: Dict[int, List[int]]) -> None:
        """One batched verify step (one graph replay: the [B, K+1]
        forward over [pending token, drafts...], every input's K/V
        scattered into its slot, and the accept mask), read back at once;
        each row appends its accepted drafts and the bonus token.
        Rejected drafts leave K/V past the row's accepted extent, which a
        later decode input rewrites before any query sees it, and page
        commits publish only positions behind the newest token."""
        ecfg = self.ecfg
        K = ecfg.spec_tokens
        # pages for every write of this step (positions through
        # len(tokens) - 1 + K) and the next pending token's slot
        self._grow_or_preempt(batch, K + 1)
        batch = [s for s in batch
                 if s.finished is None and not s.context.stopped]
        if not batch:
            return
        B = ecfg.bucket_batch(len(batch))
        P = ecfg.bucket_pages(max(len(s.pages) for s in batch))
        ps = ecfg.page_size
        gs = self.verify_graphs
        img, f = gs.host_inputs(B, P)
        for i, seq in enumerate(batch):
            d = drafts[id(seq)][:K]
            n = len(d)
            pos0 = len(seq.tokens) - 1  # position of the pending token
            pr = np.arange(pos0, pos0 + n + 1)
            pages = np.asarray(seq.pages, np.int64)
            f["tokens"][i, :n + 1] = [seq.last_token] + d
            f["positions"][i, :n + 1] = pr
            f["slots"][i, :n + 1] = pages[pr // ps] * ps + pr % ps
            f["table"][i, :len(seq.pages)] = seq.pages
            f["draft"][i, :n] = d
            f["draft_len"][i] = n
        self._announce([_VERIFY, B, P], img)
        bk = gs.bucket(B, P)
        pt0 = self.profiler.begin()
        gs.run(bk, img)
        (out, acc), event = to_host(*bk.out)
        self.profiler.end(pt0, "spec_verify", (B, P),
                          tokens=int(f["draft_len"].sum()) + len(batch),
                          drain=True)
        self._account_dispatch(batch)
        if event is not None:
            event.synchronize()
        out, acc = out.numpy(), acc.numpy()
        self.spec_steps += 1
        for i, seq in enumerate(batch):
            accepted = int(acc[i])
            self.spec_draft_tokens_total += int(f["draft_len"][i])
            self.spec_accepted_tokens_total += accepted
            for j in range(accepted + 1):
                if seq.finished is not None or seq.context.stopped:
                    break  # tokens past an accepted stop are discarded
                self._append_token(seq, int(out[i, j]))
                self.decode_tokens_total += 1

    # -------------------------------------------- deferred page reclamation

    def _release_or_defer(self, seq: Sequence) -> None:
        """Release a sequence's pages unless an in-flight window still
        writes them (freeing early could hand a page to a new owner while
        the old window's commit lands). The finish emission rides with
        the release."""
        if any(id(seq) in w.index for w in self._inflight):
            if seq not in self._deferred_free:
                self._deferred_free.append(seq)
        else:
            self._release(seq)
            self._emit_finish(seq)

    def _drain_deferred(self) -> None:
        still: List[Sequence] = []
        for seq in self._deferred_free:
            if any(id(seq) in w.index for w in self._inflight):
                still.append(seq)
            else:
                self._release(seq)
                self._emit_finish(seq)
        self._deferred_free = still

    # ------------------------------------------------------------- helpers

    def _append_token(self, seq: Sequence, tok: int, lp=None) -> None:
        """Record a generated token: emit (with its logprobs entry, when
        the request asked), check termination, commit pages."""
        seq.tokens.append(tok)
        seq.last_token = tok
        seq.generated += 1
        self._emit(seq, EngineOutput(
            token_ids=[tok], prompt_tokens=seq.num_prompt,
            logprobs=[lp[0]] if lp is not None else None,
            top_logprobs=[lp[1]] if lp is not None else None))
        filled = len(seq.tokens)
        ps = self.ecfg.page_size
        if (filled - 1) >= ps and (filled - 1) % ps == 0:
            self.pm.commit_chain(seq.pages, seq.tokens, filled - 1,
                                 chain=self._chain(seq))
        if tok in seq.stop_set:
            self._terminate(seq, FINISH_EOS)
        elif (seq.generated >= seq.max_new()
              or len(seq.tokens) >= self.cap_tokens):
            self._terminate(seq, FINISH_LENGTH)

    def _terminate(self, seq: Sequence, reason: str) -> None:
        """Terminal-state a sequence: no more tokens append from now on;
        the finish emission rides with the page release, which waits for
        any in-flight window holding the row."""
        if seq in self.running:
            self.running.remove(seq)
        if seq.finished is None:
            seq.finished = reason
        self._release_or_defer(seq)

    # ------------------------------------------- penalties and logprobs

    @staticmethod
    def _penalty_form(seqs: List[Sequence]) -> int:
        """The penalty form a batch needs: the penalty tuple when a row
        has a penalty or logit_bias, none otherwise."""
        if any(_wants_count_state(s.req.sampling) or s.req.sampling.logit_bias
               for s in seqs):
            return PEN_FULL
        return PEN_NONE

    def _penalty_state(self, seqs: List[Sequence], pad_to: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """What the device rebuilds the (counts of GENERATED tokens,
        presence over the whole context) state from, per dispatch (the
        JAX engine's stateless-per-dispatch form): each row's token ids
        [pad_to, C] (-1 padded) and its first generated position [pad_to]
        (``engine/sampling.py fill_penalty_state``)."""
        C = max(len(s.tokens) for s in seqs)
        ids = np.full((pad_to, C), -1, np.int32)
        starts = np.zeros(pad_to, np.int32)
        for i, s in enumerate(seqs):
            ids[i, :len(s.tokens)] = s.tokens
            starts[i] = s.num_prompt
        return ids, starts

    def _penalty_args(self, seqs: List[Sequence], sb: SamplingBatch,
                      pad_to: int) -> tuple:
        """The per-request part of the sampler's penalty tuple, as
        ``PenaltyBuffers.upload`` takes it: (rep, freq, pres [pad_to]
        float32, the rows' logit_bias entries: [2, N] int32 (row, token
        id) and [N] float32 values)."""
        at, vals = [np.zeros((2, 0), np.int32)], [np.zeros(0, np.float32)]
        for i, s in enumerate(seqs):
            if s.req.sampling.logit_bias:
                toks, v = self._bias_entries(s)
                at.append(np.stack([np.full_like(toks, i), toks]))
                vals.append(v)
        return (sb.rep.astype(np.float32), sb.freq.astype(np.float32),
                sb.pres.astype(np.float32), np.concatenate(at, axis=1),
                np.concatenate(vals))

    def _bias_entries(self, seq: Sequence) -> Tuple[np.ndarray, np.ndarray]:
        """Per-sequence logit_bias entries (token ids [n] int32, each
        once, and their biases [n] float32), built once and cached on the
        Sequence (the map is fixed per request; only the batch assembly
        runs per dispatch). Ids outside the vocabulary are dropped."""
        if seq._bias is None:
            V = self.cfg.vocab_size
            bias = {int(t): float(v)
                    for t, v in (seq.req.sampling.logit_bias or {}).items()
                    if 0 <= int(t) < V}
            seq._bias = (np.fromiter(bias, np.int32, len(bias)),
                         np.fromiter(bias.values(), np.float32, len(bias)))
        return seq._bias

    @staticmethod
    def _wants_logprobs(seqs: List[Sequence]) -> bool:
        return any(s.req.output.logprobs is not None for s in seqs)

    @staticmethod
    def _lp_entry(seq: Sequence, aux, i: int, j: Optional[int] = None):
        """(logprob, {token_id: logprob, ...}) for row i (step j in a
        window); None unless this sequence asked for logprobs."""
        if aux is None or seq.req.output.logprobs is None:
            return None
        lp, tv, ti = aux
        if j is None:
            chosen, vals, ids = lp[i], tv[i], ti[i]
        else:
            chosen, vals, ids = lp[i, j], tv[i, j], ti[i, j]
        topn = min(int(seq.req.output.logprobs), len(ids))
        top = {int(t): float(v) for t, v in zip(ids[:topn], vals[:topn])}
        return float(chosen), top

    def _chain(self, seq: Sequence) -> List[int]:
        if seq.hash_cache is None:
            seq.hash_cache = ChainHashCache(self.ecfg.page_size)
        return seq.hash_cache.extend(seq.tokens)

    def _commit_full_pages(self, seq: Sequence) -> None:
        self.pm.commit_chain(seq.pages, seq.tokens, seq.prefill_extent,
                             chain=self._chain(seq))

    def _release(self, seq: Sequence) -> None:
        if seq.hold_pages:
            return  # disagg prefill-only: caller extracts, then releases
        if seq.pages:
            self.pm.release_sequence(seq.pages)
            seq.pages = []

    def _finish(self, seq: Sequence, reason: str) -> None:
        if seq.finished is None:
            seq.finished = reason
        self._emit_finish(seq)

    def _emit_finish(self, seq: Sequence) -> None:
        if seq.finish_emitted or seq.finished is None:
            return
        seq.finish_emitted = True
        # e2e: arrival → finish emission (cancel and error finishes too)
        self.latency.observe("e2e", time.monotonic() - seq.arrival)
        cost = self._attribution(seq)
        profiling.record_attribution(seq.context.id, cost)
        self._emit(seq, EngineOutput(token_ids=[],
                                     finish_reason=seq.finished,
                                     prompt_tokens=seq.num_prompt,
                                     completion_tokens=seq.generated,
                                     cost=cost))

    def _account_dispatch(self, batch: List[Sequence]) -> None:
        """Cost attribution: each dispatch shares exactly 1.0 step across
        its rows (occupancy weighting), so the rows' shares sum to
        ``batch_dispatches_total``. Host counters only."""
        share = 1.0 / len(batch)
        for seq in batch:
            seq.dispatch_share += share
            seq.dispatches += 1
            if len(seq.pages) > seq.max_pages:
                seq.max_pages = len(seq.pages)
        self.batch_dispatches_total += 1

    def _attribution(self, seq: Sequence) -> dict:
        """The request's cost block (``jax_engine.py`` ``_attribution``):
        where its share of the engine's time and memory went.
        ``device_ms_est`` scales the step share by the sampled mean
        device time a dispatch (None until something was sampled);
        ``restore_wait_ms`` is admission -> the row's host-tier restores
        landed."""
        est = self.profiler.mean_device_ms_per_step()
        ps = self.ecfg.page_size
        return {
            "queue_wait_ms": round(seq.queue_wait_s * 1000.0, 3),
            "device_step_share": round(seq.dispatch_share, 6),
            "dispatches": seq.dispatches,
            "prompt_tokens": seq.num_prompt,
            "prefix_hit_tokens": seq.prefix_hit,
            "prompt_blocks": (seq.num_prompt + ps - 1) // ps,
            "device_hit_blocks": seq.device_hit_blocks,
            "host_restored_blocks": seq.host_restored_blocks,
            "restore_wait_ms": round(seq.restore_wait_s * 1000.0, 3),
            "decode_tokens": seq.generated,
            "kv_pages_peak": seq.max_pages,
            "kv_bytes_peak": seq.max_pages * self._page_bytes,
            "device_ms_est": (round(seq.dispatch_share * est, 3)
                              if est is not None else None),
            "finish_reason": seq.finished,
            "replica": self.worker_label,
            "mesh_shape": self.mesh_shape,
        }

    def _emit(self, seq: Sequence, out: EngineOutput) -> None:
        if out.token_ids:
            # the first token-bearing emission is TTFT; later gaps are
            # per-token ITL (an n-token window emission records n gaps of
            # gap/n). Host clock reads only.
            now = time.monotonic()
            if seq.last_emit_t is None:
                self.latency.observe("ttft", now - seq.arrival)
            else:
                n = len(out.token_ids)
                self.latency.observe("itl", (now - seq.last_emit_t) / n, n)
            seq.last_emit_t = now
        # steps run in the executor thread; asyncio.Queue is not
        # thread-safe, so route puts through the loop
        tid = self._aio_loop_tid
        if tid is None or threading.get_ident() == tid:
            seq.out.put_nowait(out)
        else:
            self._aio_loop.call_soon_threadsafe(seq.out.put_nowait, out)

    # ------------------------------------------------- disaggregation plane
    # The JAX engine's primitives for prefill/decode disaggregation
    # (``jax_engine.py`` ``reserve_remote`` ... ``submit_prefilled``): the
    # prefill side computes a prompt's KV and hands its pages out as host
    # tensors [L, n, KV, page_size, hd]; the decode side reserves pages,
    # takes the shipped pages in place into its pool, and decodes on.
    # With a host tier, each hand-over drains it fully first, as the JAX
    # engine's do: no scheduler drain is sure to run in between.

    def _single_rank(self, what: str) -> None:
        """Refuse a page transfer this engine cannot make: at tp > 1, and
        on an MLA model (ROADMAP.md note E)."""
        if self.cfg.is_mla:
            raise NotImplementedError(
                f"{what} on an MLA model: the transfer frame carries one "
                f"page shape for K and V, and the latent and rope pools "
                f"differ in width (ROADMAP.md note E)")
        if self.mesh is not None and self.mesh.size > 1:
            raise NotImplementedError(
                f"{what} at tp > 1: each rank holds only its heads of the "
                f"pool (ROADMAP.md queue 1 item 11)")

    async def reserve_remote(self, token_ids: List[int]
                             ) -> Optional["RemoteReservation"]:
        """Decode-side page reservation for a remote prefill: claims pages
        covering the prompt (reusing the longest cached prefix) without
        admitting a sequence. None when the pool is full, or when the
        prompt reaches the context capacity (as ``_admit`` refuses it: a
        reservation past the largest page bucket would need a capture
        once the sequence decodes)."""
        if len(token_ids) >= self.cap_tokens:
            return None

        def _do():
            with self._pm_lock:
                alloc = self.pm.allocate_sequence(token_ids)
            if alloc is None:
                return None
            if alloc.restores:
                # its host-tier hits must be in the pool before
                # submit_prefilled decodes on them
                self._drain_kv_tier(full=True)
            return RemoteReservation(pages=alloc[0], cached_tokens=alloc[1],
                                     page_size=self.ecfg.page_size)

        return await asyncio.get_running_loop().run_in_executor(
            self._exec, self._on_stream, _do)

    async def release_pages(self, pages: List[int]) -> None:
        """Return pages claimed by reserve_remote()/prefill_only()."""

        def _do():
            with self._pm_lock:
                self.pm.release_sequence(list(pages))

        await asyncio.get_running_loop().run_in_executor(self._exec, _do)

    def _gather(self, page_ids: List[int], drain: bool = False):
        """Executor thread, engine stream: enqueue the gather of the
        pages out of both pools and their copy to pinned host memory;
        returns ([k, v], event), valid once the event has completed.
        ``drain`` first drains the host tier fully (restored pages in
        the pool, and evicted ones offloaded before anything reads or
        overwrites them)."""
        if drain:
            self._drain_kv_tier(full=True)
        idx = to_device(np.asarray(page_ids, np.int64), self.device)
        return to_host(self.kv_k.index_select(1, idx),
                       self.kv_v.index_select(1, idx))

    @staticmethod
    def _landed(host: List[torch.Tensor], event) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
        if event is not None:
            event.synchronize()
        return host[0], host[1]

    async def extract_pages(self, page_ids: List[int]
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gather KV pages to host memory: (k, v) CPU tensors of shape
        [L, n, KV, page_size, hd] in the pool's dtype. Runs on the
        executor and the engine's stream, so it is ordered after any
        window or chunk in flight and before the next one."""
        self._single_rank("extract_pages")
        loop = asyncio.get_running_loop()
        host, event = await loop.run_in_executor(
            self._exec, self._on_stream, self._gather, list(page_ids), True)
        return await loop.run_in_executor(None, self._landed, host, event)

    async def extract_pages_chunked(self, page_ids: List[int],
                                    chunk_pages: int):
        """Ranged extract for the streaming transfer plane: yields
        ``(offset, k, v, seconds)`` per ``chunk_pages``-sized slice of
        ``page_ids``. Slice i+1's gather and device-to-host copy are
        enqueued before slice i is yielded, so they run under whatever
        the consumer does with slice i (compress, socket write).
        ``seconds`` is the time this chunk cost the consumer: the
        extract stage of the transfer breakdown."""
        self._single_rank("extract_pages_chunked")
        loop = asyncio.get_running_loop()
        cp = max(int(chunk_pages), 1)
        slices = [list(page_ids[i:i + cp])
                  for i in range(0, len(page_ids), cp)]
        if not slices:
            return
        t0 = time.monotonic()
        pending = await loop.run_in_executor(self._exec, self._on_stream,
                                             self._gather, slices[0], True)
        for i in range(len(slices)):
            nxt = (loop.run_in_executor(self._exec, self._on_stream,
                                        self._gather, slices[i + 1])
                   if i + 1 < len(slices) else None)
            k, v = await loop.run_in_executor(None, self._landed, *pending)
            yield i * cp, k, v, time.monotonic() - t0
            t0 = time.monotonic()
            if nxt is not None:
                pending = await nxt

    async def inject_pages(self, page_ids: List[int], k: torch.Tensor,
                           v: torch.Tensor) -> None:
        """Write host KV pages [L, n, KV, page_size, hd] (CPU tensors)
        into the pool at ``page_ids``, in place: the graphs were captured
        on these pools, so they are never rebound. Returns once the
        host-to-device copy has landed (the caller may free the host
        buffers and start decoding on the pages)."""
        self._single_rank("inject_pages")

        def _do():
            # evictions queued when these pages were reserved offload
            # their old content before this inject overwrites it
            self._drain_kv_tier(full=True)
            idx = to_device(np.asarray(page_ids, np.int64), self.device)
            for pool, rows in ((self.kv_k, k), (self.kv_v, v)):
                if self.device.type == "cuda":
                    rows = rows.contiguous().pin_memory().to(
                        self.device, non_blocking=True)
                pool.index_copy_(1, idx, rows.to(pool.dtype))
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()

        await asyncio.get_running_loop().run_in_executor(
            self._exec, self._on_stream, _do)

    async def prefill_only(self, request: PreprocessedRequest,
                           context: Context) -> Tuple[int, List[int]]:
        """Prefill worker path: compute the prompt's KV and sample the
        first token, holding the pages for extraction. Returns
        (first_token, page_ids); the caller MUST release_pages(page_ids)
        when done. The job finishes on its first token (``max_tokens``
        1), so it never enters a decode window; its finish is emitted
        where the scheduler would have released its pages."""
        import copy

        self._single_rank("prefill_only")
        req = copy.copy(request)
        req.stop = copy.copy(request.stop)
        req.stop.max_tokens = 1
        self.start()
        seq = Sequence(req=req, context=context, out=asyncio.Queue(),
                       tokens=list(req.token_ids),
                       num_prompt=len(req.token_ids), hold_pages=True)
        if seq.num_prompt == 0:
            raise ValueError("empty prompt")
        self.waiting.append(seq)
        self._wake.set()
        first: Optional[int] = None
        while True:
            out: EngineOutput = await seq.out.get()
            if out.token_ids:
                first = out.token_ids[0]
            if out.finish_reason is not None:
                break
        if first is None:
            # failed before sampling: nothing to extract, so return the
            # held pages here (hold_pages disabled the engine's release)
            if seq.pages:
                await self.release_pages(seq.pages)
                seq.pages = []
            raise RuntimeError(f"prefill produced no token "
                               f"({out.finish_reason})")
        return first, seq.pages

    async def submit_prefilled(self, request: PreprocessedRequest,
                               context: Context, pages: List[int],
                               first_token: int) -> Sequence:
        """Decode-side entry after a remote prefill: the reserved pages
        now hold the prompt's KV (inject_pages); the sequence enters
        decode with the remotely sampled first token already emitted. Its
        first window takes its inputs from the host (it is in no window's
        carry), and its full prompt pages are published to the prefix
        cache (and so as KV events)."""
        if not isinstance(request, PreprocessedRequest):
            request = PreprocessedRequest.from_dict(request)
        if len(request.token_ids) >= self.cap_tokens:
            raise ValueError(
                f"prompt length {len(request.token_ids)} exceeds engine "
                f"context capacity {self.cap_tokens} (reserve_remote would "
                f"have refused this reservation)")
        self.start()
        seq = Sequence(req=request, context=context, out=asyncio.Queue(),
                       tokens=list(request.token_ids),
                       num_prompt=len(request.token_ids))
        seq.pages = list(pages)
        seq.computed = seq.num_prompt

        def _do():
            self.prompt_tokens_total += seq.num_prompt
            # the decode side's hits were counted by reserve_remote: the
            # window takes this admission with none, as the totals do
            self._hit_window.append((0, seq.num_prompt))
            with self._pm_lock:
                self._commit_full_pages(seq)
                self._append_token(seq, int(first_token))
            # joins running between steps (this runs on the executor)
            if seq.finished is None:
                self.running.append(seq)

        await asyncio.get_running_loop().run_in_executor(self._exec, _do)
        self._wake.set()
        return seq


def _make_decode_multi(model, cfg: ModelConfig, max_top_k: int,
                       mesh: Optional[MeshView] = None):
    """The generic fused K-step decode window (``jax_engine.py``
    ``_make_decode_multi``), for model modules without
    ``make_decode_window_fn`` (MLA): K full forwards of one token a row,
    each writing its row's K/V into the pool at its position (stopped and
    padding rows write ``DROP_SLOT``, so nothing lands in their pages),
    an on-device draw after each, and the sequence carry (tok, pos, done,
    steps, remaining) kept on the device. It has the signature of
    ``models/llama.py make_decode_window_fn``'s window, so
    ``engine/cuda_graphs.py DecodeGraphs`` captures it in every variant
    (logprobs, the penalty forms) unchanged. Reads nothing on the host."""
    # the sampler's functions as they are when the window is built (as
    # models/llama.py's window takes them)
    from .sampling import logprob_aux, sample_tokens, update_penalty_state

    @torch.no_grad()
    def decode_multi(params, tokens, positions, done, steps, remaining,
                     kv_k, kv_v, page_table, temperature, top_k, top_p,
                     seeds, eos_table, penalties=None, *, k_steps: int,
                     logprobs_topn: int = 0):
        B = tokens.shape[0]
        ps, P = kv_k.shape[3], page_table.shape[1]
        rows = torch.arange(B, device=tokens.device)
        tok, pos = tokens, positions
        toks, lps, tvs, tis = [], [], [], []
        emitted = torch.zeros((B,), dtype=torch.int32, device=tokens.device)
        for _ in range(k_steps):
            active = carry_active(done, pos)
            page = page_table[rows, torch.clamp(torch.div(
                pos, ps, rounding_mode="floor"), 0, P - 1)]
            slot = torch.where(active, page * ps + pos % ps,
                               torch.full_like(page, DROP_SLOT))
            h, kv_k, kv_v = model.forward(
                params, cfg, tok[:, None], pos[:, None], kv_k, kv_v,
                page_table, slot[:, None], mesh=mesh)
            logits = project_logits(params, cfg, h[:, 0], mesh)
            nxt = sample_tokens(logits, temperature, top_k, top_p, seeds,
                                steps, max_top_k=max_top_k,
                                penalties=penalties)
            if logprobs_topn:
                lp, tv, ti = logprob_aux(logits, nxt, logprobs_topn)
                lps.append(lp)
                tvs.append(tv)
                tis.append(ti)
            penalties = update_penalty_state(penalties, nxt, done)
            emitted = emitted + active.to(torch.int32)
            tok, pos, done, steps, remaining = carry_step_update(
                nxt, tok, pos, done, steps, remaining, eos_table)
            toks.append(tok)
        out_toks = torch.stack(toks, dim=1)
        carry = (tok, pos, done, steps, remaining)
        if logprobs_topn:
            aux = (torch.stack(lps, dim=1), torch.stack(tvs, dim=1),
                   torch.stack(tis, dim=1))
            return out_toks, emitted, aux, carry, kv_k, kv_v
        return out_toks, emitted, carry, kv_k, kv_v

    return decode_multi


@dataclass
class RemoteReservation:
    """Decode-side pages claimed ahead of a remote prefill."""

    pages: List[int]
    cached_tokens: int  # prompt tokens already covered by the prefix cache
    page_size: int

    @property
    def skip_pages(self) -> int:
        """Leading pages the prefill worker need not transfer (already
        valid on the decode side through prefix-cache hits)."""
        return self.cached_tokens // self.page_size
