"""The PyTorch serving engine: continuous batching over a paged KV cache.

The counterpart of ``dynamo_tpu/engine/jax_engine.py`` ``JaxEngine`` for
the dense Llama path, speaking the same token-level protocol
(``PreprocessedRequest`` in, ``EngineOutput`` chunks out) so it slots
behind ``Backend`` the same way:

- one asyncio scheduler loop owns the device; each iteration runs on a
  single worker thread: admission, then a chunked prefill over a batch of
  prompts (prefill priority), then — once nothing is left to prefill — a
  fused K-step decode window over every running sequence;
- per-request state is host-side (token lists, page tables from
  ``PageManager``); the device sees only padded arrays;
- sequences preempt (release pages, requeue) when the pool runs dry.

Decode windows run synchronously in this version: a window's tokens are
read back before the next dispatch (the JAX engine's ``pipeline_decode``
overlap, CUDA graphs, the host KV tier, speculative decoding and
disaggregation are not ported yet).
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import AsyncIterator, List, Optional, Tuple

import numpy as np
import torch

from ..llm.protocols.common import (FINISH_CANCELLED, FINISH_EOS,
                                    FINISH_LENGTH, FINISH_TIMEOUT,
                                    EngineOutput, PreprocessedRequest)
from ..models.config import ModelConfig
from ..models.llama import (DROP_SLOT, KVCacheSpec, check_supported,
                            init_kv_cache, init_params, make_decode_window_fn,
                            make_step_fns)
from ..runtime.device import resolve_device
from ..runtime.engine import Context
from .kv_manager import ChainHashCache, PageManager
from .sampling import SamplingBatch, sample_tokens

log = logging.getLogger("dynamo_tpu_torch.engine")


def _cancel_reason(ctx: Context) -> str:
    return FINISH_TIMEOUT if ctx.expired else FINISH_CANCELLED


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
    # conditions on device
    decode_steps: int = 4
    # on-device stop table width (eos + stop ids, -1 padded); rows with
    # more ids fall back to the per-token host check
    max_eos_ids: int = 8
    # bucketing: padded shapes, as the JAX engine pads them (the JAX
    # engine compiles one program per bucket; here they only fix shapes)
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
    hash_cache: Optional[ChainHashCache] = None

    @property
    def stop_set(self) -> frozenset:
        stop = self.req.stop
        eos = () if stop.ignore_eos else (self.req.eos_token_ids or ())
        return frozenset(eos) | frozenset(stop.stop_token_ids or ())

    @property
    def stop_ids(self) -> List[int]:
        """The device stop-table row (duplicates kept, as the JAX engine
        seeds it)."""
        ids: List[int] = []
        if not self.req.stop.ignore_eos:
            ids.extend(self.req.eos_token_ids or [])
        ids.extend(self.req.stop.stop_token_ids or [])
        return ids

    def max_new(self) -> int:
        mt = self.req.stop.max_tokens
        return mt if mt is not None else 1 << 30

    @property
    def prefill_extent(self) -> int:
        """Tokens whose KV must exist before decode can run: the whole
        prompt, or, resumed after preemption, everything except the final
        token (the next decode input)."""
        return self.num_prompt if self.generated == 0 else len(self.tokens) - 1


class TorchEngine:
    """AsyncEngine over the PyTorch model (token-level core engine)."""

    def __init__(self, model_cfg: ModelConfig,
                 engine_cfg: Optional[EngineConfig] = None, params=None,
                 seed: int = 0, device="cuda"):
        check_supported(model_cfg)
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.ecfg = engine_cfg or EngineConfig()
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = init_params(model_cfg, gen)
        self.params = params
        spec = KVCacheSpec(self.ecfg.num_pages, self.ecfg.page_size)
        self.kv_k, self.kv_v = init_kv_cache(model_cfg, spec,
                                             device=self.device)
        # the engine decodes in fused windows only (no K=1 decode steps)
        self.prefill_fn, _ = make_step_fns(model_cfg)
        self.decode_multi_fn = make_decode_window_fn(
            model_cfg, max_top_k=self.ecfg.max_top_k)
        self.pm = PageManager(self.ecfg.num_pages, self.ecfg.page_size)
        self.waiting: List[Sequence] = []
        self.prefilling: List[Sequence] = []
        self.running: List[Sequence] = []
        # per-sequence max context: the largest page bucket
        self.cap_pages = min(self.ecfg.page_buckets[-1],
                             max(self.ecfg.num_pages - 1, 1))
        self.cap_tokens = self.cap_pages * self.ecfg.page_size
        self._wake = asyncio.Event()
        self._loop_task: Optional[asyncio.Task] = None
        self._aio_loop: Optional[asyncio.AbstractEventLoop] = None
        self._aio_loop_tid: Optional[int] = None
        self._stopped = False
        self._exec = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="torch-step")
        self.batch_dispatches_total = 0
        self.queue_wait_seconds_total = 0.0
        self.prefill_tokens_total = 0
        self.decode_tokens_total = 0
        self.prefix_hit_tokens_total = 0
        self.prompt_tokens_total = 0

    # ---------------------------------------------------------- lifecycle

    def warmup(self) -> None:
        """Run one prefill chunk and one decode window over padding rows
        (nothing is written to the pool) so the first request does not pay
        for CUDA's lazy module loading and cuBLAS set-up."""
        ecfg = self.ecfg
        B, T = ecfg.prefill_bucket_batch(1), ecfg.prefill_chunk
        P = ecfg.bucket_pages(1)
        i32 = dict(dtype=torch.int32, device=self.device)
        self.prefill_fn(
            self.params, torch.zeros((B, T), **i32),
            torch.full((B, T), -1, **i32), self.kv_k, self.kv_v,
            torch.zeros((B, P), **i32), torch.full((B, T), DROP_SLOT, **i32),
            torch.zeros((B,), **i32))
        B = ecfg.bucket_batch(1)
        sb = SamplingBatch.build([], B)
        self.decode_multi_fn(
            self.params, torch.zeros((B,), **i32), torch.full((B,), -1, **i32),
            torch.zeros(B, dtype=torch.bool, device=self.device),
            torch.zeros((B,), **i32), torch.ones((B,), **i32), self.kv_k,
            self.kv_v, torch.zeros((B, P), **i32), sb.temperature, sb.top_k,
            sb.top_p, sb.seeds,
            torch.full((B, ecfg.max_eos_ids), -1, **i32),
            k_steps=ecfg.decode_steps)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        if self._loop_task is None:
            self._aio_loop = asyncio.get_running_loop()
            self._aio_loop_tid = threading.get_ident()
            self._loop_task = asyncio.ensure_future(self._loop())

    async def stop(self) -> None:
        self._stopped = True
        self._wake.set()
        if self._loop_task:
            await self._loop_task
        self._exec.shutdown(wait=True)

    # ------------------------------------------------------ AsyncEngine API

    async def generate(self, request: PreprocessedRequest,
                       context: Context) -> AsyncIterator[EngineOutput]:
        if not isinstance(request, PreprocessedRequest):
            request = PreprocessedRequest.from_dict(request)
        self.start()
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
        return {
            "batch_dispatches_total": self.batch_dispatches_total,
            "kv_free_blocks": len(self.pm.free),
            "kv_cached_blocks": len(self.pm.reusable),
            "request_active_slots": len(self.running) + len(self.prefilling),
            "request_total_slots": self.ecfg.max_batch,
            "kv_active_blocks": self.pm.active,
            "kv_total_blocks": self.ecfg.num_pages - 1,
            "num_requests_waiting": len(self.waiting),
            "queue_wait_seconds_total": round(self.queue_wait_seconds_total,
                                              4),
            "gpu_cache_usage_perc": self.pm.usage(),
            "gpu_prefix_cache_hit_rate_lifetime":
                (self.prefix_hit_tokens_total /
                 max(self.prompt_tokens_total, 1)),
            "prefix_hit_tokens_total": self.prefix_hit_tokens_total,
            "prompt_tokens_total": self.prompt_tokens_total,
        }

    # ------------------------------------------------------- scheduler loop

    async def _loop(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._stopped:
            if not (self.waiting or self.prefilling or self.running):
                self._wake.clear()
                await self._wake.wait()
                continue
            try:
                await loop.run_in_executor(self._exec, self._step)
                self.running = [s for s in self.running if s.finished is None]
            except Exception:  # noqa: BLE001 — engine loop must survive
                log.exception("engine step failed")
                await loop.run_in_executor(self._exec, self._abort_all)

    def _step(self) -> None:
        """One scheduler iteration (executor thread), prefill priority:
        prompts waiting to prefill go first; a decode window runs once
        nothing is left to prefill."""
        self._admit()
        if self.prefilling:
            self._dispatch_prefill()
        if self.running and not self.prefilling:
            self._dispatch_decode_window()

    def _abort_all(self) -> None:
        """Error path: release everything, fail all in-flight requests."""
        for seq in self.prefilling + self.running:
            self._release(seq)
            self._finish(seq, "error")
        self.prefilling.clear()
        self.running.clear()

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
            alloc = self.pm.allocate_sequence(seq.tokens,
                                              chain=self._chain(seq))
            if alloc is None or self.pm.available < self.ecfg.watermark_pages:
                if alloc is not None:
                    self.pm.release_sequence(alloc[0])
                break  # out of pages; wait for frees
            self.waiting.pop(0)
            pages, cached_tokens = alloc
            seq.pages = pages
            seq.computed = min(cached_tokens, seq.prefill_extent)
            if seq.generated == 0:  # don't double-count resumed sequences
                self.queue_wait_seconds_total += time.monotonic() - seq.arrival
                self.prefix_hit_tokens_total += seq.computed
                self.prompt_tokens_total += seq.num_prompt
            self.prefilling.append(seq)

    # ------------------------------------------------------------- prefill

    def _dispatch_prefill(self) -> None:
        """One chunked-prefill step over a BATCH of prefilling sequences
        (each contributes its next chunk); rows that complete their prompt
        sample their first token."""
        candidates: List[Sequence] = []
        for seq in list(self.prefilling):
            if seq.context.stopped:
                self.prefilling.remove(seq)
                self._terminate(seq, _cancel_reason(seq.context))
                continue
            if seq.prefill_extent - seq.computed <= 0:
                # resumed sequence fully covered by the prefix cache
                self.prefilling.remove(seq)
                seq.last_token = seq.tokens[-1]
                self.running.append(seq)
                continue
            candidates.append(seq)
        if not candidates:
            return
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
        chunks = [min(s.prefill_extent - s.computed, ecfg.prefill_chunk)
                  for s in batch]
        B = ecfg.prefill_bucket_batch(len(batch))
        T = ecfg.bucket_len(max(chunks))
        P = ecfg.bucket_pages(max(len(s.pages) for s in batch))
        ps = ecfg.page_size

        tokens = np.zeros((B, T), np.int32)
        positions = np.full((B, T), -1, np.int32)
        table = np.zeros((B, P), np.int32)
        last_idx = np.zeros(B, np.int32)
        use_paged = T % ps == 0 and all(s.computed % ps == 0 for s in batch)
        slots = np.full((B, T), DROP_SLOT, np.int32)
        pslots = np.full((B, max(T // ps, 1)), ecfg.num_pages, np.int32)
        for i, (seq, chunk) in enumerate(zip(batch, chunks)):
            start = seq.computed
            tokens[i, :chunk] = seq.tokens[start:start + chunk]
            positions[i, :chunk] = np.arange(start, start + chunk)
            pages = np.asarray(seq.pages, np.int64)
            table[i, :len(seq.pages)] = seq.pages
            last_idx[i] = chunk - 1
            pos = np.arange(start, start + chunk)
            slots[i, :chunk] = pages[pos // ps] * ps + pos % ps
            if use_paged:
                first = start // ps
                npg = (chunk + ps - 1) // ps
                pslots[i, :npg] = pages[first:first + npg]

        logits, self.kv_k, self.kv_v = self.prefill_fn(
            self.params, self._dev(tokens), self._dev(positions), self.kv_k,
            self.kv_v, self._dev(table), self._dev(slots),
            self._dev(last_idx), self._dev(pslots) if use_paged else None)
        self.batch_dispatches_total += 1

        finishing: List[Tuple[int, Sequence]] = []
        for i, (seq, chunk) in enumerate(zip(batch, chunks)):
            seq.computed += chunk
            self.prefill_tokens_total += chunk
            if seq.computed >= seq.prefill_extent:
                self.prefilling.remove(seq)
                finishing.append((i, seq))
        if not finishing:
            return
        toks = None
        if any(s.generated == 0 for _, s in finishing):
            toks = self._sample(batch, logits).tolist()
        for i, seq in finishing:
            self._commit_full_pages(seq)
            if seq.generated == 0:
                self._append_token(seq, int(toks[i]))
                if seq.finished is None:
                    self.running.append(seq)
            else:
                # resumed after preemption: next token already sampled
                seq.last_token = seq.tokens[-1]
                self.running.append(seq)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _sample(self, seqs: List[Sequence], logits) -> torch.Tensor:
        """First-token draw over the padded prefill batch."""
        pad_to = logits.shape[0]
        sb = SamplingBatch.build([s.req.sampling for s in seqs], pad_to)
        steps = np.zeros(pad_to, np.int32)
        steps[:len(seqs)] = [s.generated for s in seqs]
        return sample_tokens(logits, sb.temperature, sb.top_k, sb.top_p,
                             sb.seeds, steps, max_top_k=self.ecfg.max_top_k)

    # -------------------------------------------------------------- decode

    def _grow_or_preempt(self, batch: List[Sequence], lookahead: int) -> None:
        """Grow every batch member's pages ``lookahead`` tokens ahead
        (clamped to the capacity); on pool exhaustion preempt the newest
        sequences until the batch fits."""
        for seq in list(batch):
            if seq not in batch:
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

    def _dispatch_decode_window(self) -> None:
        """Run one fused K-step decode window over the running batch and
        read its tokens back (synchronous)."""
        K = self.ecfg.decode_steps
        for seq in list(self.running):
            if seq.context.stopped:
                self._terminate(seq, _cancel_reason(seq.context))
        batch = [s for s in self.running if s.finished is None]
        batch = batch[:self.ecfg.max_batch]
        if not batch:
            return
        self._grow_or_preempt(batch, K)
        if not batch:
            return
        B = self.ecfg.bucket_batch(len(batch))
        P = self.ecfg.bucket_pages(max(len(s.pages) for s in batch))
        E = self.ecfg.max_eos_ids
        table = np.zeros((B, P), np.int32)
        eos = np.full((B, E), -1, np.int32)
        tok = np.zeros(B, np.int32)
        pos = np.full(B, -1, np.int32)
        steps = np.zeros(B, np.int32)
        rem = np.ones(B, np.int32)
        for i, seq in enumerate(batch):
            table[i, :len(seq.pages)] = seq.pages
            ids = seq.stop_ids
            if ids:
                eos[i, :min(len(ids), E)] = ids[:E]
            tok[i] = seq.last_token
            pos[i] = len(seq.tokens) - 1
            steps[i] = seq.generated
            rem[i] = max(min(seq.max_new() - seq.generated,
                             self.cap_tokens - len(seq.tokens)), 1)
        sb = SamplingBatch.build([s.req.sampling for s in batch], B)
        toks, emitted, carry, self.kv_k, self.kv_v = self.decode_multi_fn(
            self.params, self._dev(tok), self._dev(pos),
            torch.zeros(B, dtype=torch.bool, device=self.device),
            self._dev(steps), self._dev(rem), self.kv_k, self.kv_v,
            self._dev(table), sb.temperature, sb.top_k, sb.top_p, sb.seeds,
            self._dev(eos), k_steps=K)
        self.batch_dispatches_total += 1
        self._process_window(batch, toks.cpu().numpy(),
                             emitted.cpu().numpy(), carry[2].cpu().numpy())

    def _process_window(self, batch: List[Sequence], toks: np.ndarray,
                        counts: np.ndarray, done: np.ndarray) -> None:
        """Host bookkeeping for a window's tokens: emission, stop
        conditions, prefix commits. Rows whose stop ids all fit the device
        table take the device's emitted count and done flag; others check
        stops token by token."""
        K = toks.shape[1]
        for i, seq in enumerate(batch):
            if seq.finished is not None:
                continue
            if (not seq.context.stopped
                    and len(seq.stop_ids) <= self.ecfg.max_eos_ids):
                self._append_row(seq, toks[i], int(counts[i]), bool(done[i]))
                continue
            for j in range(K):
                if seq.finished is not None or seq.context.stopped:
                    break  # tokens past EOS/stop are discarded
                self._append_token(seq, int(toks[i, j]))
                self.decode_tokens_total += 1

    def _append_row(self, seq: Sequence, row: np.ndarray, n: int,
                    dev_done: bool) -> None:
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
        self._emit(seq, EngineOutput(token_ids=ids,
                                     prompt_tokens=seq.num_prompt))
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

    # ------------------------------------------------------------- helpers

    def _append_token(self, seq: Sequence, tok: int) -> None:
        """Record a generated token: emit, check termination, commit
        pages."""
        seq.tokens.append(tok)
        seq.last_token = tok
        seq.generated += 1
        self._emit(seq, EngineOutput(token_ids=[tok],
                                     prompt_tokens=seq.num_prompt))
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
        """Terminal-state a sequence: release its pages, emit its finish."""
        if seq in self.running:
            self.running.remove(seq)
        self._release(seq)
        self._finish(seq, reason)

    def _chain(self, seq: Sequence) -> List[int]:
        if seq.hash_cache is None:
            seq.hash_cache = ChainHashCache(self.ecfg.page_size)
        return seq.hash_cache.extend(seq.tokens)

    def _commit_full_pages(self, seq: Sequence) -> None:
        self.pm.commit_chain(seq.pages, seq.tokens, seq.prefill_extent,
                             chain=self._chain(seq))

    def _release(self, seq: Sequence) -> None:
        if seq.pages:
            self.pm.release_sequence(seq.pages)
            seq.pages = []

    def _finish(self, seq: Sequence, reason: str) -> None:
        if seq.finished is None:
            seq.finished = reason
        if not seq.finish_emitted:
            seq.finish_emitted = True
            self._emit(seq, EngineOutput(token_ids=[],
                                         finish_reason=seq.finished,
                                         prompt_tokens=seq.num_prompt,
                                         completion_tokens=seq.generated))

    def _emit(self, seq: Sequence, out: EngineOutput) -> None:
        # steps run in the executor thread; asyncio.Queue is not
        # thread-safe, so route puts through the loop
        tid = self._aio_loop_tid
        if tid is None or threading.get_ident() == tid:
            seq.out.put_nowait(out)
        else:
            self._aio_loop.call_soon_threadsafe(seq.out.put_nowait, out)
