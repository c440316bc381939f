"""Decode-side disaggregation (``dynamo_tpu/llm/disagg/decode.py``).

Per request: ask the disagg router with (prefill length, prefix hit);
remote -> reserve decode-side KV pages, enqueue a RemotePrefillRequest,
wait for the prefill worker's page write and first token, then decode
on locally. It falls back to a local prefill whenever the pool is full,
the queue is saturated, or the remote path fails.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import AsyncIterator, Optional

from ...runtime import guard, tracing
from ...runtime.config import env_float, env_int
from ...runtime.engine import Context
from ..protocols.common import EngineOutput, PreprocessedRequest
from .protocols import RemotePrefillRequest
from .queue import PrefillQueue
from .router import DisaggRouter
from .transfer import KvTransferServer

log = logging.getLogger("dynamo_tpu_torch.llm.disagg")


async def _drain_seq(seq) -> AsyncIterator[EngineOutput]:
    """Engine-sequence queue -> chunk stream (the remote-prefill decode
    leg)."""
    while True:
        out: EngineOutput = await seq.out.get()
        yield out
        if out.finish_reason is not None:
            return


class DisaggDecodeEngine:
    """AsyncEngine wrapper adding conditional remote prefill to a
    TorchEngine. It serves the same token-level protocol, so it drops
    into serve_token_model or the Backend pipeline unchanged. It has no
    ``pm``: a server of it starts the KV event publisher on the inner
    engine (``self.engine``)."""

    def __init__(self, engine, queue: PrefillQueue, transfer: KvTransferServer,
                 router: DisaggRouter, engine_id: int,
                 prefill_timeout: Optional[float] = None,
                 max_dispatches: Optional[int] = None):
        self.engine = engine
        if hasattr(engine, "set_role"):
            # the wrapped engine serves the decode side of the split: its
            # TTFT/ITL histograms go under role="decode"
            engine.set_role("decode")
        self.queue = queue
        self.transfer = transfer
        self.router = router
        self.engine_id = engine_id
        self.prefill_timeout = prefill_timeout if prefill_timeout is not None \
            else (env_float("DYN_PREFILL_TIMEOUT", 120.0) or 120.0)
        # hedged re-dispatch: when the transfer plane fails FAST (prefill
        # worker died mid-transfer, severed connection) and budget
        # remains, the job is re-enqueued to the shared queue, where
        # another worker picks it up, before falling back to local
        # prefill. A timeout never re-dispatches (the budget is spent)
        self.max_dispatches = max(1, max_dispatches if max_dispatches
                                  is not None
                                  else (env_int("DYN_REDISPATCH_MAX", 2)
                                        or 1))
        self.remote_prefills = 0
        self.local_prefills = 0
        self.remote_fallbacks = 0
        self.redispatches = 0
        # the remote leg seen from the decode side: enqueue -> KV landed
        # and first token (queue wait + prefill compute + page transfer)
        self.remote_wait_total_s = 0.0

    def stats(self) -> dict:
        s = dict(self.engine.stats())
        s.update(remote_prefills=self.remote_prefills,
                 local_prefills=self.local_prefills,
                 remote_fallbacks=self.remote_fallbacks,
                 remote_redispatches=self.redispatches,
                 remote_wait_total_s=round(self.remote_wait_total_s, 3),
                 remote_prefill_wait_seconds_total=round(
                     self.remote_wait_total_s, 3))
        # the transfer plane's ingest counters
        s.update(self.transfer.stats())
        return s

    async def generate(self, request, context: Context
                       ) -> AsyncIterator[EngineOutput]:
        if not isinstance(request, PreprocessedRequest):
            request = PreprocessedRequest.from_dict(request)
        tokens = request.token_ids
        tracer = tracing.get_tracer()

        # short prompts can never go remote (prefill_len - hit <=
        # prefill_len <= threshold): skip the reservation
        res = None
        if (self.router.enabled
                and len(tokens) > self.router.max_local_prefill_length):
            res = await self.engine.reserve_remote(tokens)

        seq = None
        try:
            remote = False
            depth = None
            with tracer.start_span("route.disagg", attributes={
                    "prefill_len": len(tokens)}) as rsp:
                if res is not None:
                    depth = await self.queue.depth()
                    remote = self.router.prefill_remote(
                        len(tokens), res.cached_tokens, depth)
                    rsp.set_attribute("cached_tokens", res.cached_tokens)
                    rsp.set_attribute("queue_depth", depth)
                rsp.set_attribute("remote", remote)
            if not remote:
                if res is not None:
                    # drop ownership before awaiting: a cancellation at the
                    # await must not release again in the finally block
                    pages, res = res.pages, None
                    await self.engine.release_pages(pages)
                self.local_prefills += 1
                dsp = tracer.start_span("decode",
                                        attributes={"mode": "local"})
                async for out in self._traced(
                        dsp, self.engine.generate(request, context),
                        request.stop.max_tokens):
                    yield out
                return

            self.remote_prefills += 1
            with tracer.start_span("prefill.remote", attributes={
                    "queue_depth": depth,
                    "skip_pages": res.skip_pages}) as psp:
                first = await self._remote_prefill(request, context, res)
                psp.set_attribute("ok", first is not None)
            if first is None:  # remote failed or timed out: local fallback
                self.remote_fallbacks += 1
                pages, res = res.pages, None
                await self.engine.release_pages(pages)
                if context.stopped:
                    # deadline expiry surfaces as "timeout", caller
                    # cancellation as "cancelled"
                    yield EngineOutput(
                        finish_reason=context.cancel_reason())
                    return
                log.warning("remote prefill fell back to local for %s",
                            context.id)
                dsp = tracer.start_span("decode", attributes={
                    "mode": "local_fallback"})
                async for out in self._traced(
                        dsp, self.engine.generate(request, context),
                        request.stop.max_tokens):
                    yield out
                return

            seq = await self.engine.submit_prefilled(request, context,
                                                     res.pages, first)
            res = None  # ownership passed to the sequence
        finally:
            if res is not None and seq is None:
                # a failure between reserve and handoff must not leak pages
                await self.engine.release_pages(res.pages)

        dsp = tracer.start_span("decode", attributes={
            "mode": "remote_prefill"})
        async for out in self._traced(dsp, _drain_seq(seq),
                                      request.stop.max_tokens):
            yield out

    async def _traced(self, dsp, stream, max_tokens):
        """Relay ``stream`` under the decode span ``dsp``, ending the span
        the moment the request is observably finished: a finish chunk or
        the token budget reached. The budget mirror matters: downstream
        (the Backend) stamps max_tokens itself and abandons this
        generator right after the last token chunk, so a span ended only
        by the engine's finish chunk would linger until the generator is
        collected."""
        n_out = 0
        try:
            async for out in stream:
                n_out += len(out.token_ids)
                if out.finish_reason is not None or (
                        max_tokens is not None and n_out >= max_tokens):
                    dsp.set_attribute("tokens", n_out)
                    if out.finish_reason is not None:
                        dsp.set_attribute("finish", out.finish_reason)
                    dsp.end()  # idempotent; before the abandonable yield
                yield out
        finally:
            dsp.end()

    async def _remote_prefill(self, request: PreprocessedRequest,
                              context: Context, res) -> Optional[int]:
        """Enqueue and await the KV arrival; returns the first token or
        None.

        The wait is bounded by ``min(prefill_timeout, request
        deadline)``. A FAST failure (the transfer plane fails the waiter:
        prefill worker died mid-transfer, severed connection, ingest
        error) is hedged: while dispatches and budget remain, the job is
        re-enqueued to the shared queue for another worker. A timeout
        falls straight back to local prefill."""
        t0 = time.monotonic()
        deadline = context.deadline
        for dispatch in range(self.max_dispatches):
            fut = self.transfer.expect(context.id)
            await self.queue.put(RemotePrefillRequest(
                request_id=context.id,
                token_ids=list(request.token_ids),
                sampling=request.sampling.to_dict(),
                eos_token_ids=list(request.eos_token_ids),
                page_ids=list(res.pages),
                skip_pages=res.skip_pages,
                engine_id=self.engine_id,
                # join the prefill worker's spans to this request's trace
                # (None when not sampled: the field is absent on the wire)
                trace_ctx=tracing.get_tracer().current_trace_ctx(),
                deadline_ms=(deadline.to_wire_ms()
                             if deadline is not None else None),
            ))
            try:
                first = await guard.bound(fut, timeout=self.prefill_timeout,
                                          deadline=deadline,
                                          what="remote prefill")
                self.remote_wait_total_s += time.monotonic() - t0
                return first
            except asyncio.TimeoutError:
                # DeadlineExceeded too: the budget is spent (or the
                # prefill pool is too slow): no hedge, fall back
                self.transfer.cancel(context.id)
                return None
            except asyncio.CancelledError:
                # handler task cancelled: cancel the waiter and propagate;
                # generate()'s finally releases the reserved pages
                self.transfer.cancel(context.id)
                raise
            except Exception as exc:  # noqa: BLE001
                # fail-fast signal from the transfer plane: hedge if a
                # dispatch remains and the budget can still cover work
                self.transfer.cancel(context.id)
                if dispatch + 1 < self.max_dispatches and \
                        not (deadline is not None and deadline.expired):
                    self.redispatches += 1
                    guard.counter_inc("dyn_guard_hedged_redispatch_total")
                    log.warning("remote prefill for %s failed fast (%s); "
                                "re-enqueueing (dispatch %d/%d)",
                                context.id, exc, dispatch + 2,
                                self.max_dispatches)
                    continue
                log.warning("remote prefill failed for %s (%s); falling "
                            "back to local", context.id, exc)
                return None
        return None


async def build_disagg_decode(drt, engine, *, namespace: str = "dynamo",
                              model: str = "default",
                              router: Optional[DisaggRouter] = None,
                              watch_config: bool = True
                              ) -> DisaggDecodeEngine:
    """Wire the decode side: the transfer listener (registered under the
    worker's lease), the prefill queue handle, and the router with its
    live config watch."""
    router = router or DisaggRouter()
    if watch_config:
        await router.start_watch(drt.dcp, namespace, model)
    transfer = KvTransferServer(engine)
    await transfer.start()
    await transfer.register(drt.dcp, namespace, drt.instance_id,
                            lease=drt.primary_lease)
    queue = PrefillQueue(drt.dcp, namespace)
    return DisaggDecodeEngine(engine, queue, transfer, router,
                              drt.instance_id)
