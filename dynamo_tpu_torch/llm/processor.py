"""Frontend-side processor, a copy of ``dynamo_tpu/llm/processor.py``:
tokenize -> KV-route -> worker -> detokenize.

The Processor lowers the OpenAI request with the model card's tokenizer,
asks the :class:`KvRouter` for a worker, calls the worker's token-level
endpoint with ``direct()`` routing (falling back to the retry policy's
round-robin path, counted, when the pick is gone), and maps the token
stream back to OpenAI chunks through the detokenizing Backend. When the
worker dies mid-stream, the request resumes on a sibling
(``runtime/revive.py``): the prompt plus the tokens already emitted is
routed again with the dead worker excluded, and the continuation is
spliced into the same stream.
"""

from __future__ import annotations

import asyncio
import logging
import time
import uuid
from typing import AsyncIterator, Optional

from ..runtime import guard, revive
from ..runtime.component import Client
from ..runtime.dcp_client import NoRespondersError
from ..runtime.engine import Context
from .backend import Backend
from .kv_router.router import KvRouter
from .model_card import ModelDeploymentCard
from .preprocessor import OpenAIPreprocessor, completion_logprobs
from .protocols.common import EngineOutput, PreprocessedRequest
from .protocols.openai import (ChatCompletionRequest, CompletionRequest,
                               _finish_reason_openai)

log = logging.getLogger("dynamo_tpu_torch.processor")


class _RemoteTokenEngine:
    """Adapts a worker's token-level endpoint to the local engine shape
    so the Backend can detokenize the remote stream.

    The adapter journals every token it forwards and, when
    the upstream dies before a finish chunk (worker crash, connection
    drop, breaker churn), re-dispatches ``prompt + emitted_tokens`` to a
    sibling worker — ``reroute`` lets the KV router pick the replica
    with the warmest prefix, excluding the dead one — and splices the
    continuation into the SAME stream. Greedy requests resume
    token-identical; no single worker failure becomes a client-visible
    error while siblings are alive and budget remains.
    """

    def __init__(self, client: Client, worker_id: Optional[int],
                 reroute=None):
        self.client = client
        self.worker_id = worker_id
        # async (token_ids, exclude) -> Optional[worker_id]; None falls
        # back to the policy-equipped round-robin path
        self.reroute = reroute

    async def _dispatch(self, request: PreprocessedRequest,
                        context: Context, worker_id: Optional[int]):
        """Route the request: the KV-routed direct pick first, then the
        retry policy's round-robin path (``Client.generate``
        retries under the policy, budget-aware, with per-instance
        breakers). The fallback is counted — not silent — as
        ``dyn_llm_route_fallback_total``."""
        if worker_id is not None:
            try:
                return await self.client.direct(request.to_dict(),
                                                worker_id,
                                                context=context)
            except guard.DeadlineExceeded:
                raise
            except (RuntimeError, NoRespondersError) as e:
                # the routed worker vanished between the router's scrape
                # and the direct call (drain/crash churn), or its breaker
                # is open: any live worker beats a 500 — the
                # prefix-overlap win is gone, correctness is not
                guard.counter_inc("dyn_llm_route_fallback_total",
                                  reason=type(e).__name__)
                log.warning("direct route to %x failed (%s); falling "
                            "back to round-robin", worker_id, e)
        return await self.client.round_robin(request.to_dict(),
                                             context=context)

    async def _run_attempt(self, request: PreprocessedRequest,
                           context: Context, session: revive.ReviveSession,
                           worker_id: Optional[int]):
        """One upstream dispatch: journal + forward every chunk. Raises
        the upstream failure for the failover loop to judge."""
        stream = await self._dispatch(request, context, worker_id)
        # the moment the caller kills this request (SSE client dropped,
        # deadline path), sever the call-home conn synchronously — the
        # worker's ctrl loop maps the drop to ctx.kill(), so the engine
        # cancels and frees pages without waiting for this (possibly
        # abandoned) generator to be finalized
        context.on_kill(stream.close)
        killed_sync = False
        try:
            async for env in stream:
                if env.is_error:
                    raise RuntimeError(env.error_message())
                if env.data is not None:
                    out = EngineOutput.from_dict(env.data)
                    session.observe(out)
                    if session.resumes and out.cost is not None:
                        # the finish cost block names the resume so
                        # /v1/traces/{rid} and usage show the failover
                        out.cost.setdefault("resumed_attempts",
                                            session.resumes)
                    yield out
        except (asyncio.CancelledError, GeneratorExit):
            # the caller vanished mid-stream (SSE client disconnect ->
            # aiohttp cancels the handler task, which unwinds this
            # generator). Closing the call-home stream is the reliable
            # SYNCHRONOUS kill signal: the worker's ctrl loop maps the
            # conn drop to ctx.kill(), the engine cancels the sequence
            # on its normal path (pages free, attribution records
            # "cancelled"). Awaiting a ctrl frame here would race our
            # own cancellation.
            context.kill()
            stream.close()
            killed_sync = True
            raise
        finally:
            if killed_sync:
                pass  # conn already dropped; never await mid-cancel
            elif context.killed:
                await stream.kill()
            elif context.stopped:
                await stream.stop_generating()

    async def generate(self, request: PreprocessedRequest, context: Context):
        session = revive.ReviveSession(request, context)
        # a killed (abandoned) request must not leak its journal entry
        # until the generator finalizer runs
        # proto: revive.journal open->closed
        context.on_kill(session.close)
        attempt_req = request
        target = self.worker_id
        try:
            while True:
                try:
                    async for out in self._run_attempt(attempt_req, context,
                                                       session, target):
                        yield out
                    if session.finished:
                        return
                    # stream ended without a finish chunk (legacy peer /
                    # truncated): downstream stamps the terminal reason
                    return
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 — judged below
                    if not session.should_resume(e):
                        raise
                    if session.budget_spent():
                        # every budgeted token already streamed; only the
                        # finish chunk died with the worker — synthesize it
                        yield session.synthetic_finish()
                        return
                    session.mark_resume()
                    # proto: request.lifecycle resumed->prefill
                    attempt_req = session.resume_request()
                    target = await self._pick_resume_target(
                        attempt_req, context, target)
                    log.warning(
                        "revive: upstream for %s died after %d tokens "
                        "(%s); resuming on %s (attempt %d)",
                        context.id, len(session.emitted), e,
                        f"{target:x}" if target is not None
                        else "round-robin", session.resumes)
        finally:
            session.close()  # proto: revive.journal open->closed

    async def _pick_resume_target(self, request: PreprocessedRequest,
                                  context: Context,
                                  failed: Optional[int]) -> Optional[int]:
        """Re-route the resume: overlap scoring over ``prompt + emitted``
        lands it on the sibling with the warmest prefix; the failed
        worker is excluded (its discovery record may outlive it)."""
        if self.reroute is None:
            return None
        exclude = {failed} if failed is not None else set()
        try:
            return await self.reroute(request.token_ids, exclude,
                                      context.id)
        except Exception:  # noqa: BLE001 — routing is best-effort here;
            # the round-robin fallback still carries the resume
            log.debug("revive reroute failed for %s", context.id,
                      exc_info=True)
            return None


class Processor:
    """KV-routed OpenAI engine (chat and completions callables for the
    ModelManager)."""

    def __init__(self, mdc: ModelDeploymentCard, client: Client,
                 router: Optional[KvRouter] = None):
        self.mdc = mdc
        self.client = client
        self.router = router
        self.preprocessor = OpenAIPreprocessor(mdc)

    async def _route(self, pre: PreprocessedRequest,
                     context: Context) -> Optional[int]:
        if self.router is None:
            return None
        # the request id keys the router's predicted-vs-realized
        # calibration entry (matched when the finish cost block returns)
        try:
            worker_id = await self.router.schedule(pre.token_ids,
                                                   request_id=context.id)
        except NoRespondersError:
            raise  # empty pool: typed 503 + Retry-After, not a fallback
        except RuntimeError as e:
            # every candidate saturated (or optimistic slot accounting
            # thinks so between scrapes): dispatch round-robin instead of
            # 500ing — the engines' own admission queues absorb the wave
            # and the frontend's admission controller bounds how deep it
            # gets. Counted, never silent.
            guard.counter_inc("dyn_llm_route_fallback_total",
                              reason="SchedulerSaturated")
            log.warning("kv scheduler saturated (%s); dispatching "
                        "round-robin", e)
            return None
        return worker_id

    async def _reroute(self, token_ids, exclude, request_id):
        """Resume routing: schedule ``prompt + emitted`` with
        the dead worker excluded — overlap scoring lands the retry on
        the replica with the warmest prefix (and re-keys the calibration
        entry to the resume's prediction)."""
        if self.router is None:
            return None
        return await self.router.schedule(token_ids,
                                          request_id=request_id,
                                          exclude=exclude)

    def chat(self, request: ChatCompletionRequest,
             context: Context) -> AsyncIterator:
        return self._chat(request, context)

    async def _chat(self, request: ChatCompletionRequest, context: Context):
        pre, annotations = self.preprocessor.preprocess_chat(request)
        for ann in annotations:
            yield ann
        worker_id = await self._route(pre, context)
        engine = _RemoteTokenEngine(self.client, worker_id,
                                    reroute=self._reroute)
        backend = Backend(engine, self.preprocessor.tokenizer)
        async for chunk in self.preprocessor.chat_stream(
                request, backend.generate(pre, context), context,
                len(pre.token_ids)):
            yield chunk

    def completion(self, request: CompletionRequest,
                   context: Context) -> AsyncIterator:
        return self._completion(request, context)

    async def _completion(self, request: CompletionRequest, context: Context):
        pre, annotations = self.preprocessor.preprocess_completion(request)
        for ann in annotations:
            yield ann
        worker_id = await self._route(pre, context)
        engine = _RemoteTokenEngine(self.client, worker_id,
                                    reroute=self._reroute)
        backend = Backend(engine, self.preprocessor.tokenizer)
        rid = f"cmpl-{context.id or uuid.uuid4().hex}"
        created = int(time.time())
        n_out = 0
        text_off = 0
        if pre.output.echo_prompt:
            # OpenAI completions echo=true; offsets start after the prompt
            echo_text = self.preprocessor.tokenizer.decode(
                list(pre.token_ids))
            text_off = len(echo_text)
            yield {"id": rid, "object": "text_completion",
                   "created": created, "model": request.model,
                   "choices": [{
                       "index": 0, "text": echo_text,
                       "finish_reason": None}]}
        async for out in backend.generate(pre, context):
            n_out += len(out.token_ids)
            if out.text or out.finish_reason or out.logprobs:
                choice = {"index": 0, "text": out.text or "",
                          "finish_reason":
                              _finish_reason_openai(out.finish_reason)}
                lp = completion_logprobs(out, self.preprocessor.tokenizer,
                                         text_off)
                if lp:
                    choice["logprobs"] = lp
                text_off += len(out.text or "")
                yield {"id": rid, "object": "text_completion",
                       "created": created, "model": request.model,
                       "choices": [choice]}
            if out.finish_reason:
                if request.stream_options and \
                        request.stream_options.include_usage:
                    yield {"id": rid, "object": "text_completion",
                           "created": created, "model": request.model,
                           "choices": [],
                           "usage": {"prompt_tokens": len(pre.token_ids),
                                     "completion_tokens": n_out,
                                     "total_tokens":
                                         len(pre.token_ids) + n_out}}
                return
