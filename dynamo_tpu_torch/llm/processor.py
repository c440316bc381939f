"""Frontend-side processor, a copy of ``dynamo_tpu/llm/processor.py``:
tokenize -> KV-route -> worker -> detokenize.

The Processor lowers the OpenAI request with the model card's tokenizer,
asks the :class:`KvRouter` for a worker, calls the worker's token-level
endpoint with ``direct()`` routing (falling back to the retry policy's
round-robin path, counted, when the pick is gone), and maps the token
stream back to OpenAI chunks through the detokenizing Backend. The
reference's mid-stream resume on a sibling when a worker dies
(``runtime/revive.py``) is not part of the port: a worker lost mid-stream
ends the request with an error.
"""

from __future__ import annotations

import asyncio
import logging
import time
import uuid
from typing import AsyncIterator, Optional

from ..runtime import guard
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
    so the Backend can detokenize the remote stream."""

    def __init__(self, client: Client, worker_id: Optional[int]):
        self.client = client
        self.worker_id = worker_id

    async def _dispatch(self, request: PreprocessedRequest,
                        context: Context):
        """Route the request: the KV-routed direct pick first, then the
        retry policy's round-robin path (``Client.generate`` retries,
        budget-aware, with per-instance breakers). The fallback is
        counted as ``dyn_llm_route_fallback_total``."""
        if self.worker_id is not None:
            try:
                return await self.client.direct(request.to_dict(),
                                                self.worker_id,
                                                context=context)
            except guard.DeadlineExceeded:
                raise
            except (RuntimeError, NoRespondersError) as e:
                # the routed worker vanished between the router's scrape
                # and the direct call, or its breaker is open: any live
                # worker beats a 500
                guard.counter_inc("dyn_llm_route_fallback_total",
                                  reason=type(e).__name__)
                log.warning("direct route to %x failed (%s); falling "
                            "back to round-robin", self.worker_id, e)
        return await self.client.round_robin(request.to_dict(),
                                             context=context)

    async def generate(self, request: PreprocessedRequest, context: Context):
        stream = await self._dispatch(request, context)
        # a killed request severs the call-home connection at once: the
        # worker maps the drop to ctx.kill() and frees the pages
        context.on_kill(stream.close)
        killed_sync = False
        try:
            async for env in stream:
                if env.is_error:
                    raise RuntimeError(env.error_message())
                if env.data is not None:
                    yield EngineOutput.from_dict(env.data)
        except (asyncio.CancelledError, GeneratorExit):
            # the caller vanished mid-stream: closing the stream is the
            # synchronous kill signal (awaiting a ctrl frame here would
            # race our own cancellation)
            context.kill()
            stream.close()
            killed_sync = True
            raise
        finally:
            if killed_sync:
                pass
            elif context.killed:
                await stream.kill()
            elif context.stopped:
                await stream.stop_generating()


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
        try:
            return await self.router.schedule(pre.token_ids,
                                              request_id=context.id)
        except NoRespondersError:
            raise  # empty pool: typed, not a fallback
        except RuntimeError as e:
            # every candidate saturated (or the optimistic slot accounting
            # thinks so between scrapes): dispatch round-robin instead of
            # failing; the engines' admission queues absorb the wave
            guard.counter_inc("dyn_llm_route_fallback_total",
                              reason="SchedulerSaturated")
            log.warning("kv scheduler saturated (%s); dispatching "
                        "round-robin", e)
            return None

    def chat(self, request: ChatCompletionRequest,
             context: Context) -> AsyncIterator:
        return self._chat(request, context)

    async def _chat(self, request: ChatCompletionRequest, context: Context):
        pre, annotations = self.preprocessor.preprocess_chat(request)
        for ann in annotations:
            yield ann
        worker_id = await self._route(pre, context)
        backend = Backend(_RemoteTokenEngine(self.client, worker_id),
                          self.preprocessor.tokenizer)
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
        backend = Backend(_RemoteTokenEngine(self.client, worker_id),
                          self.preprocessor.tokenizer)
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
