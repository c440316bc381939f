"""Engine chains, a copy of ``LocalChatChain``, ``LocalCompletionChain``
and ``RemoteOpenAIEngine`` from ``dynamo_tpu/llm/engines.py``.

A "core" engine speaks token-level types and is wrapped by
``OpenAIPreprocessor`` + ``Backend`` so the HTTP service can call it with
OpenAI requests, in-process (the local chains) or on a worker over the
distributed runtime (``RemoteOpenAIEngine``, the frontend's engine).
"""

from __future__ import annotations

import time
import uuid
from typing import AsyncIterator, Optional

from ..runtime.component import Client
from ..runtime.engine import Context
from .backend import Backend
from .model_card import ModelDeploymentCard
from .preprocessor import OpenAIPreprocessor, completion_logprobs
from .protocols.openai import (ChatCompletionRequest, CompletionRequest,
                               _finish_reason_openai)


class LocalChatChain:
    """preprocessor → backend → core engine for /v1/chat/completions."""

    def __init__(self, mdc: ModelDeploymentCard, core_engine,
                 preprocessor: Optional[OpenAIPreprocessor] = None):
        self.mdc = mdc
        self.preprocessor = preprocessor or OpenAIPreprocessor(mdc)
        self.backend = Backend(core_engine, self.preprocessor.tokenizer)

    def __call__(self, request: ChatCompletionRequest,
                 context: Context) -> AsyncIterator:
        return self._run(request, context)

    async def _run(self, request: ChatCompletionRequest, context: Context):
        pre, annotations = self.preprocessor.preprocess_chat(request)
        for ann in annotations:
            yield ann
        engine_stream = self.backend.generate(pre, context)
        async for chunk in self.preprocessor.chat_stream(
                request, engine_stream, context, len(pre.token_ids)):
            yield chunk


class LocalCompletionChain:
    """Same chain for the /v1/completions endpoint."""

    def __init__(self, mdc: ModelDeploymentCard, core_engine,
                 preprocessor: Optional[OpenAIPreprocessor] = None):
        self.mdc = mdc
        self.preprocessor = preprocessor or OpenAIPreprocessor(mdc)
        self.backend = Backend(core_engine, self.preprocessor.tokenizer)

    def __call__(self, request: CompletionRequest,
                 context: Context) -> AsyncIterator:
        return self._run(request, context)

    async def _run(self, request: CompletionRequest, context: Context):
        pre, annotations = self.preprocessor.preprocess_completion(request)
        for ann in annotations:
            yield ann
        rid = f"cmpl-{context.id or uuid.uuid4().hex}"
        created = int(time.time())
        completion_tokens = 0
        text_off = 0
        if pre.output.echo_prompt:
            # OpenAI completions echo=true: the response text starts with
            # the prompt (reconstructed from the request token ids);
            # generated-token offsets then start AFTER it
            echo_text = self.preprocessor.tokenizer.decode(
                list(pre.token_ids))
            text_off = len(echo_text)
            yield {
                "id": rid, "object": "text_completion", "created": created,
                "model": request.model,
                "choices": [{"index": 0, "text": echo_text,
                             "finish_reason": None}],
            }
        async for out in self.backend.generate(pre, context):
            completion_tokens += len(out.token_ids)
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
                if request.stream_options and request.stream_options.include_usage:
                    yield {"id": rid, "object": "text_completion",
                           "created": created, "model": request.model,
                           "choices": [], "usage": {
                               "prompt_tokens": len(pre.token_ids),
                               "completion_tokens": completion_tokens,
                               "total_tokens":
                                   len(pre.token_ids) + completion_tokens}}
                return


class RemoteOpenAIEngine:
    """Forwards OpenAI-level requests to a worker endpoint over the
    distributed runtime; the worker streams chunk dicts back in Annotated
    envelopes. ``mode``/``instance_id`` select routing."""

    def __init__(self, client: Client, mode: str = "round_robin"):
        self.client = client
        self.mode = mode

    def __call__(self, request, context: Context) -> AsyncIterator:
        return self._run(request, context)

    async def _run(self, request, context: Context):
        payload = request.model_dump(exclude_none=True) \
            if hasattr(request, "model_dump") else request
        stream = await self.client.generate(
            payload, mode=self.mode, context=context)
        try:
            async for env in stream:
                yield env
        finally:
            if context.killed:
                await stream.kill()
            elif context.stopped:
                await stream.stop_generating()
