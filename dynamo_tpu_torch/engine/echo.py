"""Deterministic echo engines, a copy of ``dynamo_tpu/engine/echo.py``:
the serving stack's engines with no device.

``EchoEngineCore`` echoes the prompt's tokens back one at a time at a
fixed cadence (token level: it sits behind the Backend's detokenizer);
``EchoEngineFull`` echoes the last user message's text in word-sized
deltas at the OpenAI level. They drive the whole chain (HTTP →
preprocessor → worker → backend → SSE) with no accelerator.

``EchoEngineFull`` is callable, as the HTTP service and the launcher's
text and batch modes call a full-level engine, and it yields OpenAI chat
chunks (a role chunk, one chunk a word, a final chunk with finish reason
``stop``): the reference's class has ``generate`` only and yields
``{"text": ...}`` dicts, which neither its service nor its batch mode can
read.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator

from ..llm.protocols.common import EngineOutput, PreprocessedRequest
from ..llm.protocols.openai import ChatDeltaGenerator
from ..runtime.engine import Context

DEFAULT_DELAY_MS = 1.0


class EchoEngineCore:
    """Token-level echo: yields the prompt's tokens back as output tokens."""

    def __init__(self, delay_ms: float = DEFAULT_DELAY_MS):
        self.delay_ms = delay_ms

    async def generate(self, request: PreprocessedRequest,
                       context: Context) -> AsyncIterator[EngineOutput]:
        ids = list(request.token_ids)
        max_tokens = request.stop.max_tokens or len(ids)
        prompt_tokens = len(ids)
        for tid in ids[:max_tokens]:
            if context.stopped:
                return
            if self.delay_ms:
                await asyncio.sleep(self.delay_ms / 1000.0)
            yield EngineOutput(token_ids=[tid], prompt_tokens=prompt_tokens)
        yield EngineOutput(token_ids=[], finish_reason="length"
                           if max_tokens < len(ids) else "stop",
                           prompt_tokens=prompt_tokens)


def _text(m) -> str:
    """A message's text: a string, or the text parts of OpenAI multipart
    content."""
    if not isinstance(m, dict):
        return m.text()
    content = m.get("content")
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        return "".join(p.get("text", "") for p in content
                       if isinstance(p, dict) and p.get("type") == "text")
    return ""


class EchoEngineFull:
    """OpenAI-level echo: streams the last user message's text back in
    word-sized deltas (no tokenization)."""

    def __init__(self, delay_ms: float = DEFAULT_DELAY_MS):
        self.delay_ms = delay_ms

    def __call__(self, request, context: Context) -> AsyncIterator:
        return self.generate(request, context)

    async def generate(self, request, context: Context):
        # request: a ChatCompletionRequest, or its dict
        is_dict = isinstance(request, dict)
        messages = request["messages"] if is_dict else request.messages
        model = (request.get("model") if is_dict else request.model) or ""
        text = ""
        for m in reversed(messages):
            role = m["role"] if isinstance(m, dict) else m.role
            if role == "user":
                text = _text(m)
                break
        gen = ChatDeltaGenerator(model, context.id)
        yield gen.role_chunk()
        for word in text.split(" "):
            if context.stopped:
                return
            if self.delay_ms:
                await asyncio.sleep(self.delay_ms / 1000.0)
            yield gen.content_chunk(word + " ")
        yield gen.content_chunk("", "stop")
