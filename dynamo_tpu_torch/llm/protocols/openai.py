"""OpenAI API protocol types (pydantic).

Reference lib/llm/src/protocols/openai/ (chat_completions.rs,
completions.rs, delta.rs, aggregator.rs, nvext.rs): request/response models
for ``/v1/chat/completions`` and ``/v1/completions``, SSE delta generators,
and stream→full-response aggregation. The reference's ``nvext`` extension
block maps to ``ext`` here (``ignore_eos``, ``annotations``,
``use_raw_prompt``, plus routing hints).
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, List, Literal, Optional, Union

from pydantic import BaseModel, ConfigDict, Field


class Ext(BaseModel):
    """Framework extension block (reference nvext.rs:28)."""

    model_config = ConfigDict(extra="allow")
    ignore_eos: Optional[bool] = None
    use_raw_prompt: Optional[bool] = None
    annotations: Optional[List[str]] = None
    greedy_sampling: Optional[bool] = None


class ChatMessage(BaseModel):
    model_config = ConfigDict(extra="allow")
    role: str
    content: Optional[Union[str, List[Dict[str, Any]]]] = None
    name: Optional[str] = None

    def text(self) -> str:
        if isinstance(self.content, str):
            return self.content
        if isinstance(self.content, list):
            return "".join(
                part.get("text", "") for part in self.content
                if isinstance(part, dict) and part.get("type") == "text")
        return ""


class StreamOptions(BaseModel):
    include_usage: Optional[bool] = None


class ChatCompletionRequest(BaseModel):
    model_config = ConfigDict(extra="allow")
    model: str
    messages: List[ChatMessage]
    stream: bool = False
    stream_options: Optional[StreamOptions] = None
    max_tokens: Optional[int] = None
    max_completion_tokens: Optional[int] = None
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None  # non-OpenAI but widely used
    n: int = 1
    stop: Optional[Union[str, List[str]]] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    logit_bias: Optional[Dict[str, float]] = None
    seed: Optional[int] = None
    logprobs: Optional[bool] = None
    top_logprobs: Optional[int] = None
    user: Optional[str] = None
    min_tokens: Optional[int] = None
    # end-to-end request deadline in SECONDS (dynaguard); overrides the
    # X-Request-Deadline-Ms header and the DYN_REQUEST_DEADLINE_MS default
    timeout: Optional[float] = None
    ext: Optional[Ext] = None
    # accept the reference's field name too
    nvext: Optional[Ext] = None

    def extension(self) -> Ext:
        return self.ext or self.nvext or Ext()

    def stop_list(self) -> Optional[List[str]]:
        if self.stop is None:
            return None
        return [self.stop] if isinstance(self.stop, str) else list(self.stop)

    def max_output_tokens(self) -> Optional[int]:
        return self.max_completion_tokens or self.max_tokens


class CompletionRequest(BaseModel):
    model_config = ConfigDict(extra="allow")
    model: str
    prompt: Union[str, List[str], List[int], List[List[int]]]
    stream: bool = False
    stream_options: Optional[StreamOptions] = None
    max_tokens: Optional[int] = 16
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    n: int = 1
    stop: Optional[Union[str, List[str]]] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    logit_bias: Optional[Dict[str, float]] = None
    seed: Optional[int] = None
    logprobs: Optional[int] = None
    echo: bool = False
    user: Optional[str] = None
    min_tokens: Optional[int] = None
    # end-to-end request deadline in SECONDS (dynaguard); overrides the
    # X-Request-Deadline-Ms header and the DYN_REQUEST_DEADLINE_MS default
    timeout: Optional[float] = None
    ext: Optional[Ext] = None
    nvext: Optional[Ext] = None

    def extension(self) -> Ext:
        return self.ext or self.nvext or Ext()

    def stop_list(self) -> Optional[List[str]]:
        if self.stop is None:
            return None
        return [self.stop] if isinstance(self.stop, str) else list(self.stop)


class Usage(BaseModel):
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0
    # dynaprof extension (DYN_PROF_USAGE=1): per-request cost attribution
    # (queue wait, device-step share, KV footprint). Non-OpenAI field,
    # omitted from payloads when None (exclude_none serialization).
    cost: Optional[dict] = None


class ChatChoiceDelta(BaseModel):
    role: Optional[str] = None
    content: Optional[str] = None


class ChatChunkChoice(BaseModel):
    index: int = 0
    delta: ChatChoiceDelta = Field(default_factory=ChatChoiceDelta)
    finish_reason: Optional[str] = None
    logprobs: Optional[Dict[str, Any]] = None


class ChatCompletionChunk(BaseModel):
    id: str
    object: Literal["chat.completion.chunk"] = "chat.completion.chunk"
    created: int
    model: str
    choices: List[ChatChunkChoice]
    usage: Optional[Usage] = None


class ChatChoice(BaseModel):
    index: int = 0
    message: ChatMessage
    finish_reason: Optional[str] = None
    logprobs: Optional[Dict[str, Any]] = None


class ChatCompletionResponse(BaseModel):
    id: str
    object: Literal["chat.completion"] = "chat.completion"
    created: int
    model: str
    choices: List[ChatChoice]
    usage: Optional[Usage] = None


class CompletionChoice(BaseModel):
    index: int = 0
    text: str = ""
    finish_reason: Optional[str] = None
    logprobs: Optional[Dict[str, Any]] = None


class CompletionResponse(BaseModel):
    id: str
    object: Literal["text_completion"] = "text_completion"
    created: int
    model: str
    choices: List[CompletionChoice]
    usage: Optional[Usage] = None


class ModelInfo(BaseModel):
    id: str
    object: Literal["model"] = "model"
    created: int = Field(default_factory=lambda: int(time.time()))
    owned_by: str = "dynamo-tpu"


class ModelList(BaseModel):
    object: Literal["list"] = "list"
    data: List[ModelInfo] = Field(default_factory=list)


# --------------------------------------------------------------------------
# Delta generation + aggregation (reference delta.rs / aggregator.rs)


def _finish_reason_openai(reason: Optional[str]) -> Optional[str]:
    """Engine finish reason → client-visible OpenAI finish_reason.
    "cancelled" and "timeout" pass through distinctly (the seed collapsed
    cancelled→stop, which hid deadline expiry from clients entirely)."""
    if reason is None:
        return None
    return {"eos": "stop", "stop": "stop", "length": "length",
            "cancelled": "cancelled", "timeout": "timeout",
            "error": "error"}.get(reason, reason)


class ChatDeltaGenerator:
    """Builds SSE chunks for a chat stream (reference
    openai/chat_completions/delta.rs)."""

    def __init__(self, model: str, request_id: Optional[str] = None):
        self.id = f"chatcmpl-{request_id or uuid.uuid4().hex}"
        self.model = model
        self.created = int(time.time())
        self._first = True

    def role_chunk(self) -> ChatCompletionChunk:
        return ChatCompletionChunk(
            id=self.id, created=self.created, model=self.model,
            choices=[ChatChunkChoice(delta=ChatChoiceDelta(role="assistant",
                                                           content=""))])

    def content_chunk(self, text: str,
                      finish_reason: Optional[str] = None,
                      logprobs: Optional[Dict[str, Any]] = None,
                      ) -> ChatCompletionChunk:
        delta = ChatChoiceDelta(content=text) if text else ChatChoiceDelta()
        return ChatCompletionChunk(
            id=self.id, created=self.created, model=self.model,
            choices=[ChatChunkChoice(
                delta=delta, logprobs=logprobs,
                finish_reason=_finish_reason_openai(finish_reason))])

    def usage_chunk(self, usage: Usage) -> ChatCompletionChunk:
        return ChatCompletionChunk(
            id=self.id, created=self.created, model=self.model,
            choices=[], usage=usage)


class ChatAggregator:
    """Folds a chunk stream into a full ChatCompletionResponse (reference
    openai/chat_completions/aggregator.rs)."""

    def __init__(self, model: str, request_id: Optional[str] = None):
        self.id = f"chatcmpl-{request_id or uuid.uuid4().hex}"
        self.model = model
        self.created = int(time.time())
        # keyed by choice index — n>1 streams interleave their chunks
        self.text_parts: Dict[int, List[str]] = {}
        self.finish_reason: Dict[int, str] = {}
        self.lp_content: Dict[int, List[dict]] = {}
        self.usage: Optional[Usage] = None

    def add_chunk(self, chunk: ChatCompletionChunk) -> None:
        for choice in chunk.choices:
            if choice.delta.content:
                self.text_parts.setdefault(choice.index, []).append(
                    choice.delta.content)
            if choice.logprobs and choice.logprobs.get("content"):
                self.lp_content.setdefault(choice.index, []).extend(
                    choice.logprobs["content"])
            if choice.finish_reason:
                self.finish_reason[choice.index] = choice.finish_reason
        if chunk.usage is not None:
            # last-wins: engines may report CUMULATIVE usage per chunk;
            # summing belongs to the n>1 fan-out, which guarantees
            # exactly one (already-merged) usage chunk per stream
            self.usage = chunk.usage

    def response(self) -> ChatCompletionResponse:
        idxs = sorted(set(self.text_parts) | set(self.finish_reason)) or [0]
        return ChatCompletionResponse(
            id=self.id, created=self.created, model=self.model,
            choices=[ChatChoice(
                index=i,
                message=ChatMessage(
                    role="assistant",
                    content="".join(self.text_parts.get(i, []))),
                logprobs=({"content": self.lp_content[i]}
                          if i in self.lp_content else None),
                finish_reason=self.finish_reason.get(i) or "stop")
                for i in idxs],
            usage=self.usage)


class CompletionAggregator:
    def __init__(self, model: str, request_id: Optional[str] = None):
        self.id = f"cmpl-{request_id or uuid.uuid4().hex}"
        self.model = model
        self.created = int(time.time())
        self.text_parts: Dict[int, List[str]] = {}
        self.finish_reason: Dict[int, str] = {}
        self.lp: Dict[int, dict] = {}
        self.usage: Optional[Usage] = None

    def add_text(self, text: str, finish_reason: Optional[str] = None,
                 index: int = 0, logprobs: Optional[dict] = None) -> None:
        if text:
            self.text_parts.setdefault(index, []).append(text)
        if logprobs:
            cur = self.lp.setdefault(index, {
                "tokens": [], "token_logprobs": [], "top_logprobs": [],
                "text_offset": []})
            for k in cur:
                cur[k].extend(logprobs.get(k) or [])
        if finish_reason:
            self.finish_reason[index] = finish_reason

    def response(self) -> CompletionResponse:
        idxs = sorted(set(self.text_parts) | set(self.finish_reason)) or [0]
        return CompletionResponse(
            id=self.id, created=self.created, model=self.model,
            choices=[CompletionChoice(
                index=i, text="".join(self.text_parts.get(i, [])),
                logprobs=self.lp.get(i),
                finish_reason=_finish_reason_openai(
                    self.finish_reason.get(i)) or "stop")
                for i in idxs],
            usage=self.usage)


def _merge_usage(cur: Optional["Usage"], new: "Usage") -> "Usage":
    """n>1: completion tokens SUM across choices; the shared prompt is
    counted once (OpenAI semantics)."""
    if cur is None:
        return new
    return Usage(
        prompt_tokens=max(cur.prompt_tokens, new.prompt_tokens),
        completion_tokens=cur.completion_tokens + new.completion_tokens,
        total_tokens=max(cur.prompt_tokens, new.prompt_tokens)
        + cur.completion_tokens + new.completion_tokens,
        cost=cur.cost or new.cost)
