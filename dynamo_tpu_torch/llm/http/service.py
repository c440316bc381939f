"""Lean OpenAI-compatible HTTP service (aiohttp).

The serving subset of ``dynamo_tpu/llm/http/service.py``:
``/v1/chat/completions`` and ``/v1/completions`` (SSE stream and unary),
``/v1/models`` and ``/health``, with the same chunk and response shapes
(``_chunk_dict``). Metrics, admission control, deadlines and the debug
endpoints are not part of this service yet.
"""

from __future__ import annotations

import asyncio
import json
import logging
import uuid
from typing import Dict, Optional

from aiohttp import web

from ...runtime.engine import Annotated, Context
from ..protocols.openai import (ChatAggregator, ChatCompletionChunk,
                                ChatCompletionRequest, CompletionAggregator,
                                CompletionRequest, ModelInfo, ModelList, Usage)

log = logging.getLogger("dynamo_tpu_torch.http")


class ModelManager:
    """Served model name → OpenAI-level engine callable, per endpoint."""

    def __init__(self) -> None:
        self.chat_engines: Dict[str, object] = {}
        self.completion_engines: Dict[str, object] = {}

    def add_chat_model(self, name: str, engine) -> None:
        self.chat_engines[name] = engine

    def add_completions_model(self, name: str, engine) -> None:
        self.completion_engines[name] = engine

    def remove_model(self, name: str, model_type: str = "both") -> None:
        if model_type in ("chat", "both"):
            self.chat_engines.pop(name, None)
        if model_type in ("completions", "both"):
            self.completion_engines.pop(name, None)
        log.info("removed model %r (type=%s)", name, model_type)

    def list_models(self) -> ModelList:
        names = sorted(set(self.chat_engines) | set(self.completion_engines))
        return ModelList(data=[ModelInfo(id=n) for n in names])


class HttpService:
    def __init__(self, manager: Optional[ModelManager] = None):
        self.manager = manager or ModelManager()
        self.app = web.Application()
        self.app.add_routes([
            web.post("/v1/chat/completions", self._chat),
            web.post("/v1/completions", self._completions),
            web.get("/v1/models", self._models),
            web.get("/health", self._health),
        ])
        self._runner: Optional[web.AppRunner] = None
        self.port: Optional[int] = None

    async def start(self, host: str = "0.0.0.0", port: int = 8080) -> None:
        """Bind and serve; ``port=0`` picks a free port (read ``.port``)."""
        self._runner = web.AppRunner(self.app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, host, port)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None

    async def _health(self, request: web.Request) -> web.Response:
        return web.json_response({
            "status": "ok",
            "models": sorted(set(self.manager.chat_engines)
                             | set(self.manager.completion_engines))})

    async def _models(self, request: web.Request) -> web.Response:
        return web.json_response(self.manager.list_models().model_dump())

    async def _chat(self, request: web.Request) -> web.StreamResponse:
        return await self._serve(request, ChatCompletionRequest,
                                 self.manager.chat_engines, "chat_completions")

    async def _completions(self, request: web.Request) -> web.StreamResponse:
        return await self._serve(request, CompletionRequest,
                                 self.manager.completion_engines, "completions")

    async def _serve(self, request: web.Request, model_cls, engines: dict,
                     endpoint: str) -> web.StreamResponse:
        rid = (request.headers.get("X-Request-Id") or "").strip()[:128] \
            or uuid.uuid4().hex
        hdrs = {"X-Request-Id": rid}
        try:
            req = model_cls(**(await request.json()))
        except Exception as e:  # noqa: BLE001 — any parse failure is a 400
            return _error_response(400, f"invalid request: {e}", hdrs)
        engine = engines.get(req.model)
        if engine is None:
            return _error_response(
                404, f"model {req.model!r} not found; available: "
                     f"{sorted(engines)}", hdrs)
        if (getattr(req, "n", 1) or 1) > 1:
            return _error_response(400, "n > 1 is not supported", hdrs)
        ctx = Context(rid)
        try:
            aiter = engine(req, ctx).__aiter__()
            # pull the first item BEFORE committing response headers so
            # early failures (validation) map to clean errors
            try:
                first = await aiter.__anext__()
            except StopAsyncIteration:
                first = None
            if req.stream:
                return await self._sse(request, first, aiter, ctx, hdrs)
            return await self._unary(req, first, aiter, endpoint, hdrs)
        except ValueError as e:
            return _error_response(400, str(e), hdrs)
        except (ConnectionResetError, asyncio.CancelledError):
            ctx.kill()
            raise  # client went away; never answer a second time
        except Exception as e:  # noqa: BLE001
            log.exception("request %s failed", ctx.id)
            return _error_response(500, repr(e), hdrs)

    async def _sse(self, http_request: web.Request, first, aiter,
                   ctx: Context, hdrs: dict) -> web.StreamResponse:
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive",
            **hdrs,
        })
        await resp.prepare(http_request)

        async def _write_chunk(chunk) -> bool:
            """Writes one stream item; returns False to stop the stream."""
            if chunk is None:
                return True
            if isinstance(chunk, Annotated) and chunk.event and chunk.data is None:
                if chunk.is_error:
                    await resp.write(
                        b"event: error\ndata: " +
                        json.dumps(chunk.error_message()).encode() + b"\n\n")
                    return False
                # annotation event (formatted_prompt, token_ids, ...)
                await resp.write(
                    f"event: {chunk.event}\n".encode() + b"data: " +
                    json.dumps(chunk.comment).encode() + b"\n\n")
                return True
            data = _chunk_dict(chunk)
            if data is not None:
                await resp.write(b"data: " + json.dumps(data).encode() + b"\n\n")
            return True

        errored = False
        try:
            if await _write_chunk(first):
                async for chunk in aiter:
                    if not await _write_chunk(chunk):
                        errored = True
                        break
            else:
                errored = True
            if not errored:
                await resp.write(b"data: [DONE]\n\n")
        except (ConnectionResetError, asyncio.CancelledError):
            ctx.kill()  # client went away → propagate cancellation upstream
            raise
        except Exception as e:  # noqa: BLE001 — headers are committed; emit
            # an SSE error event instead of a second response
            log.exception("stream %s failed mid-flight", ctx.id)
            await resp.write(b"event: error\ndata: " +
                             json.dumps(repr(e)).encode() + b"\n\n")
        await resp.write_eof()
        return resp

    async def _unary(self, req, first, aiter, endpoint: str,
                     hdrs: dict) -> web.Response:
        async def _items():
            if first is not None:
                yield first
            async for item in aiter:
                yield item

        if endpoint == "chat_completions":
            agg = ChatAggregator(req.model)
            async for chunk in _items():
                if isinstance(chunk, Annotated) and chunk.is_error:
                    return _error_response(500, chunk.error_message(), hdrs)
                data = _chunk_dict(chunk)
                if data is not None:
                    agg.add_chunk(ChatCompletionChunk(**data))
            return web.json_response(
                agg.response().model_dump(exclude_none=True), headers=hdrs)
        agg = CompletionAggregator(req.model)
        async for chunk in _items():
            if isinstance(chunk, Annotated) and chunk.is_error:
                return _error_response(500, chunk.error_message(), hdrs)
            data = _chunk_dict(chunk)
            if data is None:
                continue
            for choice in data.get("choices", []):
                agg.add_text(choice.get("text", ""),
                             choice.get("finish_reason"),
                             index=choice.get("index", 0),
                             logprobs=choice.get("logprobs"))
            if data.get("usage"):
                agg.usage = Usage(**data["usage"])
        return web.json_response(
            agg.response().model_dump(exclude_none=True), headers=hdrs)


def _chunk_dict(chunk) -> Optional[dict]:
    """Normalize engine output: pydantic model / Annotated / dict → dict."""
    if chunk is None:
        return None
    if isinstance(chunk, Annotated):
        if chunk.is_error:
            return {"event": "error", "comment": chunk.error_message()}
        if chunk.data is None:
            return None  # pure annotation/comment event; not an SSE data chunk
        return chunk.data
    if hasattr(chunk, "model_dump"):
        return chunk.model_dump(exclude_none=True)
    return chunk


def _error_response(status: int, message: str,
                    headers: Optional[dict] = None) -> web.Response:
    err_type = "invalid_request_error" if status < 500 else "internal_error"
    return web.json_response(
        {"error": {"message": message, "type": err_type, "code": status}},
        status=status, headers=headers)
