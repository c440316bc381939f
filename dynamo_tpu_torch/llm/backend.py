"""Backend: the detokenizing stage between engine and preprocessor.

A copy of ``dynamo_tpu/llm/backend.py``: wraps the token-level engine,
incrementally detokenizes the stream, applies stop-sequence "jailing"
(text that could be the prefix of a stop sequence is withheld until
disambiguated), detects EOS / stop-token / max-token finishes, and stamps
finish reasons. A finish chunk's ``cost`` block (the engine's per-request
cost attribution) is recorded in this process's attribution ring, so
``/v1/traces/{request_id}`` serves it where the engine ran in another
process; when the Backend's own stop fires first, the engine's finish is
drained for it (``_harvest_finish_cost``).
"""

from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor
from typing import AsyncIterator, List, Optional

from ..runtime import profiling
from ..runtime.config import env_bool
from ..runtime.engine import Context
from .protocols.common import (FINISH_EOS, FINISH_LENGTH, FINISH_STOP,
                               EngineOutput, PreprocessedRequest)
from .tokenizer import Tokenizer

# The shared detokenization executor (DYN_ASYNC_DETOK, on by default): the
# token-to-text work of every stream runs here, not on the event-loop
# thread, so a slow decode never delays OTHER streams' chunks. A request
# keeps its order with no queue: Backend.generate awaits each chunk's
# decode before it pulls the next engine chunk, so a request never has
# two decodes in flight, and its DecodeStream is only ever touched by one
# thread at a time.
_DETOK_EXEC: Optional[ThreadPoolExecutor] = None


def _detok_executor() -> ThreadPoolExecutor:
    global _DETOK_EXEC
    if _DETOK_EXEC is None:
        _DETOK_EXEC = ThreadPoolExecutor(max_workers=2,
                                         thread_name_prefix="dyn-detok")
    return _DETOK_EXEC


def _decode_many(decode, ids: List[int]) -> str:
    return "".join(p for p in map(decode.step, ids) if p)


class StopSequenceJail:
    """Holds back emitted text while it matches a proper prefix of any stop
    sequence; releases or truncates once disambiguated."""

    def __init__(self, stop: List[str]):
        self._stop = [s for s in stop if s]
        self._held = ""

    def feed(self, text: str) -> tuple[str, bool]:
        """Returns (releasable_text, hit_stop)."""
        if not self._stop:
            return text, False
        buf = self._held + text
        # full stop sequence present → truncate at the earliest match
        cut = -1
        for s in self._stop:
            i = buf.find(s)
            if i != -1 and (cut == -1 or i < cut):
                cut = i
        if cut != -1:
            self._held = ""
            return buf[:cut], True
        # otherwise hold the longest suffix that is a prefix of some stop seq
        hold = 0
        for s in self._stop:
            for k in range(min(len(s) - 1, len(buf)), 0, -1):
                if buf.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        if hold:
            self._held = buf[-hold:]
            return buf[:-hold], False
        self._held = ""
        return buf, False

    def flush(self) -> str:
        out, self._held = self._held, ""
        return out


class Backend:
    """Engine wrapper adding detokenization + stop handling.

    ``engine.generate(PreprocessedRequest, Context)`` must yield
    ``EngineOutput`` with ``token_ids`` deltas; this stage fills ``text``
    and ``finish_reason``.
    """

    # bound (seconds) on draining the engine's in-flight finish chunk
    # after a Backend-side stop: about an engine iteration, never a hang
    COST_HARVEST_BOUND_S = 0.25

    def __init__(self, engine, tokenizer: Tokenizer):
        self.engine = engine
        self.tokenizer = tokenizer

    async def _harvest_finish_cost(self, agen, context):
        """Drain a few more engine chunks (bounded) for the cost block
        riding the engine's own finish; records and returns it, or None
        on timeout or exhaustion. Without this, a request the Backend
        finishes first (length cap, eos) would lose its cost
        attribution."""
        try:
            while True:
                raw = await asyncio.wait_for(agen.__anext__(),
                                             self.COST_HARVEST_BOUND_S)
                out = raw if isinstance(raw, EngineOutput) \
                    else EngineOutput.from_dict(raw)
                if out.cost is not None:
                    profiling.record_attribution(context.id, out.cost)
                    return out.cost
                if out.finish_reason:
                    return None
        except (StopAsyncIteration, asyncio.TimeoutError):
            return None

    async def generate(self, request: PreprocessedRequest,
                       context: Context) -> AsyncIterator[EngineOutput]:
        decode = self.tokenizer.decode_stream(
            skip_special_tokens=request.output.skip_special_tokens)
        jail = StopSequenceJail(request.stop.stop or [])
        eos_ids = set() if request.stop.ignore_eos else set(request.eos_token_ids)
        stop_ids = set(request.stop.stop_token_ids or [])
        max_tokens = request.stop.max_tokens
        min_tokens = request.stop.min_tokens or 0
        produced = 0
        finished: Optional[str] = None

        if max_tokens is not None and max_tokens < 1:
            yield EngineOutput(token_ids=[], text="", finish_reason=FINISH_LENGTH,
                               completion_tokens=0)
            context.stop_generating()
            return

        def _final_text(released: str, stop_seq_hit: bool) -> str:
            """Append held decoder/jail text to the finish-bearing chunk.
            When a stop STRING matched, the jail already truncated at the
            match and held text is intentionally dropped; every other
            finish must flush held text."""
            if stop_seq_hit:
                return released
            tail, _ = jail.feed(decode.flush())
            return released + tail + jail.flush()

        offload = env_bool("DYN_ASYNC_DETOK")
        loop = asyncio.get_running_loop() if offload else None

        agen = self.engine.generate(request, context)
        async for raw in agen:
            out = raw if isinstance(raw, EngineOutput) \
                else EngineOutput.from_dict(raw)
            if out.cost is not None:
                # the engine's finish chunk carries its cost attribution;
                # recording it here serves /v1/traces/{rid} in this
                # process when the engine ran in another
                profiling.record_attribution(context.id, out.cost)
            emit_ids: List[int] = []
            decode_ids: List[int] = []
            for tid in out.token_ids:
                produced += 1
                is_eos = tid in eos_ids and produced >= min_tokens
                is_stop_tok = tid in stop_ids and produced >= min_tokens
                if not (is_eos and request.output.skip_special_tokens):
                    decode_ids.append(tid)
                emit_ids.append(tid)
                if is_eos:
                    finished = FINISH_EOS
                elif is_stop_tok:
                    finished = FINISH_STOP
                elif max_tokens is not None and produced >= max_tokens:
                    finished = FINISH_LENGTH
                if finished:
                    break
            if not decode_ids:
                text = ""
            elif offload:
                # awaited before the next engine chunk is pulled: the
                # request's decodes keep their order by construction
                text = await loop.run_in_executor(
                    _detok_executor(), _decode_many, decode, decode_ids)
            else:
                text = _decode_many(decode, decode_ids)
            released, hit = jail.feed(text) if text else ("", False)
            if hit:
                finished = finished or FINISH_STOP
            out.token_ids = emit_ids
            out.finish_reason = finished or out.finish_reason
            out.completion_tokens = produced
            if out.finish_reason:
                out.text = _final_text(released, stop_seq_hit=hit)
                if out.cost is None and finished is not None and not hit:
                    # the Backend's own stop (token cap, eos, stop token)
                    # fired before the engine's finish, the chunk that
                    # carries the cost block; the engine enforces the same
                    # budget and eos, so its finish is already in flight.
                    # Stop-string matches are skipped: the engine knows no
                    # stop strings and would not finish within the bound
                    out.cost = await self._harvest_finish_cost(agen,
                                                               context)
                yield out
                context.stop_generating()
                return
            out.text = released
            yield out
            if context.stopped:
                context.stop_generating()
                yield EngineOutput(text=_final_text("", False) or None,
                                   finish_reason=context.cancel_reason(),
                                   completion_tokens=produced)
                return
        # engine stream exhausted without a finish reason: flush held text and
        # stamp a terminal reason so downstream never fabricates one
        yield EngineOutput(token_ids=[], text=_final_text("", False) or "",
                           finish_reason=FINISH_STOP, completion_tokens=produced)
