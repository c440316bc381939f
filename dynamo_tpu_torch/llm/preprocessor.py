"""OpenAI → internal translation + response post-processing.

A copy of ``dynamo_tpu/llm/preprocessor.py`` without the usage cost
extension: under a ``preprocess`` span, renders the chat template,
tokenizes, maps sampling/stop options into the internal
``PreprocessedRequest``, emits request annotations
(``formatted_prompt``, ``token_ids``), validates
``logprobs``/``top_logprobs``, and on the way back turns the token-level
engine stream into OpenAI chat chunks, with their logprobs
(:func:`chat_logprobs_content`, :func:`completion_logprobs`).
"""

from __future__ import annotations

from typing import AsyncIterator, List, Optional, Tuple

from ..runtime import tracing
from ..runtime.engine import Annotated, Context
from .model_card import ModelDeploymentCard
from .protocols.common import (EngineOutput, OutputOptions, PreprocessedRequest,
                               SamplingOptions, StopConditions)
from .protocols.openai import (ChatCompletionChunk, ChatCompletionRequest,
                               ChatDeltaGenerator, CompletionRequest, Usage)
from .tokenizer import Tokenizer

ANNOTATION_FORMATTED_PROMPT = "formatted_prompt"
ANNOTATION_TOKEN_IDS = "token_ids"


class OpenAIPreprocessor:
    """Stateless translator bound to one model card + tokenizer."""

    def __init__(self, mdc: ModelDeploymentCard,
                 tokenizer: Optional[Tokenizer] = None):
        self.mdc = mdc
        self.tokenizer = tokenizer or mdc.load_tokenizer()
        self._mdcsum = mdc.mdcsum()

    # ------------------------------------------------------------ requests

    def preprocess_chat(
        self, request: ChatCompletionRequest
    ) -> Tuple[PreprocessedRequest, List[Annotated]]:
        with tracing.get_tracer().start_span("preprocess") as span:
            ext = request.extension()
            if ext.use_raw_prompt and request.messages:
                prompt = "".join(m.text() for m in request.messages)
            else:
                prompt = self.tokenizer.apply_chat_template(
                    [{"role": m.role, "content": m.text()}
                     for m in request.messages],
                    add_generation_prompt=True)
            token_ids = self.tokenizer.encode(prompt)
            span.set_attribute("tokens", len(token_ids))
            pre = self._build(request, token_ids,
                              request.max_output_tokens())
            return pre, self._annotations(ext.annotations or [], prompt,
                                          token_ids)

    def preprocess_completion(
        self, request: CompletionRequest
    ) -> Tuple[PreprocessedRequest, List[Annotated]]:
        with tracing.get_tracer().start_span("preprocess") as span:
            pre, annotations = self._preprocess_completion(request)
            span.set_attribute("tokens", len(pre.token_ids))
            return pre, annotations

    def _preprocess_completion(
        self, request: CompletionRequest
    ) -> Tuple[PreprocessedRequest, List[Annotated]]:
        ext = request.extension()
        prompt = request.prompt
        prompt_text: Optional[str] = None
        if isinstance(prompt, str):
            prompt_text = prompt
            token_ids = self.tokenizer.encode(prompt_text)
        elif isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            token_ids = list(prompt)  # pre-tokenized prompt
        elif isinstance(prompt, list) and len(prompt) == 1:
            inner = prompt[0]
            if isinstance(inner, str):
                prompt_text = inner
                token_ids = self.tokenizer.encode(prompt_text)
            else:
                token_ids = list(inner)
        elif isinstance(prompt, list) and len(prompt) > 1:
            raise ValueError(
                "batch prompts (multiple prompts per request) are not "
                "supported; send one request per prompt")
        else:
            raise ValueError("prompt must be a non-empty string or token list")
        pre = self._build(request, token_ids, request.max_tokens)
        return pre, self._annotations(ext.annotations or [],
                                      prompt_text or "", token_ids)

    def _build(self, request, token_ids: List[int],
               max_tokens: Optional[int]) -> PreprocessedRequest:
        ext = request.extension()
        budget = self.mdc.context_length - len(token_ids)
        if budget <= 0:
            raise ValueError(
                f"prompt ({len(token_ids)} tokens) exceeds the model context "
                f"length ({self.mdc.context_length})")
        sampling = SamplingOptions(
            temperature=request.temperature, top_p=request.top_p,
            top_k=getattr(request, "top_k", None),
            frequency_penalty=request.frequency_penalty,
            presence_penalty=request.presence_penalty,
            repetition_penalty=getattr(request, "repetition_penalty", None),
            logit_bias=({int(k): float(v)
                         for k, v in request.logit_bias.items()}
                        if getattr(request, "logit_bias", None) else None),
            seed=request.seed, n=request.n or 1)
        if ext.greedy_sampling:
            sampling.temperature = 0.0
        if max_tokens is not None and max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        stop = StopConditions(
            max_tokens=min(max_tokens, budget) if max_tokens is not None else budget,
            stop=request.stop_list(),
            min_tokens=getattr(request, "min_tokens", None),
            ignore_eos=bool(ext.ignore_eos))
        raw_logprobs = getattr(request, "logprobs", None)
        top_lp: Optional[int] = getattr(request, "top_logprobs", None)
        if top_lp is not None and raw_logprobs is not True:
            # OpenAI: top_logprobs requires logprobs=true (400 otherwise)
            raise ValueError("top_logprobs requires logprobs to be true")
        logprobs: Optional[int] = top_lp
        if logprobs is None:
            if raw_logprobs is True:
                logprobs = 0  # sampled-token logprob only
            elif (isinstance(raw_logprobs, int)
                  and not isinstance(raw_logprobs, bool)):
                logprobs = raw_logprobs  # completions-style integer
        if logprobs is not None and not 0 <= logprobs <= 20:
            raise ValueError("logprobs/top_logprobs must be between 0 "
                             "and 20")
        output = OutputOptions(
            logprobs=logprobs,
            echo_prompt=bool(getattr(request, "echo", False)))
        return PreprocessedRequest(
            token_ids=token_ids, sampling=sampling, stop=stop, output=output,
            eos_token_ids=list(self.tokenizer.eos_token_ids),
            mdc_sum=self._mdcsum,
            annotations=list(ext.annotations or []))

    def _annotations(self, requested: List[str], prompt: str,
                     token_ids: List[int]) -> List[Annotated]:
        out = []
        if ANNOTATION_FORMATTED_PROMPT in requested:
            out.append(Annotated.from_annotation(ANNOTATION_FORMATTED_PROMPT,
                                                 prompt))
        if ANNOTATION_TOKEN_IDS in requested:
            out.append(Annotated.from_annotation(ANNOTATION_TOKEN_IDS,
                                                 token_ids))
        return out

    # ----------------------------------------------------------- responses

    async def chat_stream(
        self,
        request: ChatCompletionRequest,
        engine_stream: AsyncIterator[EngineOutput],
        context: Context,
        prompt_tokens: int,
    ) -> AsyncIterator[ChatCompletionChunk]:
        """Map the backend's EngineOutput stream to OpenAI chat chunks."""
        gen = ChatDeltaGenerator(request.model, context.id)
        yield gen.role_chunk()
        completion_tokens = 0
        finish: Optional[str] = None
        async for out in engine_stream:
            completion_tokens += len(out.token_ids)
            if out.completion_tokens is not None:
                completion_tokens = out.completion_tokens
            lp = chat_logprobs_content(out, self.tokenizer)
            if out.text or out.finish_reason or lp:
                yield gen.content_chunk(out.text or "", out.finish_reason,
                                        logprobs=lp)
            if out.finish_reason:
                finish = out.finish_reason
                break
        if finish is None:
            yield gen.content_chunk("", "stop")
        if request.stream_options and request.stream_options.include_usage:
            yield gen.usage_chunk(Usage(
                prompt_tokens=prompt_tokens,
                completion_tokens=completion_tokens,
                total_tokens=prompt_tokens + completion_tokens))


def chat_logprobs_content(out, tokenizer) -> Optional[dict]:
    """EngineOutput logprob fields → the OpenAI chat ``logprobs`` object
    ({"content": [{token, logprob, bytes, top_logprobs}]}). None when the
    request did not ask (the engine attaches the fields only then).
    Logprobs describe the RAW model distribution: sampling penalties and
    temperature are not reflected. "bytes" come from the DECODED string,
    so a byte-fallback token that splits a multi-byte character shows
    the replacement character's bytes."""
    if not out.logprobs or not out.token_ids:
        return None

    def entry(tid: int, lp: float, tops: dict) -> dict:
        s = tokenizer.decode([int(tid)])
        return {"token": s, "logprob": lp, "bytes": list(s.encode()),
                "top_logprobs": [
                    {"token": tokenizer.decode([int(t)]), "logprob": v,
                     "bytes": list(tokenizer.decode([int(t)]).encode())}
                    for t, v in (tops or {}).items()]}

    tops_list = out.top_logprobs or [{}] * len(out.token_ids)
    return {"content": [entry(t, lp, tp) for t, lp, tp in
                        zip(out.token_ids, out.logprobs, tops_list)]}


def completion_logprobs(out, tokenizer, offset: int) -> Optional[dict]:
    """Legacy completions logprobs object: parallel ``tokens`` /
    ``token_logprobs`` / ``top_logprobs`` / ``text_offset`` lists.

    ``offset`` is the caller's position in the ASSEMBLED response text
    (echoed prompt included) at the start of this chunk; every token in
    the chunk reports that offset (per-token decode lengths would drift
    off the text: the incremental detokenizer holds UTF-8 bytes and
    jailed stop prefixes)."""
    if not out.logprobs or not out.token_ids:
        return None
    tokens, t_lps, tops, offs = [], [], [], []
    tops_list = out.top_logprobs or [{}] * len(out.token_ids)
    for tid, lp, tp in zip(out.token_ids, out.logprobs, tops_list):
        tokens.append(tokenizer.decode([int(tid)]))
        t_lps.append(lp)
        tops.append({tokenizer.decode([int(t)]): v
                     for t, v in (tp or {}).items()})
        offs.append(offset)
    return {"tokens": tokens, "token_logprobs": t_lps,
            "top_logprobs": tops, "text_offset": offs}
