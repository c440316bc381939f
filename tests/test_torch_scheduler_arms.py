"""The port's synchronous and budgeted scheduler arms against the JAX
package's, on the CPU at ModelConfig.tiny() in float32 with the same
(bridged) weights, exact tokens:

- the JAX engine's ``_step`` arms, each against JaxEngine in the same
  arm: single-step decode (``decode_steps=1``), with and without a
  ``prefill_token_budget``; unpipelined windows with a budget; pipelined
  budgeted mixing (a window and a prefill chunk in flight from one
  iteration); ``prefill_priority=False``. With a budget (or without
  prefill priority) decode work runs beside prefill: the engines'
  ``mixed_dispatches`` > 0;
- the budget's trim of a prefill batch, as ``jax_engine.py`` trims it;
- the single-step graphs: warmup captures them (and no window) at
  ``decode_steps=1``, in the logprobs and penalised variants the windows
  have; a bucket missed after warmup is a fenced capture; logprobs and
  penalties served on the single-step arm equal JaxEngine's;
- the Backend's detokenization on the shared executor
  (``DYN_ASYNC_DETOK``, default on): each request's text in order under
  concurrency, and a cancelled request leaves the others whole.
"""

import asyncio
import threading

import jax
import numpy as np
import pytest

from dynamo_tpu.engine.jax_engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.jax_engine import JaxEngine
from dynamo_tpu.llm.protocols.common import (OutputOptions as JaxOutput,
                                             PreprocessedRequest as
                                             JaxRequest,
                                             SamplingOptions as JaxSampling,
                                             StopConditions as JaxStop)
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import torch_engine
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm import backend as backend_mod
from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.protocols.common import (EngineOutput,
                                                   OutputOptions,
                                                   PreprocessedRequest,
                                                   SamplingOptions,
                                                   StopConditions)
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.engine import Context

# tests/test_torch_engine.py's grid
ECFG = dict(page_size=8, num_pages=64, max_batch=4, prefill_chunk=16,
            prefill_buckets=(16,), batch_buckets=(1, 2, 4), page_buckets=(8,),
            decode_steps=4)
PROMPTS = [list(range(1, 6)), list(range(30, 70)),  # > prefill_chunk
           list(range(100, 117)), [7, 7, 7]]
MAX_TOKENS = (9, 12, 10, 5)

JAX = (JaxRequest, JaxStop, JaxContext, JaxSampling, JaxOutput)
PORT = (PreprocessedRequest, StopConditions, Context, SamplingOptions,
        OutputOptions)


def _weights():
    jcfg, tcfg = JaxModelConfig.tiny(), ModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 jparams.items()}, tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _engines(**ecfg):
    """(JaxEngine, TorchEngine) in the same arm, on the same weights."""
    jcfg, tcfg, jparams, tparams = _weights()
    kw = {**ECFG, **ecfg}
    return (JaxEngine(jcfg, JaxEngineConfig(**kw), params=jparams),
            TorchEngine(tcfg, EngineConfig(**kw), params=tparams,
                        device="cpu"))


async def _generate_all(engine, kinds, delays=(0.0, 0.0, 0.0, 0.0),
                        sampling=None, logprobs=None):
    """Every prompt's tokens (and logprobs where asked), the requests
    sent together (``delays`` apart) so prefill and decode overlap."""
    req_cls, stop_cls, ctx_cls, samp_cls, out_cls = kinds

    async def one(i):
        await asyncio.sleep(delays[i])
        req = req_cls(token_ids=list(PROMPTS[i]),
                      stop=stop_cls(max_tokens=MAX_TOKENS[i]))
        if sampling and sampling[i]:
            req.sampling = samp_cls(**sampling[i])
        if logprobs and logprobs[i]:
            req.output = out_cls(logprobs=logprobs[i])
        toks, lps = [], []
        async for out in engine.generate(req, ctx_cls()):
            toks += out.token_ids
            lps += out.logprobs or []
        return toks, lps

    try:
        return await asyncio.gather(*[one(i) for i in range(len(PROMPTS))])
    finally:
        await engine.stop()


ARMS = {
    "single_step": dict(decode_steps=1),
    "single_step_budget": dict(decode_steps=1, prefill_token_budget=32),
    "unpipelined_budget": dict(pipeline_decode=False,
                               prefill_token_budget=32),
    "pipelined_budget": dict(prefill_token_budget=32),
    "no_prefill_priority": dict(prefill_priority=False),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_arm_tokens_match_jax_engine(arm):
    """Four concurrent greedy requests (one prefilled in three chunks) in
    each arm: the port's tokens equal JaxEngine's in the same arm and the
    default arm's; with a budget, or without prefill priority, decode
    work ran beside a prefill batch (``mixed_dispatches`` > 0 in both
    engines, an attribute of each: the JAX engine's stats() has no such
    key)."""
    jeng, teng = _engines(**ARMS[arm])
    want = asyncio.run(_generate_all(jeng, JAX))
    got = asyncio.run(_generate_all(teng, PORT))
    assert [t for t, _ in got] == [t for t, _ in want]
    assert [len(t) for t, _ in got] == list(MAX_TOKENS)
    _, plain = _engines()
    assert [t for t, _ in got] == [
        t for t, _ in asyncio.run(_generate_all(plain, PORT))]
    mixes = ("budget" in arm or arm == "no_prefill_priority")
    assert (teng.mixed_dispatches > 0) == mixes
    assert (jeng.mixed_dispatches > 0) == mixes
    if arm.startswith("single_step"):
        assert teng.graph_replays()["decode_window"] == 0
    assert teng.pm.active == 0


@pytest.mark.parametrize("budget,want", [(None, 4), (5, 1), (21, 2),
                                         (37, 3), (41, 4), (1, 1)])
def test_prefill_budget_trims_the_batch_as_jax(budget, want):
    """The budget keeps the batch's rows while their chunks fit it (the
    head always ships, whole), as ``jax_engine.py`` ``_dispatch_prefill``
    trims it: chunks of 5, 16, 16 and 3 tokens."""
    from dynamo_tpu.engine.jax_engine import Sequence as JaxSequence

    jeng, teng = _engines()
    for eng, seq_cls, (req_cls, stop_cls, ctx_cls, *_) in (
            (teng, torch_engine.Sequence, PORT), (jeng, JaxSequence, JAX)):
        for p in PROMPTS:
            seq = seq_cls(
                req=req_cls(token_ids=list(p), stop=stop_cls(max_tokens=1)),
                context=ctx_cls(), out=None, tokens=list(p),
                num_prompt=len(p))
            seq.pages = eng.pm.allocate_sequence(seq.tokens)[0]
            eng.prefilling.append(seq)
        seqs = list(eng.prefilling)
        assert eng._dispatch_prefill(budget) is not None
        assert [s.computed > 0 for s in seqs] == [i < want for i in
                                                   range(len(seqs))], eng


def test_single_step_warmup_captures_steps_and_a_miss_counts():
    """At ``decode_steps=1`` warmup captures one single-step graph per
    (batch, page) bucket in the plain, logprobs and penalised variants
    (as the windows are warmed) and no window; serving captures nothing;
    a bucket dropped after warmup is a fenced capture, counted."""
    _, teng = _engines(decode_steps=1, warmup_penalties=True)
    n = teng.warmup()
    grid = EngineConfig(**ECFG).warmed_grid()
    decode = len(grid["decode_batches"]) * len(grid["page_buckets"])
    assert set(teng.step_variants) == {(0, 0), (20, 0), (0, 1), (20, 1)}
    assert all(len(gs.buckets) == decode
               for gs in teng.step_variants.values())
    assert not teng.graphs.buckets and len(teng.decode_variants) == 1
    prefill = sum(len(gs.buckets) for gs in teng.prefill_variants.values())
    assert n == 4 * decode + prefill
    asyncio.run(_generate_all(teng, PORT))
    assert teng.stats()["post_warmup_compiles_total"] == 0
    _, teng = _engines(decode_steps=1)
    teng.warmup()
    teng.step_variants[(0, 0)].buckets.pop((4, 8))
    asyncio.run(_generate_all(teng, PORT))
    assert teng.stats()["post_warmup_compiles_total"] == 1


def test_single_step_logprobs_and_penalties_match_jax_engine():
    """The single-step arm's logprobs and penalised variants: a logprobs
    row and a repetition-penalised row beside greedy ones give
    JaxEngine's tokens, and the logprobs within 1e-4."""
    samp = [None, dict(repetition_penalty=1.3), None,
            dict(frequency_penalty=0.5, logit_bias={5: 3.0})]
    lps = [None, None, 3, None]
    jeng, teng = _engines(decode_steps=1)
    want = asyncio.run(_generate_all(jeng, JAX, sampling=samp,
                                     logprobs=lps))
    got = asyncio.run(_generate_all(teng, PORT, sampling=samp,
                                    logprobs=lps))
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose(got[2][1], want[2][1], atol=1e-4)
    assert len(got[2][1]) == MAX_TOKENS[2]
    # the penalised and the logprobs variants both served
    assert any(form for _, form in teng.step_variants)
    assert any(topn for topn, _ in teng.step_variants)


def test_stats_keys_are_jax_engine_keys_in_every_arm():
    for kw in ({}, dict(decode_steps=1), dict(spec_decode=True),
               dict(prefill_token_budget=8)):
        jeng, teng = _engines(**kw)
        assert set(teng.stats()) <= set(jeng.stats())
        assert {"spec_decode_steps", "spec_decode_draft_tokens_total",
                "spec_decode_accepted_tokens_total",
                "spec_decode_acceptance_rate",
                "spec_decode_mean_accepted_len"} <= set(teng.stats())


# ------------------------------------------------ async detokenization


class _ScriptedEngine:
    """Yields each request's token ids one chunk at a time, with a pause
    between chunks so that several requests interleave."""

    def __init__(self, script):
        self.script = script

    async def generate(self, request, context):
        for i, ids in enumerate(self.script[request.token_ids[0]]):
            await asyncio.sleep(0.001 * (i % 3))
            if context.stopped:
                return
            yield EngineOutput(token_ids=list(ids))
        yield EngineOutput(token_ids=[], finish_reason="length")


class _SlowTokenizer(ByteTokenizer):
    """The byte tokenizer whose decode steps run off the loop thread and
    take a little time, recording the threads they ran on."""

    threads: set = set()

    def decode_stream(self, skip_special_tokens=True):
        inner = super().decode_stream(skip_special_tokens)
        outer = self

        class Stream:
            def step(self, tid):
                outer.threads.add(threading.current_thread().name)
                threading.Event().wait(0.0005)
                return inner.step(tid)

            def flush(self):
                return inner.flush()

        return Stream()


@pytest.mark.parametrize("offload", ["1", "0"])
def test_async_detok_keeps_each_request_in_order(offload, monkeypatch):
    """Eight concurrent requests, each a text of its own in chunks of 1-3
    bytes: every request's text comes back whole and in order, with the
    decodes on the shared executor's threads (DYN_ASYNC_DETOK=1, the
    default) or on the loop's thread (0)."""
    monkeypatch.setenv("DYN_ASYNC_DETOK", offload)
    texts = {i: f"request {i}: " + "abcdefghij" * (i + 1) for i in range(8)}
    script = {}
    for i, t in texts.items():
        b = list(t.encode())
        chunks, j = [], 0  # chunks of 1-3 bytes
        while j < len(b):
            n = 1 + j % 3
            chunks.append(b[j:j + n])
            j += n
        script[i] = chunks
    tok = _SlowTokenizer()
    tok.threads = set()
    be = Backend(_ScriptedEngine(script), tok)

    async def one(i):
        req = PreprocessedRequest(token_ids=[i], stop=StopConditions())
        text = ""
        async for out in be.generate(req, Context()):
            text += out.text or ""
        return text

    async def run():
        return await asyncio.gather(*[one(i) for i in range(8)])

    got = asyncio.run(run())
    assert got == [texts[i] for i in range(8)]
    on_pool = {t for t in tok.threads if t.startswith("dyn-detok")}
    assert bool(on_pool) == (offload == "1")
    assert len(on_pool) <= 2


def test_async_detok_isolates_a_cancelled_request(monkeypatch):
    """A request cancelled mid-stream ends with a cancel finish while
    the others' texts come back whole."""
    monkeypatch.delenv("DYN_ASYNC_DETOK", raising=False)
    assert backend_mod.env_bool("DYN_ASYNC_DETOK")  # on by default
    texts = {i: ("xyz" * 20) + str(i) for i in range(4)}
    script = {i: [[b] for b in t.encode()] for i, t in texts.items()}
    be = Backend(_ScriptedEngine(script), _SlowTokenizer())

    async def one(i):
        ctx = Context()
        req = PreprocessedRequest(token_ids=[i], stop=StopConditions())
        text, fin, n = "", None, 0
        async for out in be.generate(req, ctx):
            text += out.text or ""
            fin = out.finish_reason or fin
            n += 1
            if i == 1 and n == 5:
                ctx.stop_generating()
        return text, fin

    async def run():
        return await asyncio.gather(*[one(i) for i in range(4)])

    got = asyncio.run(run())
    for i in (0, 2, 3):
        assert got[i] == (texts[i], "length")
    assert got[1][1] == "cancelled" and texts[1].startswith(got[1][0])
    assert len(got[1][0]) < len(texts[1])
