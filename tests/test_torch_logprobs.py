"""Logprobs in the port, against the JAX package's (tests/test_logprobs.py
case by case): logprob_aux against the JAX function and numpy; the
engine's logprobs end to end on the CPU at ModelConfig.tiny() in float32
with the JAX engine's weights, on the prefill first token and in every
window step, within 1e-4 of JaxEngine's and absent when not asked for;
the logprobs graph variants warmup() captures; and the OpenAI response
shapes through the port's HTTP service (chat content entries, legacy
completions lists; top_logprobs without logprobs=true is a 400)."""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.jax_engine import JaxEngine
from dynamo_tpu.engine.sampling import compute_logprobs as jax_compute_logprobs
from dynamo_tpu.engine.sampling import logprob_aux as jax_logprob_aux
from dynamo_tpu.llm.protocols.common import OutputOptions as JaxOutput
from dynamo_tpu.llm.protocols.common import (PreprocessedRequest as
                                             JaxRequest)
from dynamo_tpu.llm.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.llm.protocols.common import StopConditions as JaxStop
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.cuda_graphs import PEN_NONE
from dynamo_tpu_torch.engine.sampling import logprob_aux
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols.common import (OutputOptions,
                                                   PreprocessedRequest,
                                                   SamplingOptions,
                                                   StopConditions)
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.engine import Context

# the JAX logprobs tests' engine config
ECFG = dict(page_size=8, num_pages=64, max_batch=4, prefill_chunk=32,
            prefill_buckets=(32,), batch_buckets=(4,), page_buckets=(16,),
            decode_steps=4, max_top_logprobs=3)
LP_TOL = 1e-4


def test_logprob_aux_math():
    """The chosen tokens' log-probabilities and the top entries,
    descending, against numpy and the JAX function (top ids compared
    where neighbouring values differ by more than the tolerance: the two
    top_k may order ties differently)."""
    rng = np.random.RandomState(0)
    logits = (rng.randn(3, 50) * 2).astype(np.float32)
    chosen = np.array([7, 0, 49], np.int32)
    lp, tv, ti = logprob_aux(torch.from_numpy(logits),
                             torch.from_numpy(chosen), 4)
    ref = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    np.testing.assert_allclose(lp.numpy(), ref[np.arange(3), chosen],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        lp.numpy(), np.asarray(jax_compute_logprobs(jnp.asarray(logits),
                                                    jnp.asarray(chosen))),
        rtol=1e-5, atol=1e-5)
    assert ti.dtype == torch.int32 and tv.shape == (3, 4)
    jlp, jtv, jti = jax_logprob_aux(jnp.asarray(logits), jnp.asarray(chosen),
                                    4)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jtv), atol=1e-5)
    for b in range(3):
        want = np.sort(ref[b])[::-1][:4]
        np.testing.assert_allclose(tv[b].numpy(), want, rtol=1e-5,
                                   atol=1e-5)
        gaps = np.diff(want)
        for k in range(4):
            if ((k == 0 or -gaps[k - 1] > 1e-5)
                    and (k == 3 or -gaps[k] > 1e-5)):
                assert int(ti[b, k]) == int(np.asarray(jti)[b, k])


def _engines(**torch_ecfg):
    jcfg, tcfg = JaxModelConfig.tiny(), ModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 jparams.items()}, tcfg, device="cpu")
    jeng = JaxEngine(jcfg, JaxEngineConfig(**ECFG), params=jparams)
    teng = TorchEngine(tcfg, EngineConfig(**{**ECFG, **torch_ecfg}),
                       params=tparams, device="cpu")
    return jeng, teng


def _serve(engine, jobs, jax_side: bool):
    """Serve ``jobs`` [(prompt, logprobs, sampling kwargs, n)]
    concurrently; each job's EngineOutputs."""
    req_cls, samp_cls, stop_cls, out_cls, ctx_cls = (
        (JaxRequest, JaxSampling, JaxStop, JaxOutput, JaxContext)
        if jax_side else (PreprocessedRequest, SamplingOptions,
                          StopConditions, OutputOptions, Context))

    async def one(prompt, logprobs, kw, n, delay):
        await asyncio.sleep(delay)
        req = req_cls(token_ids=list(prompt), sampling=samp_cls(**kw),
                      stop=stop_cls(max_tokens=n, ignore_eos=True),
                      output=out_cls(logprobs=logprobs), eos_token_ids=[])
        outs = []
        async for out in engine.generate(req, ctx_cls()):
            outs.append(out)
            if out.finish_reason:
                break
        return outs

    async def main():
        try:
            return await asyncio.gather(*[
                one(*job, 0.01 * i) for i, job in enumerate(jobs)])
        finally:
            await engine.stop()

    return asyncio.run(main())


def _per_token(outs):
    return [(t, o.logprobs[k], o.top_logprobs[k])
            for o in outs if o.logprobs
            for k, t in enumerate(o.token_ids)]


@pytest.mark.parametrize("pipeline", [True, False])
def test_engine_emits_logprobs_end_to_end(pipeline):
    """Greedy with logprobs=2 beside a plain row and a penalised one:
    every emitted token (the prefill's first and K=4 window steps)
    carries its logprob and 2 alternatives, within 1e-4 of JaxEngine's,
    with the same tokens; the greedy token is the top-1, so its logprob
    is the best alternative's; the logprobs of a penalised row describe
    the RAW logits (the chosen token's logprob is not the top-1)."""
    jeng, teng = _engines(pipeline_decode=pipeline)
    jobs = [([3, 1, 4, 1, 5, 9], 2, {}, 9),
            ([2, 7, 1, 8], None, {}, 7),
            ([3, 1, 4, 1, 5, 9], 1, {"logit_bias": {11: 50.0}}, 5)]
    want = _serve(jeng, jobs, True)
    got = _serve(teng, jobs, False)
    for g, w in zip(got, want):
        assert ([t for o in g for t in o.token_ids]
                == [t for o in w for t in o.token_ids])
    per_tok = _per_token(got[0])
    assert len(per_tok) == 9
    for (tok, lp, top), (wtok, wlp, wtop) in zip(per_tok,
                                                 _per_token(want[0])):
        assert tok == wtok and abs(lp - wlp) < LP_TOL
        assert lp <= 0.0 and len(top) == 2
        best = max(top.values())
        assert abs(lp - best) < 1e-5 and tok in top
        assert sorted(top.values()) == pytest.approx(sorted(wtop.values()),
                                                     abs=LP_TOL)
    assert all(o.logprobs is None for o in got[1])
    biased = _per_token(got[2])
    assert [t for t, _, _ in biased] == [11] * 5
    for (tok, lp, top), (_, wlp, _) in zip(biased, _per_token(want[2])):
        assert abs(lp - wlp) < LP_TOL and len(top) == 1
        assert lp < max(top.values()) - 1e-3


def test_engine_no_logprobs_fields_absent():
    _, teng = _engines()
    outs = _serve(teng, [([1, 2, 3], None, {}, 5)], False)[0]
    assert all(o.logprobs is None and o.top_logprobs is None for o in outs)
    assert set(teng.decode_variants) == {(0, PEN_NONE)}


def test_warmup_captures_the_logprobs_variants():
    """warmup_logprobs (the default) captures the logprobs variant of
    every decode and prefill bucket beside the plain one; logprobs
    requests then serve without a capture. Off, it captures none."""
    _, teng = _engines()
    n = teng.warmup()
    grid = teng.ecfg.warmed_grid()
    n_dec = len(grid["decode_batches"]) * len(grid["page_buckets"])
    n_pre = (len(grid["prefill_batches"]) * len(grid["prefill_lens"])
             * len(grid["page_buckets"]))
    assert n == 2 * (n_dec + n_pre)
    assert set(teng.decode_variants) == {(0, PEN_NONE), (3, PEN_NONE)}
    assert set(teng.prefill_variants) == {0, 3}
    assert len(teng.decode_variants[(3, PEN_NONE)].buckets) == n_dec
    assert len(teng.prefill_variants[3].buckets) == n_pre
    assert set(teng.graph_pool_mib()) == {
        "decode window, plain", "decode window, logprobs 3",
        "prefill chunk, plain", "prefill chunk, logprobs 3"}
    outs = _serve(teng, [([3, 1, 4], 3, {}, 6)], False)[0]
    assert len(_per_token(outs)) == 6
    assert teng.stats()["post_warmup_compiles_total"] == 0
    _, off = _engines(warmup_logprobs=False)
    assert off.warmup() == n_dec + n_pre
    assert set(off.decode_variants) == {(0, PEN_NONE)}


def _mdc():
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    return ModelDeploymentCard(name="m", kv_block_size=8)


def test_http_chat_and_completion_logprob_shapes():
    """OpenAI response shapes through the port's HTTP chain: chat
    choices[].logprobs.content[] entries with token/logprob/bytes/
    top_logprobs, unary and streamed; completions: parallel tokens/
    token_logprobs/top_logprobs/text_offset lists."""
    import aiohttp

    from dynamo_tpu_torch.run import serve_http

    _, teng = _engines()

    async def main():
        svc = await serve_http(teng, _mdc(), "127.0.0.1", 0)
        base = f"http://127.0.0.1:{svc.port}"
        try:
            async with aiohttp.ClientSession() as http:
                body = {"model": "m", "max_tokens": 4,
                        "logprobs": True, "top_logprobs": 2,
                        "messages": [{"role": "user", "content": "hi"}]}
                async with http.post(f"{base}/v1/chat/completions",
                                     json=body) as r:
                    assert r.status == 200, await r.text()
                    chat = await r.json()
                streamed = []
                async with http.post(f"{base}/v1/chat/completions",
                                     json={**body, "stream": True}) as r:
                    async for line in r.content:
                        line = line.decode().strip()
                        if line.startswith("data: {"):
                            streamed.append(json.loads(line[6:]))
                cbody = {"model": "m", "prompt": "hello", "max_tokens": 4,
                         "logprobs": 2}
                async with http.post(f"{base}/v1/completions",
                                     json=cbody) as r:
                    assert r.status == 200, await r.text()
                    comp = await r.json()
        finally:
            await svc.stop()
            await teng.stop()
        return chat, streamed, comp

    chat, streamed, comp = asyncio.run(main())
    clp = chat["choices"][0].get("logprobs")
    assert clp is not None and len(clp["content"]) == 4
    e = clp["content"][0]
    assert set(e) >= {"token", "logprob", "bytes", "top_logprobs"}
    assert len(e["top_logprobs"]) == 2 and e["logprob"] <= 0.0
    entries = [c for ch in streamed for choice in ch["choices"]
               for c in (choice.get("logprobs") or {}).get("content", [])]
    assert [x["logprob"] for x in entries] == pytest.approx(
        [x["logprob"] for x in clp["content"]], abs=1e-6)
    lp = comp["choices"][0].get("logprobs")
    assert lp is not None
    assert len(lp["tokens"]) == len(lp["token_logprobs"]) == 4
    assert len(lp["top_logprobs"]) == 4
    # keyed by token STRING: distinct ids may decode to the same string
    assert all(1 <= len(d) <= 2 for d in lp["top_logprobs"])
    assert lp["text_offset"][0] == 0
    assert all(isinstance(t, str) for t in lp["tokens"])


def test_top_logprobs_requires_logprobs_flag():
    """OpenAI validation: top_logprobs without logprobs=true → 400; out
    of range → 400."""
    import aiohttp

    from dynamo_tpu_torch.run import serve_http

    _, teng = _engines()

    async def main():
        svc = await serve_http(teng, _mdc(), "127.0.0.1", 0)
        base = f"http://127.0.0.1:{svc.port}"
        out = {}
        try:
            async with aiohttp.ClientSession() as http:
                msgs = [{"role": "user", "content": "x"}]
                for name, extra in (
                        ("no_flag", {"top_logprobs": 3}),
                        ("false_flag", {"logprobs": False,
                                        "top_logprobs": 3}),
                        ("too_many", {"logprobs": True,
                                      "top_logprobs": 50})):
                    async with http.post(
                            f"{base}/v1/chat/completions",
                            json={"model": "m", "messages": msgs,
                                  **extra}) as r:
                        out[name] = r.status
        finally:
            await svc.stop()
            await teng.stop()
        return out

    assert asyncio.run(main()) == {"no_flag": 400, "false_flag": 400,
                                   "too_many": 400}
