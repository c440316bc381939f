"""Sampling penalties (repetition / frequency / presence) and logit_bias
in the port, against the JAX package's (tests/test_penalties.py case by
case): apply_penalties against the HF logits processor, the OpenAI
definitions and the JAX function; update_penalty_state and the device
rebuild of the state against the JAX functions, on seeded inputs to
float32 tolerance; and the serving path end to end on the CPU at
ModelConfig.tiny() in float32 with the JAX engine's weights: greedy
penalised tokens identical to JaxEngine's (inside the fused window,
across windows and on the prefill first token), pipelined and
unpipelined agreeing, logit_bias forcing and banning, and the penalised
graph variants warmup_penalties adds."""

import asyncio
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import sampling as js
from dynamo_tpu.engine.jax_engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.jax_engine import JaxEngine
from dynamo_tpu.llm.protocols.common import (PreprocessedRequest as
                                             JaxRequest)
from dynamo_tpu.llm.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.llm.protocols.common import StopConditions as JaxStop
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import sampling as ts
from dynamo_tpu_torch.engine.cuda_graphs import (PEN_FULL, PEN_NONE,
                                              PenaltyBuffers)
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols.common import (OutputOptions,
                                                   PreprocessedRequest,
                                                   SamplingOptions,
                                                   StopConditions)
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.engine import Context

TOL = 1e-5
# the JAX penalty tests' engine config
ECFG = dict(page_size=8, num_pages=64, max_batch=4, prefill_chunk=32,
            prefill_buckets=(32,), batch_buckets=(4,), page_buckets=(16,),
            decode_steps=4)


def _state(rng, B, V):
    counts = rng.randint(0, 3, (B, V)).astype(np.int32)
    counts[rng.rand(B, V) < 0.7] = 0
    presence = (rng.rand(B, V) < 0.3).astype(np.int8)
    return counts, presence


def test_repetition_penalty_matches_transformers():
    """HF RepetitionPenaltyLogitsProcessor is the oracle, as for the JAX
    function."""
    from transformers import RepetitionPenaltyLogitsProcessor

    rng = np.random.RandomState(0)
    V = 40
    logits = rng.randn(1, V).astype(np.float32) * 3
    ctx = np.array([[3, 7, 7, 12]])
    want = RepetitionPenaltyLogitsProcessor(penalty=1.7)(
        torch.tensor(ctx), torch.tensor(logits)).numpy()
    presence = np.zeros((1, V), np.int8)
    presence[0, ctx[0]] = 1
    got = ts.apply_penalties(torch.from_numpy(logits),
                             torch.zeros((1, V), dtype=torch.int32),
                             torch.from_numpy(presence),
                             torch.tensor([1.7]), torch.zeros(1),
                             torch.zeros(1))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_frequency_presence_penalties_openai_semantics():
    """OpenAI: logits[t] -= freq*count[t] + pres*(count[t]>0), counts
    over GENERATED tokens only."""
    V = 10
    counts = torch.tensor([[0, 1, 3, 0, 0, 0, 0, 0, 0, 0]], dtype=torch.int32)
    out = ts.apply_penalties(torch.zeros((1, V)), counts,
                             torch.zeros((1, V), dtype=torch.int8),
                             torch.ones(1), torch.tensor([0.5]),
                             torch.tensor([0.25]))[0].numpy()
    assert out[0] == 0.0
    np.testing.assert_allclose(out[1], -0.5 * 1 - 0.25)
    np.testing.assert_allclose(out[2], -0.5 * 3 - 0.25)


@pytest.mark.parametrize("bias", [False, True])
def test_apply_penalties_matches_jax(bias):
    """Seeded logits, state and per-row penalties (neutral rows among
    them), with and without the bias rows: the port equals the JAX
    function to float32 tolerance; and neutral rep, freq and pres over a
    non-empty state (the engine's bias-only batches, which skip the state
    rebuild) give the JAX bias-only placeholder state's result, which is
    exactly logits + bias."""
    rng = np.random.RandomState(1)
    B, V = 6, 300
    logits = (rng.randn(B, V) * 4).astype(np.float32)
    counts, presence = _state(rng, B, V)
    rep = np.array([1.0, 1.3, 0.8, 2.0, 1.0, 1.1], np.float32)
    freq = np.array([0.0, 0.5, -0.3, 0.0, 1.2, 0.1], np.float32)
    pres = np.array([0.0, 0.2, 0.0, -0.5, 0.7, 0.3], np.float32)
    extra = ((rng.randn(B, V) * 3).astype(np.float32),) if bias else ()
    want = js.apply_penalties(jnp.asarray(logits), jnp.asarray(counts),
                              jnp.asarray(presence), jnp.asarray(rep),
                              jnp.asarray(freq), jnp.asarray(pres),
                              *map(jnp.asarray, extra))
    got = ts.apply_penalties(torch.from_numpy(logits),
                             torch.from_numpy(counts),
                             torch.from_numpy(presence),
                             torch.from_numpy(rep), torch.from_numpy(freq),
                             torch.from_numpy(pres),
                             *map(torch.from_numpy, extra))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    if bias:
        ones, zeros = np.ones(B, np.float32), np.zeros(B, np.float32)
        want = js.apply_penalties(
            jnp.asarray(logits), jnp.zeros((B, 1), jnp.int32),
            jnp.zeros((B, 1), jnp.int8), jnp.asarray(ones),
            jnp.asarray(zeros), jnp.asarray(zeros), jnp.asarray(extra[0]))
        got = ts.apply_penalties(
            torch.from_numpy(logits), torch.from_numpy(counts),
            torch.from_numpy(presence), torch.from_numpy(ones),
            torch.from_numpy(zeros), torch.from_numpy(zeros),
            torch.from_numpy(extra[0]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(got.numpy(), logits + extra[0])


def test_update_penalty_state_matches_jax():
    """A window step's tokens fold into the counts and presence under
    the PRE-step done mask, as the JAX function folds them; None stays
    None."""
    rng = np.random.RandomState(2)
    B, V = 5, 64
    counts, presence = _state(rng, B, V)
    sampled = np.array([3, 3, 63, 0, 17], np.int32)
    done = np.array([False, True, False, False, True])
    rest = (np.ones(B, np.float32), np.zeros(B, np.float32),
            np.zeros(B, np.float32))
    want = js.update_penalty_state(
        (jnp.asarray(counts), jnp.asarray(presence),
         *map(jnp.asarray, rest)), jnp.asarray(sampled), jnp.asarray(done))
    got = ts.update_penalty_state(
        (torch.from_numpy(counts), torch.from_numpy(presence),
         *map(torch.from_numpy, rest)), torch.from_numpy(sampled),
        torch.from_numpy(done))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int8
    # out of place: the inputs keep their values
    assert int(got[0][0, 3]) == counts[0, 3] + 1
    assert ts.update_penalty_state(None, torch.from_numpy(sampled),
                                   torch.from_numpy(done)) is None


def test_fill_penalty_state_matches_jax_engine_state():
    """The device rebuild of (counts, presence) from the rows' token ids
    equals the JAX engine's host-built _penalty_state: counts over the
    generated tokens only, presence over the whole context, padding rows
    empty, out-of-vocabulary ids skipped."""
    V = 50
    seqs = [SimpleNamespace(tokens=[4, 9, 9, 2, 7, 7, 7], num_prompt=3),
            SimpleNamespace(tokens=[0, 1], num_prompt=2),
            SimpleNamespace(tokens=[5, 60, 5, 49, 0], num_prompt=1)]
    stub = SimpleNamespace(cfg=SimpleNamespace(vocab_size=V))
    w_counts, w_pres = JaxEngine._penalty_state(stub, seqs, 4)
    ids = np.full((4, 7), -1, np.int32)
    starts = np.zeros(4, np.int32)
    for i, s in enumerate(seqs):
        ids[i, :len(s.tokens)] = s.tokens
        starts[i] = s.num_prompt
    counts = torch.full((4, V), 7, dtype=torch.int32)
    presence = torch.full((4, V), 3, dtype=torch.int8)
    ts.fill_penalty_state(counts, presence, torch.from_numpy(ids),
                          torch.from_numpy(starts))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(w_counts))
    np.testing.assert_array_equal(presence.numpy(), np.asarray(w_pres))


def test_sampling_batch_detects_penalties():
    none = ts.SamplingBatch.build([SamplingOptions()], 1)
    assert not none.has_penalties
    assert ts.SamplingBatch.build(
        [SamplingOptions(repetition_penalty=1.3)], 1).has_penalties
    assert ts.SamplingBatch.build(
        [SamplingOptions(frequency_penalty=0.5)], 2).has_penalties
    assert ts.SamplingBatch.build(
        [SamplingOptions(presence_penalty=0.1)], 1).has_penalties
    sb = ts.SamplingBatch.build([SamplingOptions(repetition_penalty=0)], 2)
    assert not sb.has_penalties and sb.rep.tolist() == [1.0, 1.0]


def test_greedy_sampler_with_penalties_matches_jax():
    """The sampler's greedy rows take the argmax of the PENALISED logits,
    token for token as the JAX sampler."""
    rng = np.random.RandomState(3)
    B, V = 8, 200
    logits = rng.randn(B, V).astype(np.float32)
    counts, presence = _state(rng, B, V)
    rep = (1.0 + rng.rand(B)).astype(np.float32)
    freq = rng.rand(B).astype(np.float32)
    pres = rng.rand(B).astype(np.float32)
    bias = np.zeros((B, V), np.float32)
    bias[2, 11] = 100.0
    zeros, ones = np.zeros(B, np.float32), np.ones(B, np.float32)
    pen = (counts, presence, rep, freq, pres, bias)
    want = js.sample_tokens(
        jnp.asarray(logits), jnp.asarray(zeros),
        jnp.zeros(B, jnp.int32), jnp.asarray(ones),
        jnp.zeros(B, jnp.uint32), jnp.int32(0),
        penalties=tuple(map(jnp.asarray, pen)))
    got = ts.sample_tokens(torch.from_numpy(logits), zeros,
                           np.zeros(B, np.int32), ones,
                           np.zeros(B, np.uint32), 0,
                           penalties=tuple(map(torch.from_numpy, pen)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[2]) == 11


# --------------------------------------------------------------- serving


def _engines(**torch_ecfg):
    """(JaxEngine, TorchEngine) with the same weights; ``torch_ecfg``
    overrides the port's EngineConfig only."""
    jcfg, tcfg = JaxModelConfig.tiny(), ModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 jparams.items()}, tcfg, device="cpu")
    jeng = JaxEngine(jcfg, JaxEngineConfig(**ECFG), params=jparams)
    teng = TorchEngine(tcfg, EngineConfig(**{**ECFG, **torch_ecfg}),
                       params=tparams, device="cpu")
    return jeng, teng


def _run(engine, jobs, jax_side: bool, then=()):
    """Serve ``jobs`` [(prompt, sampling kwargs, n)] concurrently, then,
    once they have all finished, the jobs of ``then`` the same way; the
    token lists in job order."""
    req_cls, samp_cls, stop_cls, ctx_cls = (
        (JaxRequest, JaxSampling, JaxStop, JaxContext) if jax_side else
        (PreprocessedRequest, SamplingOptions, StopConditions, Context))

    async def one(prompt, kw, n, delay):
        await asyncio.sleep(delay)
        req = req_cls(token_ids=list(prompt), sampling=samp_cls(**kw),
                      stop=stop_cls(max_tokens=n, ignore_eos=True),
                      eos_token_ids=[])
        toks = []
        async for out in engine.generate(req, ctx_cls()):
            toks.extend(out.token_ids)
            if out.finish_reason:
                break
        return toks

    async def main():
        try:
            out = []
            for batch in (jobs, then):
                out += await asyncio.gather(*[
                    one(p, kw, n, 0.01 * i) for i, (p, kw, n) in
                    enumerate(batch)])
            return out
        finally:
            await engine.stop()

    return asyncio.run(main())


LOOP_PROMPT = [(i * 11) % 200 + 1 for i in range(12)]


def test_engine_repetition_penalty_breaks_greedy_loops():
    """A strong repetition penalty changes the GREEDY continuation and
    cuts repetition, across several K=4 windows (the in-window state and
    the per-dispatch rebuild both take part): tokens identical to
    JaxEngine's, penalised and plain."""
    jeng, teng = _engines()
    jobs = [(LOOP_PROMPT, {}, 24),
            (LOOP_PROMPT, {"repetition_penalty": 8.0}, 24)]
    want = _run(jeng, jobs, True)
    got = _run(teng, jobs, False)
    assert got == want
    plain, pen = got

    def max_count(toks):
        return int(np.unique(np.asarray(toks), return_counts=True)[1].max())

    assert len(pen) == 24 and max_count(pen) < max_count(plain)
    assert pen != plain


@pytest.mark.parametrize("pipeline", [True, False])
def test_engine_presence_penalty_no_pipelining_correctness(pipeline):
    """Presence- and frequency-penalised rows in one batch with a plain
    row: the pipelined engine lands the in-flight window before each
    penalised dispatch (host token lists exact), and pipelined and
    unpipelined give JaxEngine's greedy tokens."""
    jeng, teng = _engines(pipeline_decode=pipeline)
    jobs = [([5, 9, 2, 6, 5, 3], {"presence_penalty": 2.0}, 16),
            ([5, 9, 2, 6, 5, 3], {}, 16),
            ([40, 41, 40, 41], {"frequency_penalty": 1.5}, 13)]
    want = _run(jeng, jobs, True)
    got = _run(teng, jobs, False)
    assert got == want
    assert len(got[0]) == 16 and got[0] != got[1]


def test_no_penalties_path_untouched():
    """Requests without penalties take the plain variant and give the
    same tokens twice; no penalised graph set is ever made."""
    _, teng = _engines()
    a, b = _run(teng, [([3, 1, 4, 1, 5], {}, 12)] * 2, False)
    assert a == b and len(a) == 12
    assert set(teng.decode_variants) == {(0, PEN_NONE)}
    assert teng.penalty_buffers is None


def test_warmup_penalties_flag():
    """warmup_penalties=True captures the penalised window variant, one
    graph per decode bucket on top of the plain grid; a penalty request
    and a logit_bias request then serve through the warmed engine with no
    capture, and their tokens equal JaxEngine's."""
    _, plain = _engines(warmup_logprobs=False)
    n_plain = plain.warmup()
    jeng, teng = _engines(warmup_logprobs=False, warmup_penalties=True)
    n = teng.warmup()
    grid = teng.ecfg.warmed_grid()
    n_buckets = len(grid["decode_batches"]) * len(grid["page_buckets"])
    assert n - n_plain == n_buckets
    assert set(teng.decode_variants) == {(0, PEN_NONE), (0, PEN_FULL)}
    for gs in teng.decode_variants.values():
        assert len(gs.buckets) == n_buckets
    jobs = [([1, 2, 3, 4], {"repetition_penalty": 2.0}, 8),
            ([9, 8, 7], {"logit_bias": {7: 5.0}}, 6)]
    want = _run(jeng, jobs, True)
    got = _run(teng, jobs, False)
    assert got == want and len(got[0]) == 8
    assert teng.stats()["post_warmup_compiles_total"] == 0


def test_unwarmed_penalty_request_is_a_fenced_capture():
    """On an engine warmed without penalties, the first penalty request
    makes the penalised variant's buckets on the spot: each counts in
    post_warmup_compiles_total, as the JAX compile does."""
    _, teng = _engines(warmup_logprobs=False)
    teng.warmup()
    _run(teng, [([1, 2, 3, 4], {"presence_penalty": 1.0}, 8)], False)
    assert teng.stats()["post_warmup_compiles_total"] >= 1
    assert len(teng.decode_variants[(0, PEN_FULL)].buckets) >= 1


def test_logit_bias_forces_and_bans_tokens():
    """OpenAI logit_bias: +100 forces a token under greedy on every step
    (prefill first token included), -100 bans it, end to end through the
    engine; both as JaxEngine."""
    jeng, teng = _engines()
    plain = _run(_engines()[1], [([1, 2, 3], {}, 6)], False)[0]
    jobs = [([1, 2, 3], {"logit_bias": {7: 100.0}}, 6),
            ([1, 2, 3], {"logit_bias": {int(plain[0]): -100.0}}, 6)]
    want = _run(jeng, jobs, True)
    got = _run(teng, jobs, False)
    assert got == want
    assert got[0] == [7] * 6 and got[1][0] != plain[0]
    assert set(teng.decode_variants) >= {(0, PEN_FULL)}


def test_bias_entries_are_built_once_per_sequence():
    """The logit_bias entries are built on first use and cached on the
    sequence; ids outside the vocabulary are dropped, and a token named
    twice (as "7" and 7) is one entry."""
    from dynamo_tpu_torch.engine.torch_engine import Sequence

    _, teng = _engines()
    req = PreprocessedRequest(
        token_ids=[1], sampling=SamplingOptions(logit_bias={
            3: 2.5, 9999: 1.0, "7": -1.0, 7: -2.0}))
    seq = Sequence(req=req, context=Context(), out=None, tokens=[1],
                   num_prompt=1)
    ent = teng._bias_entries(seq)
    assert teng._bias_entries(seq) is ent
    toks, vals = ent
    assert toks.dtype == np.int32 and vals.dtype == np.float32
    assert dict(zip(toks.tolist(), vals.tolist())) == {3: 2.5, 7: -2.0}


@pytest.mark.parametrize("rows", [1, 3])
def test_penalty_buffers_upload_scatters_sparse_bias(rows):
    """PenaltyBuffers.upload writes each row's logit_bias entries into
    zeroed bias rows (a previous dispatch's entries are cleared), and
    the rows' rep, freq and pres; the dense rows equal the entries
    scattered on the host."""
    V, Bmax = 40, 4
    pb = PenaltyBuffers.make(Bmax, V, torch.device("cpu"))
    pb.bias.fill_(9.0)
    rng = np.random.RandomState(rows)
    at = np.stack([np.repeat(np.arange(rows), 2),
                   rng.choice(V, 2 * rows, replace=False)]).astype(np.int32)
    val = rng.randn(2 * rows).astype(np.float32)
    rep = np.linspace(1.0, 2.0, rows).astype(np.float32)
    pb.upload(rows, rep, rep - 1, rep * 0.5, at, val)
    want = np.zeros((rows, V), np.float32)
    want[at[0], at[1]] = val
    np.testing.assert_array_equal(pb.bias[:rows].numpy(), want)
    assert (pb.bias[rows:] == 9.0).all()  # rows past B are not read
    np.testing.assert_array_equal(pb.rep[:rows].numpy(), rep)
    np.testing.assert_array_equal(pb.pres[:rows].numpy(), rep * 0.5)
    pb.upload(rows, rep, rep, rep, np.zeros((2, 0), np.int32),
              np.zeros(0, np.float32))
    assert not pb.bias[:rows].any()


def test_bias_only_batch_after_penalised_batch_matches_jax():
    """A logit_bias-only batch skips the state rebuild and reads the state
    a presence-penalised batch left in the shared buffers: its greedy
    tokens still equal JaxEngine's (neutral rows read nothing of the
    state), as do the penalised request's before it."""
    jeng, teng = _engines()
    first = [([5, 9, 2, 6, 5, 3], {"presence_penalty": 2.0}, 10)]
    then = [([5, 9, 2, 6, 5, 3], {"logit_bias": {9: 3.0, 2: -4.0}}, 10)]
    got = _run(teng, first, False, then)
    assert got == _run(jeng, first, True, then)
    # the bias-only batch left the penalised batch's state in place
    assert teng.penalty_buffers.counts.any()
    assert got[0] != got[1]


def test_logit_bias_http_mapping():
    """The OpenAI request's {str token id: bias} map reaches the port's
    SamplingOptions as {int: float}."""
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest

    req = ChatCompletionRequest(
        model="m", messages=[{"role": "user", "content": "x"}],
        logit_bias={"42": -100, "7": 2.5}, presence_penalty=0.5)
    pre = OpenAIPreprocessor(ModelDeploymentCard(name="m"))
    got = pre.preprocess_chat(req)[0]
    assert got.sampling.logit_bias == {42: -100.0, 7: 2.5}
    assert got.sampling.presence_penalty == 0.5


# ------------------------------------------------------ tensor parallel

TP_WORKER = '''
import asyncio, json, os, sys
import numpy as np
import torch
from dynamo_tpu_torch.parallel.mesh import (MeshSpec, initialize_multihost,
                                            leave_process_groups)
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols.common import (
    OutputOptions, PreprocessedRequest, SamplingOptions, StopConditions)
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.engine import Context

rank, size, store, data = int(sys.argv[1]), 2, sys.argv[2], sys.argv[3]
initialize_multihost("file://" + store, size, rank)
mesh = MeshSpec(model=size).build("cpu")
spec = json.load(open(os.path.join(data, "jobs.json")))
npz = np.load(os.path.join(data, "params.npz"))
cfg = ModelConfig.tiny()
params = params_from_numpy({k: npz[k] for k in npz.files}, cfg,
                           device="cpu", rank=rank, size=size)
engine = TorchEngine(cfg, EngineConfig(**spec["ecfg"]), params=params,
                     mesh=mesh)
engine.warmup()
out = {}

async def run():
    async def one(p, lp, kw, n, delay):
        await asyncio.sleep(delay)
        req = PreprocessedRequest(
            token_ids=list(p), sampling=SamplingOptions(**kw),
            stop=StopConditions(max_tokens=n, ignore_eos=True),
            output=OutputOptions(logprobs=lp))
        toks, lps = [], []
        async for o in engine.generate(req, Context()):
            toks += o.token_ids
            lps += o.logprobs or []
        return toks, lps
    try:
        return await asyncio.gather(*[
            one(*job, 0.01 * i) for i, job in enumerate(spec["jobs"])])
    finally:
        await engine.stop()

if rank == 0:
    out["served"] = asyncio.run(run())
else:
    engine.follow()
out["compiles"] = engine.fence.post_warmup_compiles
out["variants"] = sorted(map(list, engine.decode_variants))
np.savez(os.path.join(data, f"carry{rank}.npz"), **{
    f"{v}_{B}x{P}_{i}": c.numpy()
    for v, gs in engine.decode_variants.items()
    for (B, P), bk in gs.buckets.items() if bk.carry is not None
    for i, c in enumerate(bk.carry)})
leave_process_groups(mesh)
print("RESULT " + json.dumps(out), flush=True)
'''


def test_two_rank_engine_serves_penalties_and_logprobs(tmp_path):
    """At model=2 over two gloo processes, rank 0 announces each
    dispatch's variant, sampler rows, penalty parameters, logit_bias
    entries and token ids; the follower replays the same variant with
    the same state, so the ranks' carries of every variant agree, and rank 0
    serves the tp=1 engine's tokens and logprobs (penalised, biased,
    logprobs and plain rows in one batch)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jcfg, tcfg = JaxModelConfig.tiny(), ModelConfig.tiny()
    np_params = {k: np.asarray(v) for k, v in
                 jax_init_params(jcfg, jax.random.PRNGKey(0)).items()}
    np.savez(tmp_path / "params.npz", **np_params)
    ecfg = {**ECFG, "max_top_logprobs": 3}
    jobs = [(LOOP_PROMPT, None, {"repetition_penalty": 3.0}, 10),
            ([1, 2, 3], 2, {"logit_bias": {7: 4.0}}, 7),
            ([9, 8, 7, 6], 3, {}, 9),
            ([4, 4, 4], None, {"frequency_penalty": 0.8}, 6)]
    (tmp_path / "jobs.json").write_text(json.dumps(
        {"ecfg": ecfg, "jobs": jobs}))
    script = tmp_path / "tp_worker.py"
    script.write_text(TP_WORKER)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=repo, OMP_NUM_THREADS="1")
    logs = [tmp_path / f"rank{r}.log" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(tmp_path / "store"),
         str(tmp_path)], env=env, cwd=repo, stdout=open(logs[r], "w"),
        stderr=subprocess.STDOUT) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    ranks = []
    for p, log in zip(procs, logs):
        text = log.read_text()
        assert p.returncode == 0, text[-4000:]
        ranks.append(json.loads([ln for ln in text.splitlines()
                                 if ln.startswith("RESULT ")][-1][7:]))
    teng = TorchEngine(tcfg, EngineConfig(**ecfg),
                       params=params_from_numpy(np_params, tcfg,
                                                device="cpu"),
                       device="cpu")
    teng.warmup()

    async def tp1():
        async def one(p, lp, kw, n, delay):
            await asyncio.sleep(delay)
            req = PreprocessedRequest(
                token_ids=list(p), sampling=SamplingOptions(**kw),
                stop=StopConditions(max_tokens=n, ignore_eos=True),
                output=OutputOptions(logprobs=lp))
            toks, lps = [], []
            async for o in teng.generate(req, Context()):
                toks += o.token_ids
                lps += o.logprobs or []
            return toks, lps
        try:
            return await asyncio.gather(*[
                one(*job, 0.01 * i) for i, job in enumerate(jobs)])
        finally:
            await teng.stop()

    want = asyncio.run(tp1())
    for (toks, lps), (wtoks, wlps) in zip(ranks[0]["served"], want):
        assert toks == wtoks
        np.testing.assert_allclose(lps, wlps, atol=1e-4)
    assert [len(t) for t, _ in want] == [10, 7, 9, 6]
    assert ranks[0]["variants"] == ranks[1]["variants"]
    assert [3, PEN_FULL] in ranks[0]["variants"] or \
        [0, PEN_FULL] in ranks[0]["variants"]
    assert ranks[0]["compiles"] == ranks[1]["compiles"]
    c0, c1 = (np.load(tmp_path / f"carry{r}.npz") for r in range(2))
    assert c0.files and sorted(c0.files) == sorted(c1.files)
    for k in c0.files:
        np.testing.assert_array_equal(c0[k], c1[k], err_msg=k)
