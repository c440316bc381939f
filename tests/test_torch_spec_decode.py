"""Self-speculative decoding in the port against the JAX package's, on
the CPU at ModelConfig.tiny() in float32 with the same (bridged) weights:

- the drafter (``engine/spec_decode.py propose_ngram_draft``) against
  the JAX package's on seeded histories, and ``verify_greedy_draft``
  against the JAX one on seeded logits with ties;
- the verify forward (``models/llama.py make_verify_fn``) against the
  JAX one, every position's logits (atol 1e-5), from rows that start
  mid-page;
- greedy tokens with ``spec_decode`` on: equal to JaxEngine with it on,
  and to the port with it off, with windows and with single steps for
  the bypass rows; drafts accepted;
- sampled, penalised, ``logit_bias`` and logprobs rows bypass
  speculation, alone and in batches with greedy rows, and give the
  tokens they give with it off;
- pages after partial acceptance (every page back, every page of a
  finished row's prefix committed as it is with speculation off) and
  ``max_tokens`` near the budget (a draft never runs past it);
- speculation off leaves the warmed graph set as it was; on, warmup adds
  the verify grid, and serving captures nothing;
- two gloo ranks (model=2) serving the single-step and the spec arms
  give one rank's tokens.
"""

import asyncio
import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.jax_engine import JaxEngine
from dynamo_tpu.engine.sampling import (verify_greedy_draft as
                                        jax_verify_greedy_draft)
from dynamo_tpu.engine.spec_decode import (propose_ngram_draft as
                                           jax_propose_ngram_draft)
from dynamo_tpu.llm.protocols.common import (OutputOptions as JaxOutput,
                                             PreprocessedRequest as
                                             JaxRequest,
                                             SamplingOptions as JaxSampling,
                                             StopConditions as JaxStop)
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.sampling import verify_greedy_draft
from dynamo_tpu_torch.engine.spec_decode import propose_ngram_draft
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols.common import (OutputOptions,
                                                   PreprocessedRequest,
                                                   SamplingOptions,
                                                   StopConditions)
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.engine import Context

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_engine.py's grid
ECFG = dict(page_size=8, num_pages=64, max_batch=4, prefill_chunk=16,
            prefill_buckets=(16,), batch_buckets=(1, 2, 4), page_buckets=(8,),
            decode_steps=4)
# greedy prompts whose continuations the tiny seed-3 model repeats (so
# drafts are found and accepted), a prompt that repeats a passage, and
# one without repeats
PROMPTS = [[7, 7, 7], list(range(30, 40)) * 3, [5, 9, 5, 9, 5, 9, 5],
           list(range(100, 117))]
MAX_TOKENS = [20, 18, 16, 12]

JAX = (JaxRequest, JaxStop, JaxContext, JaxSampling, JaxOutput)
PORT = (PreprocessedRequest, StopConditions, Context, SamplingOptions,
        OutputOptions)


def _weights():
    jcfg, tcfg = JaxModelConfig.tiny(), ModelConfig.tiny()
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(3))
    nparams = {k: np.asarray(v) for k, v in jparams.items()}
    return jcfg, tcfg, jparams, params_from_numpy(nparams, tcfg,
                                                  device="cpu"), nparams


def _engines(**ecfg):
    jcfg, tcfg, jparams, tparams, _ = _weights()
    kw = {**ECFG, **ecfg}
    return (JaxEngine(jcfg, JaxEngineConfig(**kw), params=jparams),
            TorchEngine(tcfg, EngineConfig(**kw), params=tparams,
                        device="cpu"))


async def _generate_all(engine, kinds, prompts=PROMPTS, max_tokens=MAX_TOKENS,
                        sampling=None, logprobs=None):
    req_cls, stop_cls, ctx_cls, samp_cls, out_cls = kinds

    async def one(i):
        req = req_cls(token_ids=list(prompts[i]),
                      stop=stop_cls(max_tokens=max_tokens[i]))
        if sampling and sampling[i]:
            req.sampling = samp_cls(**sampling[i])
        if logprobs and logprobs[i]:
            req.output = out_cls(logprobs=logprobs[i])
        toks, fin = [], None
        async for out in engine.generate(req, ctx_cls()):
            toks += out.token_ids
            fin = out.finish_reason or fin
        return toks, fin

    try:
        return await asyncio.gather(*[one(i) for i in range(len(prompts))])
    finally:
        await engine.stop()


def _port(engine, **kw):
    return asyncio.run(_generate_all(engine, PORT, **kw))


# --------------------------------------------------------- drafter, mask


def test_drafter_matches_jax_on_seeded_histories():
    """propose_ngram_draft against the JAX package's on 400 seeded
    histories (small alphabets, so n-grams recur; periodic tails), every
    draft length and n-gram range."""
    rng = np.random.RandomState(0)
    for trial in range(400):
        L = int(rng.randint(0, 40))
        hist = list(rng.randint(0, int(rng.choice([2, 3, 5, 50])), L))
        if trial % 4 == 0 and L:
            hist = (hist[:5] * 10)[:L]
        for k, nmax, nmin in ((4, 4, 1), (1, 3, 2), (8, 2, 1), (0, 4, 1)):
            assert propose_ngram_draft(hist, k, nmax, nmin) == \
                jax_propose_ngram_draft(hist, k, nmax, nmin), (hist, k)


@pytest.mark.parametrize("K", [1, 4])
def test_verify_greedy_draft_matches_jax(K):
    """The accept mask and bonus token against the JAX package's on
    seeded logits whose rows hold ties (several positions of the maximum:
    both take the first), drafts that match a prefix of the greedy
    targets, all of them or none, and short or empty drafts."""
    rng = np.random.RandomState(K)
    B, V = 12, 37
    logits = rng.randint(0, 6, (B, K + 1, V)).astype(np.float32)
    greedy = logits.argmax(-1)
    draft = rng.randint(0, V, (B, K)).astype(np.int32)
    for b in range(B):
        keep = b % (K + 1)
        draft[b, :keep] = greedy[b, :keep]
    draft_len = (np.arange(B) % (K + 1)).astype(np.int32)
    draft_len[0] = K
    draft[0] = greedy[0, :K]
    want = jax_verify_greedy_draft(jnp.asarray(logits), jnp.asarray(draft),
                                   jnp.asarray(draft_len), max_top_k=8)
    got = verify_greedy_draft(torch.from_numpy(logits),
                              torch.from_numpy(draft),
                              torch.from_numpy(draft_len))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1][0]) == K


def test_verify_forward_matches_jax_from_mid_page():
    """make_verify_fn's [B, K+1] forward against the JAX one on the same
    pools, rows starting mid-page, at a page's last slot and at 0, and a
    padding row: every position's logits, and the K/V scattered through
    flat slots, within 1e-5."""
    jcfg, tcfg, jparams, tparams, _ = _weights()
    ps, N, K = 8, 24, 4
    rng = np.random.RandomState(1)
    spec = jl.KVCacheSpec(N, ps)
    kk = rng.randn(*spec.shape(jcfg)).astype(np.float32)
    vv = rng.randn(*spec.shape(jcfg)).astype(np.float32)
    starts = [13, 7, 0, -1]
    B, P = len(starts), 4
    table = np.zeros((B, P), np.int32)
    tokens = rng.randint(0, 256, (B, K + 1)).astype(np.int32)
    pos = np.full((B, K + 1), -1, np.int32)
    slots = np.full((B, K + 1), tl.DROP_SLOT, np.int32)
    for b, st in enumerate(starts):
        table[b] = np.arange(1 + P * b, 1 + P * (b + 1))
        if st >= 0:
            pos[b] = np.arange(st, st + K + 1)
            slots[b] = table[b, pos[b] // ps] * ps + pos[b] % ps
    want, jk, jv = jl.make_verify_fn(jcfg)(
        jparams, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(kk),
        jnp.asarray(vv), jnp.asarray(table), jnp.asarray(slots))
    tk, tv = torch.from_numpy(kk.copy()), torch.from_numpy(vv.copy())
    got, tk, tv = tl.make_verify_fn(tcfg)(
        tparams, *(torch.from_numpy(a) for a in (tokens, pos)), tk, tv,
        torch.from_numpy(table), torch.from_numpy(slots))
    assert got.shape == (B, K + 1, tcfg.vocab_size)
    np.testing.assert_allclose(got[:3].numpy(), np.asarray(want)[:3],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                               rtol=0)


# ------------------------------------------------------------- engines


@pytest.mark.parametrize("steps", [4, 1], ids=["windows", "single_step"])
def test_spec_tokens_match_jax_engine_and_spec_off(steps):
    """Greedy tokens with spec_decode on (bypass rows on windows, or on
    single steps) equal JaxEngine's with it on and the port's with it
    off; drafts were verified and some accepted; every page returned."""
    jeng, teng = _engines(spec_decode=True, decode_steps=steps)
    want = asyncio.run(_generate_all(jeng, JAX))
    got = _port(teng)
    assert got == want
    assert [len(t) for t, _ in got] == MAX_TOKENS
    _, off = _engines(decode_steps=steps)
    assert _port(off) == got
    st = teng.stats()
    assert st["spec_decode_steps"] == jeng.spec_steps > 0
    assert (st["spec_decode_accepted_tokens_total"]
            == jeng.spec_accepted_tokens_total > 0)
    assert st["spec_decode_draft_tokens_total"] >= \
        st["spec_decode_accepted_tokens_total"]
    assert 0 < st["spec_decode_acceptance_rate"] <= 1
    assert teng.verify_graphs.buckets
    assert teng.pm.active == 0


BYPASS = {"sampled": dict(temperature=0.9, top_p=0.9, seed=5),
          "penalised": dict(repetition_penalty=1.2),
          "logit_bias": dict(logit_bias={7: 2.5})}


@pytest.mark.parametrize("kind", list(BYPASS) + ["logprobs"])
def test_bypass_rows_alone_and_mixed(kind):
    """A sampled, penalised, logit_bias or logprobs request never takes a
    verify step (alone: no verify at all), and gives the tokens it gives
    with speculation off; beside greedy rows, the greedy rows still
    speculate and every row's tokens equal speculation off's."""
    samp = None if kind == "logprobs" else BYPASS[kind]
    lps = 3 if kind == "logprobs" else None
    for n in (1, 4):  # alone, then with three greedy rows
        sampling = [samp] + [None] * (n - 1)
        logprobs = [lps] + [None] * (n - 1)
        kw = dict(prompts=PROMPTS[:n], max_tokens=MAX_TOKENS[:n],
                  sampling=sampling, logprobs=logprobs)
        _, on = _engines(spec_decode=True)
        verified = []
        real = on._decode_step_spec

        def spy(batch, drafts):
            verified.extend(s.req.token_ids for s in batch)
            return real(batch, drafts)
        on._decode_step_spec = spy
        got = _port(on, **kw)
        _, off = _engines()
        assert got == _port(off, **kw), n
        assert PROMPTS[0] not in verified
        if n == 1:
            assert on.stats()["spec_decode_steps"] == 0
        else:
            assert on.stats()["spec_decode_steps"] > 0


def test_pages_after_partial_acceptance_and_max_tokens_near_budget():
    """Rows with budgets of 1 to 6 tokens (drafts clamped to budget - 1,
    so a full accept and its bonus land exactly on it) and a pool of 24
    pages: every row ends at its max_tokens, partial acceptances leave
    no page behind, and the prefix cache holds what it holds with
    speculation off (the same pages committed)."""
    prompts = [[7, 7, 7], list(range(30, 40)) * 3, [5, 9] * 6, [7, 7, 7]]
    for budgets in ((1, 2, 3, 6), (5, 4, 6, 2)):
        kw = dict(prompts=prompts, max_tokens=list(budgets))
        _, on = _engines(spec_decode=True, num_pages=24)
        got = _port(on, **kw)
        _, off = _engines(num_pages=24)
        assert got == _port(off, **kw)
        assert [len(t) for t, _ in got] == list(budgets)
        assert on.pm.active == off.pm.active == 0
        assert len(on.pm.free) + len(on.pm.reusable) == 23
        assert sorted(on.pm.reusable) == sorted(off.pm.reusable)


def test_spec_off_keeps_the_warmed_set_and_on_adds_the_verify_grid():
    """With speculation off warmup captures what it captured before this
    arm existed (windows and chunks in the plain and logprobs variants,
    no verify, no single step); on, it adds one verify graph per decode
    bucket, and serving captures nothing."""
    _, off = _engines()
    n_off = off.warmup()
    grid = EngineConfig(**ECFG).warmed_grid()
    decode = len(grid["decode_batches"]) * len(grid["page_buckets"])
    prefill = (len(grid["prefill_batches"]) * len(grid["prefill_lens"])
               * len(grid["page_buckets"]))
    assert n_off == 2 * decode + 2 * prefill
    assert off.verify_graphs is None and not off.step_variants
    assert set(off.graph_replays()) >= {"decode_window", "prefill"}
    _, on = _engines(spec_decode=True)
    assert on.warmup() == n_off + decode
    assert len(on.verify_graphs.buckets) == decode
    _port(on)
    assert on.stats()["post_warmup_compiles_total"] == 0
    assert on.stats()["spec_decode_steps"] > 0


# --------------------------------------------------- two gloo ranks

WORKER = textwrap.dedent('''
    import asyncio, json, os, sys
    import numpy as np

    from dynamo_tpu_torch.parallel.mesh import (MeshSpec, initialize_multihost,
                                                leave_process_groups)

    rank, size, store, data = sys.argv[1:5]
    rank, size = int(rank), int(size)
    initialize_multihost("file://" + store, size, rank)
    mesh = MeshSpec(model=size).build("cpu") if size > 1 else None

    from dynamo_tpu_torch.engine.torch_engine import (EngineConfig,
                                                      TorchEngine)
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, StopConditions)
    from dynamo_tpu_torch.models.bridge import params_from_numpy
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.runtime.engine import Context

    cfg = ModelConfig.tiny()
    npz = np.load(os.path.join(data, "params.npz"))
    params = params_from_numpy({k: npz[k] for k in npz.files}, cfg,
                               device="cpu", rank=rank, size=size)
    spec = json.load(open(os.path.join(data, "engine.json")))
    out = {"rank": rank}
    for arm, ecfg in spec["arms"].items():
        engine = TorchEngine(cfg, EngineConfig(**ecfg), params=params,
                             mesh=mesh, device="cpu")
        engine.warmup()

        async def run():
            async def one(p, n):
                req = PreprocessedRequest(token_ids=list(p),
                                          stop=StopConditions(max_tokens=n))
                toks = []
                async for o in engine.generate(req, Context()):
                    toks += o.token_ids
                return toks
            try:
                return await asyncio.gather(*[
                    one(p, n) for p, n in zip(spec["prompts"],
                                              spec["max_tokens"])])
            finally:
                await engine.stop()

        if rank == 0:
            out[arm] = {"tokens": asyncio.run(run())}
        else:
            engine.follow()
            out[arm] = {}
        out[arm].update(
            dispatches=engine.batch_dispatches_total,
            compiles=engine.fence.post_warmup_compiles,
            spec_steps=engine.spec_steps,
            buckets={gs.kind: sorted(map(list, gs.buckets))
                     for gs in engine._graph_sets()})
    leave_process_groups(mesh)
    print("RESULT " + json.dumps(out), flush=True)
''')


def _spawn(tmp_path, size, timeout=400):
    script = tmp_path / "spec_worker.py"
    script.write_text(WORKER)
    store = tmp_path / f"store-{size}"
    logs = [tmp_path / f"rank{r}-of-{size}.log" for r in range(size)]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    try:
        for r in range(size):
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(r), str(size), str(store),
                 str(tmp_path)], env=env, cwd=REPO,
                stdout=open(logs[r], "w"), stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    results = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        text = log.read_text()
        assert p.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
        line = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        results.append(json.loads(line[-1][7:]))
    return results


def test_two_rank_single_step_and_spec_arms_give_one_ranks_tokens(tmp_path):
    """TorchEngine at model=2 over two gloo processes (rank 0 schedules
    and announces its single steps and verify steps, rank 1 replays
    them) serves the tokens of one rank on the same weights, on the
    single-step arm and on the spec arm (its bypass rows on single
    steps); both ranks made the same dispatches over the same buckets,
    and none captured after warmup."""
    _, _, _, _, nparams = _weights()
    np.savez(tmp_path / "params.npz", **nparams)
    arms = {"single_step": dict(ECFG, decode_steps=1),
            "spec": dict(ECFG, decode_steps=1, spec_decode=True)}
    (tmp_path / "engine.json").write_text(json.dumps(
        {"arms": arms, "prompts": PROMPTS, "max_tokens": MAX_TOKENS}))
    solo = _spawn(tmp_path, 1)[0]
    ranks = _spawn(tmp_path, 2)
    for arm in arms:
        assert ranks[0][arm]["tokens"] == solo[arm]["tokens"], arm
        assert [len(t) for t in solo[arm]["tokens"]] == MAX_TOKENS
        for key in ("dispatches", "buckets", "compiles"):
            assert ranks[0][arm][key] == ranks[1][arm][key], (arm, key)
        assert ranks[0][arm]["compiles"] == 0
        assert "decode step" in ranks[0][arm]["buckets"]
    assert ranks[0]["spec"]["spec_steps"] == solo["spec"]["spec_steps"] > 0
