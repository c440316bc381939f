"""The engine's last parity gaps against the JAX engine, on the CPU at
ModelConfig.tiny() in float32 with the same (bridged) weights:

- ``EngineConfig.coalesce_window_emissions``: with True (the default) a
  window's row is one EngineOutput of up to K tokens, the device's
  emitted count; with False every token is its own EngineOutput, its
  stop checked on the host (``jax_engine.py _process_window``). In both
  settings the greedy tokens, finish reasons and the sequence of
  EngineOutput token counts equal JaxEngine's at the same setting, for
  requests one at a time (one with a stop id met mid-window) and the
  same tokens for requests sent together;
- ``stats()["gpu_prefix_cache_hit_rate"]``: the hit tokens over the
  prompt tokens of the last ``DYN_CACHE_WINDOW`` admissions, equal to
  JaxEngine's over the same admissions with a window of 3, a remote
  prefill's admission (``submit_prefilled``) counted with no hits;
- ``worker_label`` (a constructor argument) round-trips through
  ``stats()`` and the router's ForwardPassMetrics;
- the keys of JaxEngine's ``stats()`` that the port's lacks are exactly
  the ring prefill's (ROADMAP queue 1 item 11); the port has no key the
  reference lacks, and its loop-lag pair (item 12) are floats;
- with a host KV tier, the tier's ``stats()`` keys, ``cache_snapshot()``'s
  ``host_tier`` section and the ``memory`` host section equal
  JaxEngine's after the same traffic, which offloads and restores.
"""

import asyncio

import jax
import numpy as np
import pytest

from dynamo_tpu.engine.jax_engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.jax_engine import JaxEngine
from dynamo_tpu.llm.protocols.common import (PreprocessedRequest as
                                             JaxRequest,
                                             StopConditions as JaxStop)
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics
from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                   StopConditions)
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.engine import Context

ECFG = dict(page_size=8, num_pages=64, max_batch=4, prefill_chunk=16,
            prefill_buckets=(16,), batch_buckets=(1, 2, 4), page_buckets=(8,),
            decode_steps=4)
PROMPTS = [list(range(1, 6)), list(range(30, 70)), list(range(100, 117)),
           [7, 7, 7]]
MAX_TOKENS = (9, 12, 10, 5)
JAX = (JaxRequest, JaxStop, JaxContext)
PORT = (PreprocessedRequest, StopConditions, Context)
# the stats() keys the port still lacks: the ring prefill's (item 11)
NOT_YET = {"long_prefills_total"}


def _engines(**ecfg):
    """(JaxEngine, TorchEngine) with the same config and weights."""
    jcfg, tcfg = JaxModelConfig.tiny(), ModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 jparams.items()}, tcfg, device="cpu")
    kw = {**ECFG, **ecfg}
    return (JaxEngine(jcfg, JaxEngineConfig(**kw), params=jparams),
            TorchEngine(tcfg, EngineConfig(**kw), params=tparams,
                        device="cpu"))


async def _one(engine, kinds, prompt, max_tokens, stop_ids=()):
    """One request: its tokens, the token count of each EngineOutput and
    its finish reason."""
    req_cls, stop_cls, ctx_cls = kinds
    req = req_cls(token_ids=list(prompt),
                  stop=stop_cls(max_tokens=max_tokens,
                                stop_token_ids=list(stop_ids) or None))
    toks, counts, finish = [], [], None
    async for out in engine.generate(req, ctx_cls()):
        toks += out.token_ids
        counts.append(len(out.token_ids))
        finish = out.finish_reason or finish
    return toks, counts, finish


async def _serve(engine, kinds, stop_at: int):
    """Each prompt alone, then the first prompt again with a stop id: the
    token it generated at ``stop_at`` the first time; then every prompt
    at once (tokens only)."""
    try:
        alone = [await _one(engine, kinds, p, n)
                 for p, n in zip(PROMPTS, MAX_TOKENS)]
        stop = alone[0][0][stop_at]
        alone.append(await _one(engine, kinds, PROMPTS[0], MAX_TOKENS[0],
                                [stop]))
        together = await asyncio.gather(*(
            _one(engine, kinds, p, n) for p, n in zip(PROMPTS, MAX_TOKENS)))
        return alone, [t for t, _, _ in together]
    finally:
        await engine.stop()


@pytest.mark.parametrize("coalesce", [True, False],
                         ids=["coalesced", "token_by_token"])
def test_window_emissions_match_jax_engine(coalesce):
    """Greedy tokens, finish reasons and every request's sequence of
    EngineOutput token counts equal JaxEngine's at the same
    ``coalesce_window_emissions``; coalesced windows emit rows of up to
    K tokens, token by token every output carries one token at most; the
    stop id met mid-window ends both engines' request on the same token
    with finish reason "eos"; both settings give the same tokens."""
    jeng, teng = _engines(coalesce_window_emissions=coalesce)
    want = asyncio.run(_serve(jeng, JAX, 6))
    got = asyncio.run(_serve(teng, PORT, 6))
    assert got == want
    alone, together = got
    assert [t for t, _, _ in alone[:4]] == together
    assert [len(t) for t in together] == list(MAX_TOKENS)
    assert alone[4][2] == "eos" and len(alone[4][0]) < MAX_TOKENS[0]
    widest = max(max(c) for _, c, _ in alone)
    assert widest == (ECFG["decode_steps"] if coalesce else 1)
    other = asyncio.run(_serve(_engines(
        coalesce_window_emissions=not coalesce)[1], PORT, 6))
    assert [[t for t, _, _ in other[0]], other[1]] == [
        [t for t, _, _ in alone], together]
    assert teng.pm.active == 0


def test_windowed_prefix_hit_rate_matches_jax_engine(monkeypatch):
    """With ``DYN_CACHE_WINDOW=3``: after each of six admissions that
    share prefixes (full pages hit, partial pages miss) the port's
    ``gpu_prefix_cache_hit_rate`` equals JaxEngine's and the window holds
    the last three admissions; a remote prefill's admission
    (``reserve_remote`` then ``submit_prefilled``) enters the window with
    no hits in both engines; the lifetime rate is the totals' ratio."""
    monkeypatch.setenv("DYN_CACHE_WINDOW", "3")
    base = list(range(40, 80))
    prompts = [base, base + [1, 2], list(range(200, 230)), base[:20],
               base + [9], list(range(200, 230)) + [5]]

    async def run(engine, kinds):
        rates = []
        try:
            for p in prompts:
                await _one(engine, kinds, p, 3)
                st = engine.stats()
                rates.append((st["gpu_prefix_cache_hit_rate"],
                              list(engine._hit_window)))
            res = await engine.reserve_remote(list(range(300, 320)))
            seq = await engine.submit_prefilled(
                kinds[0](token_ids=list(range(300, 320)),
                         stop=kinds[1](max_tokens=2)),
                kinds[2](), res.pages, 5)
            while not (await seq.out.get()).finish_reason:
                pass
            st = engine.stats()
            rates.append((st["gpu_prefix_cache_hit_rate"],
                          list(engine._hit_window)))
            return rates, st
        finally:
            await engine.stop()

    jeng, teng = _engines()
    want, jst = asyncio.run(run(jeng, JAX))
    got, tst = asyncio.run(run(teng, PORT))
    assert got == want
    assert all(len(w) == min(i + 1, 3) for i, (_, w) in enumerate(got))
    assert got[-1][1][-1] == (0, 20)
    assert any(r > 0 for r, _ in got) and any(r == 0 for r, _ in got)
    assert tst["gpu_prefix_cache_hit_rate_lifetime"] == pytest.approx(
        tst["prefix_hit_tokens_total"] / tst["prompt_tokens_total"])
    for k in ("prefix_hit_tokens_total", "prompt_tokens_total"):
        assert tst[k] == jst[k], k


def test_worker_label_round_trips():
    """``worker_label`` rides ``stats()`` (and ForwardPassMetrics built
    from it) as JaxEngine's does; unset it is "" in both."""
    jeng, teng = _engines()
    assert teng.stats()["worker_label"] == jeng.stats()["worker_label"] == ""
    labelled = TorchEngine(ModelConfig.tiny(), EngineConfig(**ECFG),
                           device="cpu", worker_label="r1")
    st = labelled.stats()
    assert st["worker_label"] == "r1"
    fpm = ForwardPassMetrics.from_dict(st)
    assert fpm.worker_label == "r1"
    assert fpm.gpu_prefix_cache_hit_rate == st["gpu_prefix_cache_hit_rate"]


def test_stats_keys_lack_only_the_unported_items():
    """JaxEngine's stats() keys less the port's are exactly NOT_YET (the
    list can only shrink as item 11 lands), and the port's are all
    JaxEngine's; the loop-lag pair is there, as floats."""
    jeng, teng = _engines()
    jst, tst = jeng.stats(), teng.stats()
    jkeys, tkeys = set(jst), set(tst)
    assert jkeys - tkeys == NOT_YET
    assert tkeys <= jkeys
    for key in ("loop_lag_p50_seconds", "loop_lag_p99_seconds"):
        assert isinstance(tst[key], float) and isinstance(jst[key], float)


def test_host_tier_stats_and_cache_view_match_jax_engine():
    """A lossless host tier under a 15-page pool: one prompt, three
    others that evict it, the prompt again (a host hit). The tier's
    stats() keys, the cache view's host_tier section and the memory
    host section equal JaxEngine's, and the tier moved pages both
    ways."""
    keys = ("host_free_blocks", "host_cache_usage_perc",
            "host_offload_pages_total", "host_restore_pages_total",
            "prefix_hit_tokens_total", "kv_free_blocks", "kv_cached_blocks")
    prompts = [list(range(40, 80))] + [list(range(100 * i, 100 * i + 40))
                                       for i in (2, 3, 4)]
    prompts.append(prompts[0])

    async def run(engine, kinds):
        try:
            for p in prompts:
                await _one(engine, kinds, p, 3)
        finally:
            await engine.stop()
        st = engine.stats()
        return ({k: st[k] for k in keys}, engine.cache_snapshot()["host_tier"],
                st["memory"]["host"])

    jeng, teng = _engines(num_pages=16, watermark_pages=2, host_pages=32,
                          host_tier_int8=False)
    want = asyncio.run(run(jeng, JAX))
    got = asyncio.run(run(teng, PORT))
    assert got == want
    assert got[0]["host_offload_pages_total"] > 0
    assert got[0]["host_restore_pages_total"] > 0
