"""The port's sampled dispatch profiler (engine/profiler.py) and latency
recorder in the engine, against the JAX engine's (after
tests/test_profiling.py), on the CPU at ModelConfig.tiny():

- at the default sample rate (0) the dispatch path makes no host read of
  a tensor value and never drains the device, and ``stats()`` holds an
  empty ``bucket_cost``;
- at sample=1 every dispatch kind fills the cost table, under the same
  bucket labels as ``JaxEngine`` for the same requests;
- greedy tokens stay identical to ``JaxEngine``'s with the profiler on
  and off, and the latency histograms count what the JAX engine's count.
"""

import asyncio

import numpy as np
import pytest

from dynamo_tpu.engine.jax_engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.jax_engine import JaxEngine
from dynamo_tpu.llm.protocols.common import (PreprocessedRequest as
                                             JaxRequest)
from dynamo_tpu.llm.protocols.common import SamplingOptions as JaxSampling
from dynamo_tpu.llm.protocols.common import StopConditions as JaxStop
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                   SamplingOptions,
                                                   StopConditions)
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.engine import Context
from torch_sync_guard import NoHostReads

# tests/test_profiling.py's tiny engine
ECFG = dict(page_size=8, num_pages=64, max_batch=4, prefill_chunk=32,
            batch_buckets=(1, 2, 4), prefill_buckets=(16, 32),
            page_buckets=(8,), max_prefill_batch=2, decode_steps=2)
PROMPTS = [(list(range(1, 20)), 6), ([7] * 24, 5), (list(range(40, 45)), 4)]


def _engines(prof_sample: int):
    """(JaxEngine, TorchEngine), the same weights, both warmed up."""
    jeng = JaxEngine(JaxModelConfig.tiny(),
                     JaxEngineConfig(**ECFG, prof_sample=prof_sample),
                     seed=0)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 jeng.params.items()}, ModelConfig.tiny(),
                                device="cpu")
    teng = TorchEngine(ModelConfig.tiny(),
                       EngineConfig(**ECFG, prof_sample=prof_sample),
                       params=tparams, device="cpu")
    jeng.warmup()
    teng.warmup()
    return jeng, teng


async def _drive(engine, jax_side: bool):
    req_cls, samp_cls, stop_cls, ctx_cls = (
        (JaxRequest, JaxSampling, JaxStop, JaxContext) if jax_side else
        (PreprocessedRequest, SamplingOptions, StopConditions, Context))

    async def one(tokens, mt):
        req = req_cls(token_ids=list(tokens), sampling=samp_cls(),
                      stop=stop_cls(max_tokens=mt, ignore_eos=True),
                      eos_token_ids=[])
        toks = []
        async for out in engine.generate(req, ctx_cls()):
            toks.extend(out.token_ids)
            assert out.finish_reason != "error"
        return toks

    try:
        return await asyncio.gather(*(one(p, mt) for p, mt in PROMPTS))
    finally:
        await engine.stop()


def _run_both(prof_sample: int):
    jeng, teng = _engines(prof_sample)
    want = asyncio.run(_drive(jeng, True))
    got = asyncio.run(_drive(teng, False))
    jeng.fence.disarm()
    return jeng, teng, want, got


def test_sample_zero_dispatch_path_makes_no_host_read():
    """prof_sample=0 (the default): admission and both dispatches run
    under a mode that fails any host read of a tensor value, the
    profiler never drains the device, and it records nothing."""
    _, teng = _engines(0)
    assert EngineConfig().prof_sample == 0 and teng.profiler.sample == 0

    def guarded(fn):
        def run(*args):
            with NoHostReads():
                return fn(*args)
        return run

    for name in ("_admit", "_dispatch_prefill", "_dispatch_decode_window"):
        setattr(teng, name, guarded(getattr(teng, name)))

    def drain():
        raise AssertionError("the profiler drained the device at sample=0")

    teng.profiler._drain = drain
    toks = asyncio.run(_drive(teng, False))
    assert [len(t) for t in toks] == [mt for _, mt in PROMPTS]
    st = teng.stats()
    assert st["bucket_cost"] == {} and st["profiled_steps_total"] == 0
    assert st["device_time_fraction"] == 0.0
    assert st["post_warmup_compiles_total"] == 0


def test_sampled_bucket_labels_match_jax_engine():
    """prof_sample=1: the cost table fills for admission, prefill chunks,
    windows and their host bookkeeping, under JaxEngine's labels for the
    same requests, and stats() exports it under the JAX keys."""
    jeng, teng, want, got = _run_both(1)
    assert got == want
    table = teng.profiler.cost_table()
    assert set(table) == set(jeng.profiler.cost_table())
    assert {k.split(":")[0] for k in table} == {
        "admit", "prefill", "decode_window", "process_window"}
    for row in table.values():
        assert row["samples"] >= 1 and row["device_us"] >= 0.0
    st = teng.stats()
    assert st["bucket_cost"] == table
    assert st["profiled_steps_total"] == teng.profiler.profiled_steps > 0
    assert 0.0 < st["device_time_fraction"] <= 1.0
    assert teng.fence.post_warmup_compiles == 0


@pytest.mark.parametrize("prof_sample", [0, 1])
def test_greedy_tokens_and_latency_counts_match_jax_engine(prof_sample):
    """Greedy tokens are JaxEngine's with the profiler off and on; the
    latency histograms hold as many observations of each metric as the
    JAX engine's (queue wait, TTFT and e2e once per request, ITL once per
    later token), and the memory snapshots agree."""
    jeng, teng, want, got = _run_both(prof_sample)
    assert got == want
    ours = teng.stats()["latency_hist"]["unified"]
    theirs = jeng.stats()["latency_hist"]["unified"]
    assert set(ours) == set(theirs) == {"queue_wait", "ttft", "itl", "e2e"}
    for metric in ours:
        assert ours[metric]["count"] == theirs[metric]["count"]
        assert ours[metric]["ubs"] == theirs[metric]["ubs"]
    assert ours["ttft"]["count"] == len(PROMPTS)
    assert ours["itl"]["count"] == sum(mt - 1 for _, mt in PROMPTS)
    assert teng.stats()["memory"] == jeng.stats()["memory"]
