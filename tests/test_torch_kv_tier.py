"""The host KV tier in the port (``engine/kv_tier.py``, the device forms
of ``engine/kv_compress.py`` and ``TorchEngine._drain_kv_tier``) against
the JAX package, on the CPU.

- The device ``quantize_pages`` / ``dequantize_pages`` are bitwise the
  JAX package's jitted forms on bfloat16, float16 and float32 pages from
  a numpy seed, and the round trip is within s/2 an element.
- The reference's engine scenarios (``tests/test_kv_offload.py``,
  ``test_kv_heat.py``, ``test_kv_compress.py``) on a ``JaxEngine`` and a
  ``TorchEngine`` with the same weights (``models/bridge.py``), float32:
  a prompt served, churned out of a small device pool by four others,
  served again. Greedy tokens, the offload, restore and prefix-hit
  totals, the page manager's tier counters and the ``cache.restore``
  step-timeline events equal JaxEngine's. In the port the restored
  pages are bitwise the pages before eviction on the lossless tier
  (chunked, serial and overlapped restores alike, and MLA's two pools),
  and on the int8 tier bitwise their quantize-dequantize round trip,
  within s/2 an element of the originals.
- The disaggregation plane drains the tier fully: a reservation that
  hits host pages, an extract after evictions and an inject return with
  nothing queued or in flight, with JaxEngine's totals and its extracted
  pages (atol 1e-5).
- ``host_tier_int8`` resolves as JaxEngine's; the int8 pools hold under
  0.6 of the lossless pools' bytes; a tier at tp=2 (two gloo ranks)
  raises ``NotImplementedError`` naming ROADMAP queue 1 item 11.
"""

import asyncio
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

from dynamo_tpu.engine import kv_compress as ref_compress
from dynamo_tpu.engine.jax_engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.jax_engine import JaxEngine
from dynamo_tpu.llm.protocols.common import (PreprocessedRequest as
                                             JaxRequest)
from dynamo_tpu.llm.protocols.common import StopConditions as JaxStop
from dynamo_tpu.models import mla as jax_mla
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import kv_compress
from dynamo_tpu_torch.engine.kv_manager import chain_hashes
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                   StopConditions)
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.engine import Context

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PS = 4
# the reference tier tests' engine: 23 usable device pages, 64 host ones
ECFG = dict(page_size=PS, num_pages=24, max_batch=4, prefill_chunk=32,
            prefill_buckets=(32,), batch_buckets=(4,), page_buckets=(16,),
            host_pages=64, watermark_pages=2)
JAX = (JaxRequest, JaxStop, JaxContext)
PORT = (PreprocessedRequest, StopConditions, Context)
MLA = dict(model_type="deepseek_v2", kv_lora_rank=16, qk_nope_head_dim=16,
           qk_rope_head_dim=8, v_head_dim=16, q_lora_rank=24)
# the int8 round trip's error bound, in scales: the grid's half step,
# plus the float32 roundings of a/s and q*s at |q| <= 127 (each at most
# 64 * 2**-24 of s)
HALF_STEP = 0.5 + 2 ** -17
# the page manager's tier counters held equal to JaxEngine's
TIER_COUNTERS = ("restores_drained_total", "restore_batches_total",
                 "restore_batch_pages_total", "evict_offloaded_total",
                 "evict_dropped_total", "host_evictions_total",
                 "host_restored_blocks_total", "device_hit_blocks_total")


# ---------------------------------------------------------- device forms


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_device_quantize_pages_bitwise_jax(dtype):
    """quantize_pages and dequantize_pages on CPU tensors are bitwise the
    jitted JAX forms (int8 rows, float32 scales, float32 round trip) on
    pages whose rows span 1e-30..30 in scale, a zero row included; the
    round trip is within HALF_STEP s of the pages."""
    rng = np.random.RandomState(11)
    a = (rng.randn(3, 5, 2, 8, 16)
         * rng.choice([1e-30, 1e-3, 1.0, 30.0], size=(3, 5, 2, 8, 1))
         ).astype(np.float32)
    a[0, 0, 0, 0] = 0.0
    ja = jnp.asarray(a).astype(dtype)
    pages = torch.from_numpy(np.array(ja.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jq, js = ref_compress.quantize_pages(ja)
    q, s = kv_compress.quantize_pages(pages)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == pages.shape[:-1] + (1,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = kv_compress.dequantize_pages(q, s)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref_compress.dequantize_pages(jq, js)))
    err = np.abs(back.numpy() - pages.to(torch.float32).numpy())
    assert np.all(err <= s.numpy() * HALF_STEP)


# ----------------------------------------------------- engine scenarios


def _configs(mla=False):
    kw = MLA if mla else {}
    return JaxModelConfig.tiny(**kw), ModelConfig.tiny(**kw)


def _engines(mla=False, **ecfg):
    """(JaxEngine, TorchEngine) with the same weights and config."""
    jcfg, tcfg = _configs(mla)
    init = jax_mla.init_params if mla else jax_init_params
    jparams = init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 jparams.items()}, tcfg, device="cpu")
    kw = {**ECFG, **ecfg}
    return (JaxEngine(jcfg, JaxEngineConfig(**kw), params=jparams),
            TorchEngine(tcfg, EngineConfig(**kw), params=tparams,
                        device="cpu"))


async def _gen(engine, kinds, prompt, n=8):
    req_cls, stop_cls, ctx_cls = kinds
    req = req_cls(token_ids=list(prompt),
                  stop=stop_cls(max_tokens=n, ignore_eos=True),
                  eos_token_ids=[])
    toks = []
    async for out in engine.generate(req, ctx_cls()):
        toks += out.token_ids
        if out.finish_reason:
            break
    return toks


def _pages_of(engine, prompt):
    """The device pages holding ``prompt``'s full blocks, by hash order
    (copies of both pools' pages; port engines only)."""
    out = []
    for h in chain_hashes(prompt, PS):
        p = engine.pm.by_hash.get(h)
        out.append(None if p is None else (engine.kv_k[:, p].clone(),
                                           engine.kv_v[:, p].clone()))
    return out


async def _churn(engine, kinds, seed=0, n_new=8):
    """Serve prompt A, churn it out of the pool with four others, serve A
    again. Returns (tokens, A's pages before eviction and after the
    restore (port only), the second admission's prefix-hit tokens)."""
    rng = np.random.RandomState(seed)
    a = rng.randint(1, 500, 24).tolist()
    port = isinstance(engine, TorchEngine)
    try:
        first = await _gen(engine, kinds, a, n_new)
        before = _pages_of(engine, a) if port else None
        for _ in range(4):
            await _gen(engine, kinds, rng.randint(1, 500, 24).tolist(), n_new)
        h0 = engine.prefix_hit_tokens_total
        again = await _gen(engine, kinds, a, n_new)
        after = _pages_of(engine, a) if port else None
    finally:
        await engine.stop()
    return (first, again), (before, after), engine.prefix_hit_tokens_total - h0


def _tier_record(engine):
    pm = engine.pm
    return {"offload": engine.offload_pages_total,
            "restore": engine.restore_pages_total,
            "prefix_hits": engine.prefix_hit_tokens_total,
            **{k: getattr(pm, k) for k in TIER_COUNTERS},
            "restores": [(e["pages"], e["queued"], e["staged"])
                         for e in engine.step_timeline.snapshot()
                         if e["kind"] == "cache.restore"]}


SCENARIOS = {
    # test_kv_offload.py:111, without and with the tier
    "no_tier": dict(host_pages=0),
    "lossless": dict(host_tier_int8=False),
    # :165, one page a drain
    "chunked": dict(host_tier_int8=False, tier_restore_chunk=1),
    # test_kv_heat.py:275, the serial control of the overlapped restore
    "serial": dict(host_tier_int8=False, restore_overlap=False),
    # test_kv_heat.py:195 + test_kv_compress.py:72: the default tier
    "int8": dict(),
    # test_kv_offload.py:286, the latent and rope pools
    "mla": dict(host_tier_int8=False),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tier_engine_matches_jax_engine(name, monkeypatch):
    """Tokens, totals, tier counters and cache.restore events equal
    JaxEngine's at the scenario's config; the second request is a prefix
    hit off the host tier (none without one); restored pages are bitwise
    the evicted ones (lossless) or their int8 round trip (int8, within
    s/2 an element, float32 pools)."""
    monkeypatch.delenv("DYN_HOST_TIER_FP16", raising=False)
    monkeypatch.delenv("DYN_RESTORE_OVERLAP", raising=False)
    monkeypatch.setenv("DYN_STEP_TIMELINE", "512")
    jeng, teng = _engines(mla=name == "mla", **SCENARIOS[name])
    assert teng.ecfg.host_tier_int8 == jeng.ecfg.host_tier_int8 == (
        name == "int8")
    assert teng.ecfg.restore_overlap == jeng.ecfg.restore_overlap
    want, _, jhits = asyncio.run(_churn(jeng, JAX))
    got, (before, after), thits = asyncio.run(_churn(teng, PORT))
    assert got == want and len(got[0]) == 8
    assert got[0] == got[1]
    assert thits == jhits
    assert _tier_record(teng) == _tier_record(jeng)
    if name == "no_tier":
        assert teng.tier is None and thits == 0
        assert teng.restore_pages_total == 0
        return
    assert thits > 0 and teng.restore_pages_total > 0
    assert teng.offload_pages_total > 0
    # the newest offload may stay in flight under the next step
    assert len(teng._offload_inflight) <= 1
    assert teng._restore_staged is None
    assert not teng._unrestored_pages
    staged = {s for _, _, s in _tier_record(teng)["restores"]}
    assert staged == {int(name != "serial")}
    if name == "chunked":
        assert len(_tier_record(teng)["restores"]) == teng.restore_pages_total
    if name == "mla":
        (hk, _), (hv, _) = teng.tier.pools
        assert hk.shape[2:] == teng.kv_k.shape[2:]
        assert hv.shape[2:] == teng.kv_v.shape[2:]
        assert hk.shape[-1] != hv.shape[-1]
    restored = thits // PS
    assert restored >= 5
    for old, new in zip(before[:restored], after[:restored]):
        for o, n in zip(old, new):
            if name != "int8":
                assert torch.equal(n, o)
                continue
            q, s = kv_compress.quantize_pages(o)
            assert torch.equal(n, kv_compress.dequantize_pages(q, s))
            assert torch.all((n - o).abs() <= s * HALF_STEP)


def test_int8_default_resolution_and_pool_bytes(monkeypatch):
    """host_tier_int8 resolves as JaxEngine's (on with a tier, off
    without, off under DYN_HOST_TIER_FP16=1, an explicit value wins);
    evict_policy and restore_overlap read their variables; the int8 host
    pools hold under 0.6 of the lossless pools' bytes; building and
    warming allocate the pools once and nothing after warmup."""
    cfg = ModelConfig.tiny()
    small = dict(page_size=4, num_pages=8, max_batch=2, prefill_chunk=16,
                 prefill_buckets=(16,), batch_buckets=(2,), page_buckets=(8,))

    def make(**kw):
        return TorchEngine(cfg, EngineConfig(**small, **kw), device="cpu")

    monkeypatch.delenv("DYN_HOST_TIER_FP16", raising=False)
    monkeypatch.delenv("DYN_EVICT_POLICY", raising=False)
    monkeypatch.delenv("DYN_RESTORE_OVERLAP", raising=False)
    e8 = make(host_pages=16)
    assert e8.ecfg.host_tier_int8 is True
    assert e8.ecfg.evict_policy == "cost" and e8.pm.evict_policy == "cost"
    assert e8.ecfg.restore_overlap is True
    assert make(host_pages=0).ecfg.host_tier_int8 is False
    monkeypatch.setenv("DYN_HOST_TIER_FP16", "1")
    monkeypatch.setenv("DYN_EVICT_POLICY", "lru")
    monkeypatch.setenv("DYN_RESTORE_OVERLAP", "0")
    e16 = make(host_pages=16)
    assert e16.ecfg.host_tier_int8 is False
    assert e16.pm.evict_policy == "lru"
    assert e16.ecfg.restore_overlap is False
    assert make(host_pages=16, host_tier_int8=True).ecfg.host_tier_int8
    (hk, hs), _ = e8.tier.pools
    assert hk.dtype == torch.int8 and hs.dtype == torch.float32
    assert hk.shape == (16, cfg.num_layers, *e8.kv_k.shape[2:])
    assert e8.tier.nbytes < e16.tier.nbytes * 0.6
    allocs = e8.tier.pinned_allocs
    e8.warmup()
    assert e8.tier.armed and e8.tier.pinned_allocs == allocs
    assert e8.tier.pinned_after_warmup == 0


# ---------------------------------------------------- disaggregation plane


def test_disagg_plane_drains_the_tier_fully(run_async):
    """Lossless tier, both engines the same operations: after a prompt
    churns out to the host tier, reserve_remote on it restores its pages
    before returning (the port's bitwise the evicted ones; the extract
    of them JaxEngine's within atol 1e-5, float32); prefill_only calls
    whose allocations evict pages, then an extract, and a reservation
    that evicts, then an inject, each return with no tier copy queued,
    staged or in flight; the totals equal JaxEngine's."""
    jeng, teng = _engines(host_tier_int8=False)
    rng = np.random.RandomState(4)
    a = rng.randint(1, 500, 24).tolist()
    others = [rng.randint(1, 500, 24).tolist() for _ in range(6)]

    def idle(engine):
        pm = engine.pm
        return (not pm.pending_offload and not pm.pending_restore
                and not engine._offload_inflight
                and engine._restore_staged is None
                and not engine._unrestored_pages)

    async def run(engine, kinds):
        req_cls, stop_cls, ctx_cls = kinds
        port = engine is teng
        out = {}
        try:
            await _gen(engine, kinds, a)
            before = _pages_of(engine, a) if port else None
            for p in others[:4]:
                await _gen(engine, kinds, p)
            res = await engine.reserve_remote(a)
            assert res.cached_tokens == 20
            out["reserve_idle"] = idle(engine)
            k, v = await engine.extract_pages(res.pages[:5])
            out["restored"] = (np.asarray(k), np.asarray(v))
            if port:
                for i, (ok, ov) in enumerate(before[:5]):
                    assert torch.equal(k[:, i], ok)
                    assert torch.equal(v[:, i], ov)
            await engine.release_pages(res.pages)
            # prefill side: each prefill_only's allocation evicts
            held = []
            for p in others[4:]:
                _, pages = await engine.prefill_only(
                    req_cls(token_ids=p, stop=stop_cls(max_tokens=1)),
                    ctx_cls())
                held.append(pages)
            k, v = await engine.extract_pages(held[-1])
            out["extract_idle"] = idle(engine)
            # decode side: a reservation that evicts, then an inject
            res2 = await engine.reserve_remote(others[0][:8] + a[:16])
            await engine.inject_pages(res2.pages, k, v)
            out["inject_idle"] = idle(engine)
            for pages in held + [res2.pages]:
                await engine.release_pages(pages)
            out["totals"] = (engine.offload_pages_total,
                             engine.restore_pages_total,
                             engine.prefix_hit_tokens_total)
        finally:
            await engine.stop()
        return out

    want = run_async(run(jeng, JAX))
    got = run_async(run(teng, PORT))
    assert got["reserve_idle"] and got["extract_idle"] and got["inject_idle"]
    assert got["totals"] == want["totals"]
    assert got["totals"][0] > 0 and got["totals"][1] >= 5
    for t, j in zip(got["restored"], want["restored"]):
        np.testing.assert_allclose(t, j, atol=1e-5)


# -------------------------------------------------------- tensor parallel


RANK = textwrap.dedent('''
    import sys
    from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.parallel.mesh import (MeshSpec, initialize_multihost,
                                                leave_process_groups)
    rank, store = int(sys.argv[1]), sys.argv[2]
    initialize_multihost("file://" + store, 2, rank)
    mesh = MeshSpec(model=2).build("cpu")
    try:
        TorchEngine(ModelConfig.tiny(), EngineConfig(host_pages=64),
                    mesh=mesh)
    except NotImplementedError as e:
        print("REFUSED " + str(e), flush=True)
    leave_process_groups(mesh)
''')


def test_tier_at_tensor_parallel_raises(tmp_path):
    """Two gloo ranks at model=2: an engine with host_pages > 0 raises
    NotImplementedError naming ROADMAP queue 1 item 11 on each rank,
    before it draws a weight."""
    script = tmp_path / "rank.py"
    script.write_text(RANK)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    logs = [tmp_path / f"rank{r}.log" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(tmp_path / "store")], cwd=REPO, env=env,
                              stdout=open(logs[r], "w"),
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        deadline = time.monotonic() + 120
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, log in zip(procs, logs):
        text = log.read_text()
        assert p.returncode == 0, text[-3000:]
        (line,) = [ln for ln in text.splitlines()
                   if ln.startswith("REFUSED ")]
        assert "tp > 1" in line and "item 11" in line
