"""The port's KV plane and router against the JAX package's (the
reference), on the CPU: ``chain_hashes`` equal across the packages; the
radix index and the cost scheduler on seeded event streams and traffic;
``ForwardPassMetrics.from_dict`` over both engines' stats; the
reference's KV-routed graph (tests/test_kv_router.py) on the port — two
tiny float32 TorchEngines behind the port's router, Processor and HTTP
service, with prefix affinity and JaxEngine's greedy tokens; and the
reference's KvRouter fed by port workers' events, whose index equals the
one JAX workers' events build for the same requests."""

import asyncio
import random

import jax
import numpy as np
import pytest

from dynamo_tpu.engine import kv_manager as ref_kv
from dynamo_tpu.engine.jax_engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.jax_engine import JaxEngine
from dynamo_tpu.llm.kv_router import indexer as ref_indexer
from dynamo_tpu.llm.kv_router import protocols as ref_protocols
from dynamo_tpu.llm.kv_router import scheduler as ref_scheduler
from dynamo_tpu.llm.protocols.common import (PreprocessedRequest as
                                             JaxRequest)
from dynamo_tpu.llm.protocols.common import StopConditions as JaxStop
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import kv_manager
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.kv_router import indexer, protocols, scheduler
from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                   StopConditions)
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.engine import Context

BS = 8  # block size, as the reference's router tests use
ECFG = dict(page_size=BS, num_pages=128, max_batch=8, prefill_chunk=64)


def _params():
    jcfg = JaxModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 jparams.items()}, ModelConfig.tiny(),
                                device="cpu")
    return jcfg, jparams, tparams


def _torch_engine(tparams):
    return TorchEngine(ModelConfig.tiny(), EngineConfig(**ECFG),
                       params=tparams, device="cpu")


def _jax_engine(jcfg, jparams):
    return JaxEngine(jcfg, JaxEngineConfig(**ECFG), params=jparams)


def tap(engine, store: dict) -> None:
    """Record each request's prompt and generated tokens by context id,
    around ``engine.generate`` (the call the token endpoint makes)."""
    real = engine.generate

    async def generate(req, ctx):
        rec = store.setdefault(ctx.id, {"prompt": list(req.token_ids),
                                        "tokens": []})
        async for out in real(req, ctx):
            rec["tokens"] += list(out.token_ids)
            yield out

    engine.generate = generate


async def _greedy(engine, req_cls, stop_cls, ctx_cls, prompt, n):
    toks = []
    async for out in engine.generate(
            req_cls(token_ids=list(prompt), stop=stop_cls(max_tokens=n)),
            ctx_cls()):
        toks += out.token_ids
    return toks


@pytest.mark.parametrize("page_size", [1, 8, 16, 64])
def test_chain_hashes_equal_across_packages(page_size):
    rng = np.random.RandomState(page_size)
    for n in (0, 1, page_size - 1, page_size, 5 * page_size + 3, 700):
        toks = [int(t) for t in rng.randint(0, 128256, n)]
        assert kv_manager.chain_hashes(toks, page_size) == \
            ref_kv.chain_hashes(toks, page_size)
        parent = int(rng.randint(0, 2**63 - 1)) * 2 + 1  # past 2^63
        assert kv_manager.chain_hashes(toks, page_size, parent) == \
            ref_kv.chain_hashes(toks, page_size, parent)
        cache = kv_manager.ChainHashCache(page_size)
        cache.extend(toks[:n // 2])
        assert cache.extend(toks) == ref_kv.chain_hashes(toks, page_size)


def _event_stream(seed, n_events=300, workers=4):
    """Seeded Stored/Removed events of several workers over shared and
    divergent block chains (stored chains anchor at their parent block),
    with a worker removal now and then: (kind, payload) steps."""
    rng = np.random.RandomState(seed)
    base = [int(t) for t in rng.randint(0, 500, 12 * BS)]
    seqs = [base[:int(rng.randint(1, 12)) * BS]
            + [int(t) for t in rng.randint(0, 500, 8 * BS)]
            for _ in range(10)]
    hashes = [ref_kv.chain_hashes(s, BS) for s in seqs]
    held = {w: set() for w in range(workers)}
    steps = []
    for _ in range(n_events):
        w = int(rng.randint(workers))
        r = rng.rand()
        if r < 0.6:
            h = hashes[rng.randint(len(hashes))]
            a = int(rng.randint(len(h)))
            b = int(rng.randint(a + 1, len(h) + 1))
            parent = h[a - 1] if a > 0 else None
            steps.append(("event", (w, "stored", h[a:b], parent)))
            held[w].update(h[a:b])
        elif r < 0.95 and held[w]:
            pick = sorted(held[w])
            gone = [pick[i] for i in rng.choice(
                len(pick), int(rng.randint(1, min(len(pick), 6) + 1)),
                replace=False)]
            steps.append(("event", (w, "removed", gone, None)))
            held[w].difference_update(gone)
        else:
            steps.append(("remove_worker", w))
            held[w].clear()
    return steps, seqs


@pytest.mark.parametrize("seed", range(3))
def test_radix_tree_matches_reference_on_event_streams(seed):
    steps, seqs = _event_stream(seed)
    ours, theirs = indexer.KvIndexer(BS), ref_indexer.KvIndexer(
        BS, backend="python")
    for i, (kind, arg) in enumerate(steps):
        if kind == "event":
            w, k, hs, parent = arg
            ours.apply_event(protocols.KvCacheEventWire(w, k, hs, parent))
            theirs.apply_event(ref_protocols.KvCacheEventWire(w, k, hs,
                                                              parent))
        else:
            ours.remove_worker(arg)
            theirs.remove_worker(arg)
        assert ours.tree.block_count() == theirs.tree.block_count(), i
        if i % 10 == 0:
            for s in seqs:
                assert ours.find_matches_for_request(s).scores == \
                    theirs.find_matches_for_request(s).scores, i
    assert ours.workers() == theirs.workers()
    assert {w: sorted(d) for w, d in ours.tree.lookup.items()} == \
        {w: sorted(d) for w, d in theirs.tree.lookup.items()}


@pytest.mark.parametrize("seed", range(3))
def test_scheduler_matches_reference_on_seeded_traffic(seed):
    """Both schedulers, seeded alike, pick the same workers and keep the
    same decision records over random metrics, overlaps, exclusions and
    drains (ties break on the shared seed)."""
    rng = np.random.RandomState(seed)
    ours = scheduler.KvScheduler(block_size=BS, rng=random.Random(seed))
    theirs = ref_scheduler.KvScheduler(block_size=BS,
                                       rng=random.Random(seed),
                                       autotune=False)
    picks = []
    for step in range(120):
        if step % 15 == 0:
            raw = {}
            for wid in range(0x1000, 0x1000 + int(rng.randint(1, 5))):
                total = int(rng.choice([0, 8, 64]))
                raw[wid] = dict(
                    request_active_slots=int(rng.randint(0, 4)),
                    request_total_slots=int(rng.choice([0, 4, 8])),
                    kv_active_blocks=int(rng.randint(0, max(total, 1))),
                    kv_total_blocks=total,
                    draining=int(rng.rand() < 0.1), unknown_key=1)
            ours.update_metrics({w: protocols.ForwardPassMetrics.from_dict(d)
                                 for w, d in raw.items()})
            theirs.update_metrics(
                {w: ref_protocols.ForwardPassMetrics.from_dict(d)
                 for w, d in raw.items()})
        wids = sorted(ours.workers)
        scores = {w: int(rng.randint(0, 6)) for w in wids
                  if rng.rand() < 0.6}
        exclude = {wids[0]} if rng.rand() < 0.1 else None
        n = int(rng.randint(1, 60))
        try:
            got = ours.schedule(n, indexer.OverlapScores(dict(scores)),
                                request_id=f"r{step}", exclude=exclude)
        except RuntimeError as e:
            got = str(e)
        try:
            want = theirs.schedule(n, ref_indexer.OverlapScores(dict(scores)),
                                   request_id=f"r{step}", exclude=exclude)
        except RuntimeError as e:
            want = str(e)
        assert got == want, step
        picks.append(got)
    assert list(ours.decisions) == list(theirs.decisions)
    assert any(isinstance(p, int) for p in picks)


def test_forward_pass_metrics_take_both_engines_stats():
    """``from_dict`` takes TorchEngine.stats() (with its ``memory`` key,
    without some JAX counters) and JaxEngine.stats(); on each, the port's
    metrics equal the reference's."""
    jcfg, jparams, tparams = _params()
    for stats in (_torch_engine(tparams).stats(),
                  _jax_engine(jcfg, jparams).stats()):
        ours = protocols.ForwardPassMetrics.from_dict(stats)
        theirs = ref_protocols.ForwardPassMetrics.from_dict(stats)
        assert ours.to_dict() == theirs.to_dict()
        assert ours.request_total_slots == ECFG["max_batch"]
        assert ours.kv_total_blocks == stats["kv_total_blocks"] > 0


def test_kv_routed_graph_end_to_end():
    """The reference's KV-routed graph on the port: two tiny TorchEngine
    workers (each its own lease) + KvRouter + Processor behind the HTTP
    service. Identical prompts route to the worker that holds their
    prefix, the index fills from the published events, the holding
    engine counts prefix hits, and every routed request's greedy tokens
    are JaxEngine's on the same weights."""

    async def main():
        import aiohttp

        from dynamo_tpu_torch.llm.http.service import HttpService
        from dynamo_tpu_torch.llm.kv_router.router import KvRouter
        from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
        from dynamo_tpu_torch.llm.processor import Processor
        from dynamo_tpu_torch.llm.worker import serve_token_model
        from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

        jcfg, jparams, tparams = _params()
        drt = await DistributedRuntime.detached()
        drt2 = await DistributedRuntime.attach(drt.dcp.address)
        mdc = ModelDeploymentCard(name="routed", tokenizer_kind="byte",
                                  context_length=512, kv_block_size=BS)
        eng1, eng2 = _torch_engine(tparams), _torch_engine(tparams)
        seen = {}
        tap(eng1, seen)
        tap(eng2, seen)
        h1, p1 = await serve_token_model(drt, mdc, eng1, namespace="demo",
                                         component="worker")
        h2, p2 = await serve_token_model(drt2, mdc, eng2, namespace="demo",
                                         component="worker")
        router = KvRouter(drt, "demo", "worker", block_size=BS,
                          scrape_interval=0.2, seed=0)
        await router.start()
        token_client = await drt.namespace("demo").component("worker") \
            .endpoint("generate_tokens").client()
        assert len(await token_client.wait_for_instances()) in (1, 2)
        processor = Processor(mdc, token_client, router)
        service = HttpService()
        service.manager.add_chat_model("routed", processor.chat)
        service.manager.add_completions_model("routed", processor.completion)
        await service.start(host="127.0.0.1", port=0)
        base = f"http://127.0.0.1:{service.port}"

        prompt = "shared prefix for cache affinity " * 4
        body = {"model": "routed", "max_tokens": 4,
                "messages": [{"role": "user", "content": prompt}]}
        async with aiohttp.ClientSession() as http:
            async with http.post(f"{base}/v1/chat/completions", json=body,
                                 headers={"X-Request-Id": "c0"}) as r:
                assert r.status == 200, await r.text()
            for _ in range(40):  # events arrive every 0.25 s
                if router.indexer.tree.block_count() > 0:
                    break
                await asyncio.sleep(0.1)
            assert router.indexer.tree.block_count() > 0
            holder = router.scheduler.decisions[-1]["chosen"]
            first_ids = seen["c0"]["prompt"]
            assert router.overlap_for(first_ids, holder) == \
                len(first_ids) // BS
            async with http.post(f"{base}/v1/chat/completions", json=body,
                                 headers={"X-Request-Id": "c1"}) as r:
                assert r.status == 200
                chat = await r.json()
            stats = router.stats()
            assert stats["decisions"] == 2
            assert stats["avg_hit_rate"] > 0  # the repeat overlapped
            assert router.scheduler.decisions[-1]["chosen"] == holder
            async with http.post(f"{base}/v1/completions",
                                 json={"model": "routed", "prompt": "xyz",
                                       "max_tokens": 3},
                                 headers={"X-Request-Id": "p0"}) as r:
                assert r.status == 200
                comp = await r.json()
            assert comp["choices"][0]["finish_reason"] == "length"
        assert chat["choices"][0]["finish_reason"] == "length"
        hold_eng = eng1 if holder == drt.instance_id else eng2
        assert hold_eng.prefix_hit_tokens_total >= (len(first_ids) // BS) * BS

        await router.stop()
        await service.stop()
        await token_client.close()
        for h in (h1, h2):
            await h.stop()
        for p in (p1, p2):
            await p.stop()
        await eng1.stop()
        await eng2.stop()
        await drt2.shutdown()
        await drt.shutdown()

        jeng = _jax_engine(jcfg, jparams)
        try:
            for rid, rec in seen.items():
                want = await _greedy(jeng, JaxRequest, JaxStop, JaxContext,
                                     rec["prompt"], len(rec["tokens"]))
                assert rec["tokens"] == want, rid
        finally:
            await jeng.stop()
        assert sorted(seen) == ["c0", "c1", "p0"]

    asyncio.run(main())


def test_reference_router_indexes_port_events_as_jax_events():
    """The reference's KvRouter, subscribed to two port workers' KV
    events and to two JAX workers' events for the same requests (request
    i on worker i % 2 of each pair, the same greedy tokens), builds the
    same index: the same block count, workers and overlap scores over
    every prompt and every prompt with its generated tokens; and its
    scheduler reads the port workers' stats."""

    async def main():
        from dynamo_tpu.llm.kv_router.router import KvRouter as RefRouter
        from dynamo_tpu.llm.model_card import ModelDeploymentCard as RefCard
        from dynamo_tpu.llm.worker import serve_token_model as ref_serve
        from dynamo_tpu.runtime.runtime import (DistributedRuntime as
                                                RefRuntime)
        from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
        from dynamo_tpu_torch.llm.worker import serve_token_model
        from dynamo_tpu_torch.runtime.dcp_server import DcpServer
        from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

        jcfg, jparams, tparams = _params()
        server = await DcpServer.start()
        rdrt = await RefRuntime.attach(server.address)
        port_engines = [_torch_engine(tparams) for _ in range(2)]
        jax_engines = [_jax_engine(jcfg, jparams) for _ in range(2)]
        mdc = ModelDeploymentCard(name="m", kv_block_size=BS)
        rmdc = RefCard(name="m", kv_block_size=BS)
        drts, served = [], []
        for eng in port_engines:
            d = await DistributedRuntime.attach(server.address)
            drts.append(d)
            served.append(await serve_token_model(
                d, mdc, eng, namespace="x", component="port"))
        for eng in jax_engines:
            d = await RefRuntime.attach(server.address)
            drts.append(d)
            served.append(await ref_serve(
                d, rmdc, eng, namespace="x", component="jax"))
        routers = {}
        for comp in ("port", "jax"):
            routers[comp] = RefRouter(rdrt, "x", comp, block_size=BS,
                                      scrape_interval=0.5)
            await routers[comp].start(run_loop=False)
        rng = np.random.RandomState(5)
        shared = [int(t) for t in rng.randint(0, 256, 3 * BS)]
        prompts = [shared + [int(t) for t in rng.randint(0, 256, n)]
                   for n in (2 * BS, BS + 3, 4 * BS, 5)] + [
            [int(t) for t in rng.randint(0, 256, 2 * BS + 1)]]
        seqs = []
        for i, p in enumerate(prompts):
            got = await _greedy(port_engines[i % 2], PreprocessedRequest,
                                StopConditions, Context, p, 9)
            want = await _greedy(jax_engines[i % 2], JaxRequest, JaxStop,
                                 JaxContext, p, 9)
            assert got == want
            seqs += [p, p + got]
        for _h, pub in served:
            await pub.flush()
        await asyncio.sleep(0.5)
        views = {}
        for comp, worker_ids in (("port", [d.instance_id for d in drts[:2]]),
                                 ("jax", [d.instance_id for d in drts[2:]])):
            idx = routers[comp].indexer
            views[comp] = {
                "blocks": idx.tree.block_count(),
                "workers": [worker_ids.index(w) for w in idx.workers()],
                "scores": [{worker_ids.index(w): n for w, n in
                            idx.find_matches_for_request(q).scores.items()}
                           for q in seqs]}
        assert views["port"] == views["jax"]
        assert views["port"]["blocks"] > 0
        assert views["port"]["workers"] == [0, 1]
        # the reference scheduler reads the port workers' stats replies
        await routers["port"].scrape_once()
        fpm = routers["port"].scheduler.workers
        assert sorted(fpm) == sorted(d.instance_id for d in drts[:2])
        assert all(w.metrics.request_total_slots == ECFG["max_batch"]
                   for w in fpm.values())

        for r in routers.values():
            await r.stop()
        for h, pub in served:
            await h.stop()
            await pub.stop()
        for eng in port_engines + jax_engines:
            await eng.stop()
        for d in drts:
            await d.shutdown()
        await rdrt.shutdown()
        await server.stop()

    asyncio.run(main())
