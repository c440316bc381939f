"""Disaggregated prefill/decode in the port (``dynamo_tpu_torch/llm/
disagg`` and ``TorchEngine``'s disaggregation plane) against the JAX
package, on the CPU.

The tiny preset at page 8, as ``tests/test_disagg.py`` builds it, with
the JAX package's weights through ``models/bridge.py``: ``prefill_only``
and its extracted pages against ``JaxEngine``'s; an exact extract/inject
round trip that a later decode reads; remote-prefill generation
token-identical to a local run, port to port in chunked and bulk mode
(with the decode-side prefix-hit repeat) and across frameworks in both
directions; local fallback; the stale-client eviction after a decode
listener restart; and the decode engine's KV events from behind the
wrapper. Every await on a remote event is bounded, so a hang fails fast.
"""

import asyncio
import time
import types

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import kv_compress as ref_compress
from dynamo_tpu.engine.jax_engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.jax_engine import JaxEngine
from dynamo_tpu.llm.disagg import PrefillWorker as JaxPrefillWorker
from dynamo_tpu.llm.disagg.decode import \
    build_disagg_decode as jax_build_disagg_decode
from dynamo_tpu.llm.disagg.router import DisaggRouter as JaxDisaggRouter
from dynamo_tpu.llm.protocols.common import (PreprocessedRequest as
                                             JaxRequest)
from dynamo_tpu.llm.protocols.common import StopConditions as JaxStop
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.runtime import DistributedRuntime as JaxRuntime
from dynamo_tpu_torch.engine.kv_manager import chain_hashes
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.disagg import DisaggRouter, PrefillWorker
from dynamo_tpu_torch.llm.disagg.decode import build_disagg_decode
from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                   StopConditions)
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

PS = 8  # page size
LIMIT = 30.0  # seconds: the bound on every await of a remote event
ECFG = dict(page_size=PS, num_pages=64, max_batch=4, prefill_chunk=32,
            batch_buckets=(1, 2, 4), prefill_buckets=(8, 32),
            page_buckets=(8,), watermark_pages=2)


def bounded(aw, limit=LIMIT):
    return asyncio.wait_for(aw, limit)


def tiny(cls, dtype="float32"):
    return cls.tiny(num_heads=4, num_kv_heads=2, head_dim=8, hidden_size=32,
                    vocab_size=128, dtype=dtype)


def make_params(seed, dtype="float32"):
    jparams = jax_init_params(tiny(JaxModelConfig, dtype),
                              jax.random.PRNGKey(seed))
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 jparams.items()}, tiny(ModelConfig, dtype),
                                device="cpu")
    return jparams, tparams


def port_engine(tparams, dtype="float32", **ecfg):
    return TorchEngine(tiny(ModelConfig, dtype), EngineConfig(**{**ECFG,
                                                                 **ecfg}),
                       params=tparams, device="cpu")


def jax_engine(jparams, dtype="float32"):
    return JaxEngine(tiny(JaxModelConfig, dtype), JaxEngineConfig(**ECFG),
                     params=jparams)


def greedy(tokens, max_tokens=6, cls=PreprocessedRequest,
           stop=StopConditions):
    return cls(token_ids=list(tokens), stop=stop(max_tokens=max_tokens))


def prompt_of(n, a=7, b=1):
    return [(i * a) % 100 + b for i in range(n)]


async def collect(engine, req, ctx=None):
    toks = []

    async def run():
        async for out in engine.generate(req, ctx or Context()):
            toks.extend(out.token_ids)
            if out.finish_reason is not None:
                return out.finish_reason

    fin = await bounded(run())
    return toks, fin


async def local_tokens(tparams, prompts, dtype="float32", max_tokens=6):
    eng = port_engine(tparams, dtype)
    try:
        return [await collect(eng, greedy(p, max_tokens)) for p in prompts]
    finally:
        await eng.stop()


def prompt_rows(a, n):
    """Pages [L, pages, KV, ps, hd] -> their first n positions
    [L, n, KV, hd]."""
    a = np.asarray(a)
    L, npg, kv, ps, hd = a.shape
    return a.transpose(0, 1, 3, 2, 4).reshape(L, npg * ps, kv, hd)[:, :n]


def bits(a) -> np.ndarray:
    """A 16-bit page block's bits (a torch tensor or an ml_dtypes array)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy()
    return np.ascontiguousarray(a).view(np.int16)


# ------------------------------------------------------- engine primitives


def test_prefill_only_matches_jax_engine(run_async):
    """prefill_only's first token and the K/V it extracts at the prompt's
    positions equal JaxEngine's (float32, atol 1e-5), for a partial and
    a whole last page."""
    jparams, tparams = make_params(1)

    async def main():
        jeng, teng = jax_engine(jparams), port_engine(tparams)
        try:
            for n in (19, 24):
                prompt = prompt_of(n)
                jfirst, jpages = await bounded(jeng.prefill_only(
                    greedy(prompt, cls=JaxRequest, stop=JaxStop),
                    JaxContext(f"j{n}")))
                tfirst, tpages = await bounded(teng.prefill_only(
                    greedy(prompt), Context(f"t{n}")))
                assert len(tpages) == len(jpages) == -(-n // PS)
                assert tfirst == jfirst, n
                jk, jv = await bounded(jeng.extract_pages(jpages))
                tk, tv = await bounded(teng.extract_pages(tpages))
                assert tk.shape == jk.shape and tk.dtype == torch.float32
                # the prompt's positions (those past it in the last page
                # hold padding rows, which no query reads)
                for t, j in ((tk, jk), (tv, jv)):
                    np.testing.assert_allclose(prompt_rows(t.numpy(), n),
                                               prompt_rows(j, n), atol=1e-5)
                # the finish released nothing: the pages are held
                assert teng.pm.active == len(tpages)
                await jeng.release_pages(jpages)
                await teng.release_pages(tpages)
                assert teng.pm.active == 0
        finally:
            await jeng.stop()
            await teng.stop()

    run_async(main())


def test_extract_inject_roundtrip_and_decode_reads_injected(run_async):
    """Pages prefilled on one engine and injected into pages reserved on
    another come back bitwise; the pool is written in place (the tensors
    the decode graphs hold), and a decode entered with submit_prefilled
    reads them: its tokens are a local run's, and other K/V injected
    into the same pages changes them."""
    _, tparams = make_params(2)
    prompt = prompt_of(19)

    async def main():
        (want, _), = await local_tokens(tparams, [prompt])
        src, dst = port_engine(tparams), port_engine(tparams)
        try:
            first, pages = await bounded(src.prefill_only(
                greedy(prompt), Context("p")))
            k, v = await bounded(src.extract_pages(pages))
            chunks = [c async for c in src.extract_pages_chunked(pages, 2)]
            assert [c[0] for c in chunks] == [0, 2]
            assert torch.equal(torch.cat([c[1] for c in chunks], 1), k)
            assert torch.equal(torch.cat([c[2] for c in chunks], 1), v)
            await src.release_pages(pages)
            pool = (dst.kv_k.data_ptr(), dst.kv_v.data_ptr())
            got = []
            for inject in ((k, v), (torch.randn_like(k) * 4,
                                    torch.randn_like(v) * 4)):
                res = await bounded(dst.reserve_remote(prompt))
                assert res.skip_pages == 0 and len(res.pages) == 3
                await bounded(dst.inject_pages(res.pages, *inject))
                k2, v2 = await bounded(dst.extract_pages(res.pages))
                assert torch.equal(k2, inject[0])
                assert torch.equal(v2, inject[1])
                assert (dst.kv_k.data_ptr(), dst.kv_v.data_ptr()) == pool
                assert dst.graphs.kv_k is dst.kv_k
                seq = await bounded(dst.submit_prefilled(
                    greedy(prompt), Context(f"d{len(got)}"), res.pages,
                    first))
                toks = []
                while True:
                    out = await bounded(seq.out.get())
                    toks += out.token_ids
                    if out.finish_reason is not None:
                        break
                got.append(toks)
                # the injected (prefix-cached) prompt is dropped before the
                # control injects other K/V into the same page ids
                dst.pm.reusable.clear()
                dst.pm.by_hash.clear()
            return want, got
        finally:
            await src.stop()
            await dst.stop()

    want, (good, control) = run_async(main())
    assert good == want
    assert control[0] == want[0]  # the first token came with the pages
    assert control != want


def test_prefill_only_dispatches_no_decode_window(run_async):
    """A prefill-only job finishes on its first token without ever
    entering a decode window, also while other rows decode."""
    _, tparams = make_params(3)

    async def main():
        eng = port_engine(tparams)
        windows = []
        real = eng._dispatch_decode_window

        def spy(*a, **kw):
            pend = real(*a, **kw)
            if pend is not None:
                windows.append([s.hold_pages for s in pend.batch])
            return pend

        eng._dispatch_decode_window = spy
        try:
            busy = asyncio.ensure_future(collect(eng, greedy(prompt_of(5),
                                                             12)))
            await asyncio.sleep(0.05)
            first, pages = await bounded(eng.prefill_only(
                greedy(prompt_of(21, 3)), Context("p")))
            toks, fin = await bounded(busy)
            await eng.release_pages(pages)
            return windows, toks, eng.pm.active
        finally:
            await eng.stop()

    windows, toks, active = run_async(main())
    assert len(toks) == 12 and windows
    assert not any(any(w) for w in windows)
    assert active == 0


def test_disagg_plane_raises_at_tensor_parallel(run_async):
    """At tp > 1 each rank holds only its heads of the pool: extract,
    inject and prefill_only refuse."""
    _, tparams = make_params(4)
    eng = port_engine(tparams)
    eng.mesh = types.SimpleNamespace(size=2, rank=0)

    async def main():
        with pytest.raises(NotImplementedError, match="item 11"):
            await eng.extract_pages([1])
        with pytest.raises(NotImplementedError, match="item 11"):
            async for _ in eng.extract_pages_chunked([1], 1):
                pass
        with pytest.raises(NotImplementedError, match="item 11"):
            await eng.inject_pages([1], torch.zeros(1), torch.zeros(1))
        with pytest.raises(NotImplementedError, match="item 11"):
            await eng.prefill_only(greedy([1, 2]), Context())

    run_async(main())


# -------------------------------------------------------------- end to end


async def _disagg(drt, decode_eng, threshold=2, namespace="test"):
    return await bounded(build_disagg_decode(
        drt, decode_eng, namespace=namespace,
        router=DisaggRouter(max_local_prefill_length=threshold),
        watch_config=False))


async def _teardown(*objs):
    for o in objs:
        if isinstance(o, (PrefillWorker, JaxPrefillWorker)):
            await bounded(o.stop())
        elif hasattr(o, "transfer"):
            await bounded(o.transfer.stop())
        else:
            await bounded(o.stop())


@pytest.mark.parametrize("chunk_pages", [1, 0], ids=["chunked", "bulk"])
@pytest.mark.parametrize("prompt_len", [19, 24])
def test_disagg_end_to_end_matches_local(run_async, prompt_len, chunk_pages):
    """Remote-prefill generation is token-identical to a local run; the
    repeat of the prompt hits the decode side's prefix cache and ships
    only the pages past it (skip_pages)."""
    _, tparams = make_params(5)
    prompt = prompt_of(prompt_len)

    async def main():
        (want, want_fin), = await local_tokens(tparams, [prompt])
        drt = await DistributedRuntime.detached()
        try:
            dec, pre = port_engine(tparams), port_engine(tparams)
            disagg = await _disagg(drt, dec)
            pw = PrefillWorker(drt, pre, namespace="test",
                               chunk_pages=chunk_pages)
            pw.start()
            got = [await collect(disagg, greedy(prompt)) for _ in range(2)]
            st, wst = disagg.stats(), pw.stats()
            await _teardown(pw, disagg, pre, dec)
            return want, want_fin, got, st, wst
        finally:
            await drt.shutdown()

    want, want_fin, got, st, wst = run_async(main())
    assert got == [(want, want_fin)] * 2
    assert (st["remote_prefills"], st["remote_fallbacks"],
            st["local_prefills"]) == (2, 0, 0)
    n_pages = -(-prompt_len // PS)
    skip = (prompt_len - 1) // PS  # the repeat's cached full pages
    assert st["kv_transfer_pages_total"] == n_pages + n_pages - skip
    assert st["kv_transfer_chunks_total"] == (
        (n_pages + n_pages - skip) if chunk_pages == 1 else 2)
    assert (wst["completed"], wst["failed"]) == (2, 0)
    assert wst["kv_send_chunks_sent"] == (st["kv_transfer_chunks_total"]
                                          if chunk_pages else 0)
    assert st["kv_transfer_bytes_total"] == wst["kv_send_bytes_sent"]


def test_set_role_labels_latency_histograms(run_async):
    """The prefill worker and the decode wrapper relabel their engines:
    each engine's latency_hist is keyed by its role, as JaxEngine's."""
    _, tparams = make_params(6)

    async def main():
        drt = await DistributedRuntime.detached()
        try:
            dec, pre = port_engine(tparams), port_engine(tparams)
            assert dec.role == pre.role == "unified"
            disagg = await _disagg(drt, dec)
            pw = PrefillWorker(drt, pre, namespace="test")
            pw.start()
            await collect(disagg, greedy(prompt_of(20)))
            roles = (dec.stats()["role"], pre.stats()["role"],
                     sorted(dec.stats()["latency_hist"]),
                     sorted(pre.stats()["latency_hist"]))
            await _teardown(pw, disagg, pre, dec)
            return roles
        finally:
            await drt.shutdown()

    jeng = jax_engine(make_params(6)[0])
    jeng.set_role("prefill")
    assert jeng.stats()["role"] == "prefill"
    dec_role, pre_role, dec_hist, pre_hist = run_async(main())
    assert (dec_role, pre_role) == ("decode", "prefill")
    assert dec_hist == ["decode"] and pre_hist == ["prefill"]


def test_disagg_fallback_on_no_prefill_worker(run_async):
    """No prefill worker alive: the remote wait times out and the request
    is prefilled locally, token-identical."""
    _, tparams = make_params(7)
    prompt = prompt_of(20, 3)

    async def main():
        (want, _), = await local_tokens(tparams, [prompt])
        drt = await DistributedRuntime.detached()
        try:
            dec = port_engine(tparams)
            disagg = await _disagg(drt, dec)
            disagg.prefill_timeout = 0.3
            got, _ = await collect(disagg, greedy(prompt))
            st = disagg.stats()
            await _teardown(disagg, dec)
            return want, got, st
        finally:
            await drt.shutdown()

    want, got, st = run_async(main())
    assert got == want
    assert (st["remote_prefills"], st["remote_fallbacks"]) == (1, 1)
    assert st["kv_free_blocks"] == ECFG["num_pages"] - 1 - st[
        "kv_cached_blocks"]


def test_disagg_concurrent_mixed_fallback_completes(run_async):
    """Concurrent requests race remote prefills against a worker that is
    slow for odd-length prompts, under a small decode pool: remote
    successes, timeout fallbacks (their KV lands after the fallback
    released the reservation and is dropped) and local prefills mix,
    and every request completes with a local run's tokens."""
    _, tparams = make_params(8)
    prompts = [[(i * 11 + j * 3) % 100 + 1 for j in range(16 + i)]
               for i in range(8)]

    async def main():
        want = await local_tokens(tparams, prompts)
        drt = await DistributedRuntime.detached()
        try:
            dec = port_engine(tparams, num_pages=24)
            pre = port_engine(tparams)
            disagg = await _disagg(drt, dec, namespace="stress")
            pw = PrefillWorker(drt, pre, namespace="stress",
                               max_inflight=len(prompts) + 1)
            orig = pw._handle

            async def slow_handle(req):
                if len(req.token_ids) % 2 == 1:
                    await asyncio.sleep(2.5)
                await orig(req)

            pw._handle = slow_handle
            pw.start()
            disagg.prefill_timeout = 1.0
            got = await bounded(asyncio.gather(
                *(collect(disagg, greedy(p)) for p in prompts)))
            await asyncio.sleep(2.0)  # the late KV arrives and is dropped
            st = disagg.stats()
            await _teardown(pw, disagg, pre, dec)
            return want, got, st
        finally:
            await drt.shutdown()

    want, got, st = run_async(main())
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, i
    assert st["remote_fallbacks"] > 0
    assert st["remote_prefills"] > st["remote_fallbacks"]
    assert st["kv_active_blocks"] == 0


def test_prefill_worker_evicts_stale_client_on_decode_restart(run_async):
    """A decode listener restart (new port, re-registered) leaves the
    worker's cached client on a dead endpoint: the worker evicts it once,
    re-resolves from DCP and sends; the listener's stop() returns at once
    with the worker's connection open."""
    _, tparams = make_params(9)

    async def main():
        drt = await DistributedRuntime.detached()
        try:
            dec, pre = port_engine(tparams), port_engine(tparams)
            disagg = await _disagg(drt, dec)
            pw = PrefillWorker(drt, pre, namespace="test")
            pw.start()
            await collect(disagg, greedy(prompt_of(20, 5)))
            assert pw.completed == 1 and len(disagg.transfer._conns) == 1
            t0 = time.monotonic()
            await bounded(disagg.transfer.stop())
            stop_s = time.monotonic() - t0
            await disagg.transfer.start()
            await disagg.transfer.register(drt.dcp, "test", drt.instance_id)
            toks, fin = await collect(disagg, greedy(prompt_of(21, 9, 3)))
            st = disagg.stats()
            out = (stop_s, fin, st["remote_prefills"],
                   st["remote_fallbacks"], pw.completed, pw.failed,
                   pw.client_evictions)
            await _teardown(pw, disagg, pre, dec)
            return out
        finally:
            await drt.shutdown()

    stop_s, fin, remote, fallbacks, done, failed, evictions = \
        run_async(main())
    assert stop_s < 1.0, stop_s
    assert fin == "length"
    assert (remote, fallbacks, done, failed, evictions) == (2, 0, 2, 0, 1)


def test_served_disagg_decode_publishes_inner_engine_events(run_async):
    """Served behind serve_token_model, the wrapper has no ``pm``: the KV
    event publisher runs on the inner engine, and the router's index
    holds the remote prompt's full pages from the decode side's
    events."""
    from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher
    from dynamo_tpu_torch.llm.kv_router.router import KvRouter
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.worker import serve_token_model

    _, tparams = make_params(10)
    prompt = prompt_of(27)

    async def main():
        drt = await DistributedRuntime.detached()
        try:
            dec, pre = port_engine(tparams), port_engine(tparams)
            disagg = await _disagg(drt, dec)
            mdc = ModelDeploymentCard(name="dis", kv_block_size=PS)
            handle, none = await bounded(serve_token_model(
                drt, mdc, disagg, namespace="test", component="dec"))
            pub = KvEventPublisher(drt.dcp, "test", "dec", drt.instance_id,
                                   disagg.engine, interval=0.05)
            pub.start()
            router = KvRouter(drt, "test", "dec", block_size=PS,
                              scrape_interval=0.2, seed=0)
            await bounded(router.start())
            pw = PrefillWorker(drt, pre, namespace="test")
            pw.start()
            client = await bounded(drt.namespace("test").component("dec")
                                   .endpoint("generate_tokens").client())
            await bounded(client.wait_for_instances())
            toks = []
            stream = await bounded(client.round_robin(
                greedy(prompt).to_dict()))
            async for item in stream:
                toks += item.data["token_ids"]
            t0 = time.monotonic()
            while (router.overlap_for(prompt, drt.instance_id) < 3
                   and time.monotonic() - t0 < LIMIT):
                await asyncio.sleep(0.05)
            out = (none, toks, disagg.remote_prefills,
                   router.overlap_for(prompt, drt.instance_id))
            await router.stop()
            await client.close()
            await handle.stop()
            await pub.stop()
            await _teardown(pw, disagg, pre, dec)
            return out
        finally:
            await drt.shutdown()

    none, toks, remote, overlap = run_async(main())
    assert none is None and remote == 1 and len(toks) == 6
    assert overlap == len(chain_hashes(prompt, PS)) == 3


# --------------------------------------------------------- across frameworks


async def _cross(direction, jparams, tparams, prompt, dtype, compress=None):
    """One remote request across frameworks: ``jax_to_port`` (a JAX
    PrefillWorker feeding the port's DisaggDecodeEngine) or
    ``port_to_jax``. Records the pages the sender extracted and the pages
    that landed in the receiver's pool (read back right after each
    inject). Returns (tokens, finish, sent, landed, decode stats)."""
    jdrt = await JaxRuntime.detached()
    tdrt = await DistributedRuntime.attach(jdrt.dcp.address)
    sent, landed = [], []
    try:
        if direction == "jax_to_port":
            pre, dec = jax_engine(jparams, dtype), port_engine(tparams, dtype)
            disagg = await _disagg(tdrt, dec, namespace="x")
            pw = JaxPrefillWorker(jdrt, pre, namespace="x",
                                  compress_kv=compress)
            req, ctx = greedy(prompt), Context("x1")
        else:
            pre, dec = port_engine(tparams, dtype), jax_engine(jparams, dtype)
            disagg = await bounded(jax_build_disagg_decode(
                jdrt, dec, namespace="x",
                router=JaxDisaggRouter(max_local_prefill_length=2),
                watch_config=False))
            pw = PrefillWorker(tdrt, pre, namespace="x", compress_kv=compress)
            req = greedy(prompt, cls=JaxRequest, stop=JaxStop)
            ctx = JaxContext("x1")
        real_chunks, real_inject = pre.extract_pages_chunked, dec.inject_pages

        async def chunks(page_ids, cp):
            async for c in real_chunks(page_ids, cp):
                sent.append(c[1:3])
                yield c

        async def inject(page_ids, k, v):
            await real_inject(page_ids, k, v)
            landed.append(await dec.extract_pages(page_ids))

        pre.extract_pages_chunked, dec.inject_pages = chunks, inject
        pw.start()
        toks, fin = await collect(disagg, req, ctx)
        st = disagg.stats()
        await _teardown(pw, disagg, pre, dec)
        return toks, fin, sent, landed, st
    finally:
        await tdrt.shutdown()
        await jdrt.shutdown()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_framework_float32_matches_local(run_async, direction):
    """float32: a JAX prefill worker feeding the port's decode engine, and
    the port's feeding a JAX one, give a local run's tokens; the pages
    land as the sender extracted them."""
    jparams, tparams = make_params(11)
    prompt = prompt_of(22, 9)

    async def main():
        (want, _), = await local_tokens(tparams, [prompt])
        return want, await _cross(direction, jparams, tparams, prompt,
                                  "float32")

    want, (toks, fin, sent, landed, st) = run_async(main())
    assert toks == want and fin == "length"
    assert (st["remote_prefills"], st["remote_fallbacks"]) == (1, 0)
    assert sent and len(sent) == len(landed)
    for (sk, sv), (lk, lv) in zip(sent, landed):
        np.testing.assert_array_equal(np.asarray(sk), np.asarray(lk))
        np.testing.assert_array_equal(np.asarray(sv), np.asarray(lv))


def test_cross_framework_bfloat16_port_to_jax_lands_bitwise(run_async):
    """bfloat16 pool: the port's prefill worker sends raw bfloat16 bytes;
    the JAX decode engine's pool holds them bitwise and the request
    finishes (the two frameworks' bfloat16 arithmetic may break greedy
    ties differently, so the tokens are not compared)."""
    jparams, tparams = make_params(12, "bfloat16")
    prompt = prompt_of(22, 9)

    toks, fin, sent, landed, st = run_async(_cross(
        "port_to_jax", jparams, tparams, prompt, "bfloat16"))
    assert fin == "length" and len(toks) == 6
    assert (st["remote_prefills"], st["remote_fallbacks"]) == (1, 0)
    assert len(sent) == len(landed) == 1
    (sk, sv), (lk, lv) = sent[0], landed[0]
    assert sk.dtype == torch.bfloat16 and lk.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(bits(sk), bits(lk))
    np.testing.assert_array_equal(bits(sv), bits(lv))


def test_cross_framework_bfloat16_jax_to_port_int8_lands_bitwise(run_async):
    """bfloat16 pool, JAX prefill worker: the reference's codec cannot
    frame a raw ml_dtypes bfloat16 array (numpy gives no buffer for it),
    so the JAX worker ships bfloat16 pages int8-compressed
    (``compress_kv``). What lands in the port's pool is bitwise what the
    reference restores from the same int8 pages, within s/2 of the
    sender's, and the request finishes."""
    jparams, tparams = make_params(13, "bfloat16")
    prompt = prompt_of(22, 9)

    toks, fin, sent, landed, st = run_async(_cross(
        "jax_to_port", jparams, tparams, prompt, "bfloat16", compress=True))
    assert fin == "length" and len(toks) == 6
    assert (st["remote_prefills"], st["remote_fallbacks"]) == (1, 0)
    assert len(sent) == len(landed) == 1
    for s, got in zip(sent[0], landed[0]):
        q, sc = ref_compress.quantize_pages_np(s)
        want = ref_compress.dequantize_pages_np(q, sc, s.dtype)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(bits(got), bits(want))
        a = np.asarray(s, np.float32)
        err = np.abs(got.float().numpy() - a)
        # s/2 of the int8 step, plus the bfloat16 rounding of the result
        # (half an ulp: 2^-8 of its magnitude) and float32 slack
        bound = (sc / 2 + np.abs(a)) * (1 + 2.0 ** -8) - np.abs(a)
        assert np.all(err <= bound + sc * 1e-6)
