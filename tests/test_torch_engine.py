"""The port's engine and serving chain against the JAX package's, on the
CPU at ModelConfig.tiny() in float32, with the same (bridged) weights:
greedy tokens through TorchEngine and JaxEngine must be identical, and
the port's HTTP server must return the text the JAX LocalChatChain
produces. Plus the port's isolation (it imports neither jax nor
dynamo_tpu) and its refusal to fall back to the CPU."""

import asyncio
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.jax_engine import JaxEngine
from dynamo_tpu.llm.engines import LocalChatChain as JaxChatChain
from dynamo_tpu.llm.model_card import ModelDeploymentCard as JaxCard
from dynamo_tpu.llm.protocols.common import (PreprocessedRequest as
                                             JaxRequest)
from dynamo_tpu.llm.protocols.common import StopConditions as JaxStop
from dynamo_tpu.llm.protocols.openai import (ChatCompletionRequest as
                                             JaxChatRequest)
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                   StopConditions)
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.run import serve_http
from dynamo_tpu_torch.runtime.engine import Context

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ECFG = dict(page_size=8, num_pages=64, max_batch=4, prefill_chunk=16,
            prefill_buckets=(16,), batch_buckets=(1, 2, 4), page_buckets=(8,),
            decode_steps=4)


def _engines():
    jcfg, tcfg = JaxModelConfig.tiny(), ModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 jparams.items()}, tcfg, device="cpu")
    jeng = JaxEngine(jcfg, JaxEngineConfig(**ECFG), params=jparams)
    teng = TorchEngine(tcfg, EngineConfig(**ECFG), params=tparams,
                       device="cpu")
    return jeng, teng


PROMPTS = [list(range(1, 6)), list(range(30, 70)),  # > prefill_chunk
           list(range(100, 117)), [7, 7, 7]]


async def _generate_all(engine, request_cls, stop_cls, ctx_cls,
                        max_tokens=(9, 12, 10, 5), eos=None):
    async def one(p, n, delay):
        await asyncio.sleep(delay)
        req = request_cls(token_ids=list(p),
                          stop=stop_cls(max_tokens=n),
                          eos_token_ids=list(eos or []))
        toks, fin = [], None
        async for out in engine.generate(req, ctx_cls()):
            toks += out.token_ids
            fin = out.finish_reason or fin
        return toks, fin

    try:
        return await asyncio.gather(*[
            one(p, n, 0.01 * i) for i, (p, n) in
            enumerate(zip(PROMPTS, max_tokens))])
    finally:
        await engine.stop()


def test_greedy_tokens_match_jax_engine():
    """Concurrent greedy requests (one longer than prefill_chunk, so it
    prefills in two chunks): token-identical to JaxEngine."""
    jeng, teng = _engines()
    want = asyncio.run(_generate_all(jeng, JaxRequest, JaxStop, JaxContext))
    got = asyncio.run(_generate_all(teng, PreprocessedRequest,
                                    StopConditions, Context))
    assert got == want
    assert [len(t) for t, _ in got] == [9, 12, 10, 5]
    assert all(f == "length" for _, f in got)


def test_device_stop_matches_jax_engine():
    """A stop id the model actually samples ends the row on device with
    finish 'eos' in both engines, at the same token."""
    jeng, teng = _engines()
    free = asyncio.run(_generate_all(teng, PreprocessedRequest,
                                     StopConditions, Context))
    eos = [free[0][0][3]]
    jeng, teng = _engines()
    want = asyncio.run(_generate_all(jeng, JaxRequest, JaxStop, JaxContext,
                                     eos=eos))
    got = asyncio.run(_generate_all(teng, PreprocessedRequest,
                                    StopConditions, Context, eos=eos))
    assert got == want
    assert got[0][1] == "eos" and got[0][0][-1] == eos[0]


def test_preemption_resumes_token_identical():
    """A pool too small for every row forces preemption + resume; the
    tokens still match an unconstrained run."""
    _, teng = _engines()
    want = asyncio.run(_generate_all(teng, PreprocessedRequest,
                                     StopConditions, Context,
                                     max_tokens=(20, 20, 20, 20)))
    tcfg = ModelConfig.tiny()
    small = TorchEngine(tcfg, EngineConfig(**{**ECFG, "num_pages": 20,
                                              "watermark_pages": 1}),
                        params=teng.params, device="cpu")
    got = asyncio.run(_generate_all(small, PreprocessedRequest,
                                    StopConditions, Context,
                                    max_tokens=(20, 20, 20, 20)))
    assert got == want


def test_warmup_writes_nothing_and_keeps_tokens():
    """warmup() runs padding rows only: the pools stay zero and later
    greedy tokens are unchanged."""
    _, teng = _engines()
    want = asyncio.run(_generate_all(teng, PreprocessedRequest,
                                     StopConditions, Context))
    _, teng = _engines()
    teng.warmup()
    assert not teng.kv_k.any() and not teng.kv_v.any()
    got = asyncio.run(_generate_all(teng, PreprocessedRequest,
                                    StopConditions, Context))
    assert got == want


def test_stats_keys_are_jax_engine_keys():
    jeng, teng = _engines()
    assert set(teng.stats()) <= set(jeng.stats())


def _chat_body(stream: bool):
    return {"model": "tiny", "stream": stream, "max_tokens": 12,
            "messages": [{"role": "user", "content": "hello there"}]}


async def _jax_chat_text(engine) -> str:
    chain = JaxChatChain(JaxCard(name="tiny"), engine)
    text = []
    try:
        async for chunk in chain(JaxChatRequest(**_chat_body(True)),
                                 JaxContext()):
            for c in chunk.model_dump(exclude_none=True).get("choices", []):
                text.append((c.get("delta") or {}).get("content") or "")
    finally:
        await engine.stop()
    return "".join(text)


async def _http_round_trip(engine):
    import aiohttp

    svc = await serve_http(engine, ModelDeploymentCard(name="tiny"),
                           "127.0.0.1", 0)
    base = f"http://127.0.0.1:{svc.port}"
    try:
        async with aiohttp.ClientSession() as s:
            async with s.get(f"{base}/health") as r:
                assert r.status == 200
            async with s.get(f"{base}/v1/models") as r:
                assert [m["id"] for m in (await r.json())["data"]] == ["tiny"]
            async with s.post(f"{base}/v1/chat/completions",
                              json=_chat_body(False)) as r:
                assert r.status == 200
                unary = await r.json()
            chunks = []
            async with s.post(f"{base}/v1/chat/completions",
                              json=_chat_body(True)) as r:
                assert r.headers["Content-Type"].startswith(
                    "text/event-stream")
                async for line in r.content:
                    line = line.decode().strip()
                    if line.startswith("data: "):
                        chunks.append(line[6:])
            async with s.post(f"{base}/v1/completions", json={
                    "model": "tiny", "prompt": "abc",
                    "max_tokens": 4}) as r:
                completion = await r.json()
            async with s.post(f"{base}/v1/chat/completions", json={
                    "model": "nope", "messages": []}) as r:
                missing = r.status
            async with s.post(f"{base}/v1/chat/completions", json={
                    **_chat_body(False), "logprobs": True}) as r:
                unsupported = r.status
    finally:
        await svc.stop()
        await engine.stop()
    return unary, chunks, completion, missing, unsupported


def test_http_round_trip_matches_jax_chat_chain():
    jeng, teng = _engines()
    want = asyncio.run(_jax_chat_text(jeng))
    unary, chunks, completion, missing, unsupported = asyncio.run(
        _http_round_trip(teng))
    assert unary["object"] == "chat.completion"
    assert unary["choices"][0]["message"]["content"] == want
    assert unary["choices"][0]["finish_reason"] == "length"
    assert chunks[-1] == "[DONE]"
    parsed = [json.loads(c) for c in chunks[:-1]]
    assert all(p["object"] == "chat.completion.chunk" for p in parsed)
    streamed = "".join((c["delta"].get("content") or "")
                       for p in parsed for c in p["choices"])
    assert streamed == want
    assert completion["object"] == "text_completion"
    assert completion["choices"][0]["finish_reason"] == "length"
    assert missing == 404 and unsupported == 400


def test_port_imports_neither_jax_nor_dynamo_tpu():
    """Importing every module of the port pulls in no jax and no
    dynamo_tpu module."""
    code = """
import importlib, pkgutil, sys
import dynamo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dynamo_tpu_torch.__path__,
                                               "dynamo_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "dynamo_tpu" or m.startswith("dynamo_tpu."))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 20, names
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_raises_without_gpu():
    """Entry points default to CUDA and never carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from dynamo_tpu_torch.models.llama import KVCacheSpec, init_kv_cache
    from dynamo_tpu_torch.run import build_engine, parse_args

    cfg = ModelConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        TorchEngine(cfg, EngineConfig(**ECFG))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        init_kv_cache(cfg, KVCacheSpec(4, 8))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        params_from_numpy({}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        build_engine(parse_args(["in=http", "out=torch", "--model", "tiny"]))
