"""The port's worker mode and frontend against the JAX package's (the
reference), on the CPU: a port worker serving the tiny float32
TorchEngine behind the reference's ModelWatcher and HttpService, and the
port's frontend in front of a reference JaxEngine worker — each with
JaxEngine's greedy tokens on the same weights; discovery and withdrawal
on the port alone; the launcher's new modes and flags against
``dynamo_tpu/run.py parse_args``; and the three processes the launcher
runs (control plane, worker, frontend) end to end."""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from dynamo_tpu.engine.jax_engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.jax_engine import JaxEngine
from dynamo_tpu.llm.protocols.common import (PreprocessedRequest as
                                             JaxRequest)
from dynamo_tpu.llm.protocols.common import StopConditions as JaxStop
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                   StopConditions)
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.runtime.engine import Context
from torch_dcp_wait import wait_for_dcp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ECFG = dict(page_size=8, num_pages=64, max_batch=4, prefill_chunk=16,
            prefill_buckets=(16,), batch_buckets=(1, 2, 4), page_buckets=(8,),
            decode_steps=4)


def _engines():
    """(JaxEngine, TorchEngine) on the same tiny float32 weights."""
    jcfg, tcfg = JaxModelConfig.tiny(), ModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 jparams.items()}, tcfg, device="cpu")
    return (JaxEngine(jcfg, JaxEngineConfig(**ECFG), params=jparams),
            TorchEngine(tcfg, EngineConfig(**ECFG), params=tparams,
                        device="cpu"))


def tap(engine, store: dict) -> None:
    """Record each request's prompt and generated tokens by context id."""
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


REQUESTS = [
    ("chat-unary", "/v1/chat/completions",
     {"max_tokens": 9, "messages": [{"role": "user", "content": "hello"}]}),
    ("chat-stream", "/v1/chat/completions",
     {"max_tokens": 12, "stream": True,
      "messages": [{"role": "user", "content": "past one chunk of 16"}]}),
    ("completion", "/v1/completions",
     {"max_tokens": 7, "prompt": "Once upon a time"}),
]


async def _traffic(base: str, model: str) -> dict:
    """REQUESTS against the frontend at ``base``, all at once: per request
    id its text (streams end in [DONE])."""
    import aiohttp

    async def one(http, rid, path, body):
        async with http.post(base + path, json={"model": model, **body},
                             headers={"X-Request-Id": rid}) as r:
            assert r.status == 200, await r.text()
            if not body.get("stream"):
                c = (await r.json())["choices"][0]
                assert c["finish_reason"] == "length"
                return rid, c.get("text", (c.get("message") or {}).get(
                    "content"))
            lines = [ln.decode().strip() async for ln in r.content]
            data = [ln[6:] for ln in lines if ln.startswith("data: ")]
            assert data[-1] == "[DONE]"
            return rid, "".join(
                (c.get("delta") or {}).get("content") or ""
                for d in data[:-1] for c in json.loads(d)["choices"])

    async with aiohttp.ClientSession() as http:
        async with http.get(base + "/v1/models") as r:
            assert [m["id"] for m in (await r.json())["data"]] == [model]
        return dict(await asyncio.gather(*(one(http, *q) for q in REQUESTS)))


async def _wait_models(base: str, want: list, timeout: float = 10) -> None:
    import aiohttp

    async with aiohttp.ClientSession() as http:
        t0 = time.monotonic()
        while True:
            async with http.get(base + "/v1/models") as r:
                got = [m["id"] for m in (await r.json())["data"]]
            if got == want:
                return
            assert time.monotonic() - t0 < timeout, got
            await asyncio.sleep(0.05)


async def _check_against(seen: dict, texts: dict, engine, req_cls, stop_cls,
                         ctx_cls) -> None:
    """Every served request's tokens are ``engine``'s greedy tokens on the
    same prompt ids, and its text is their decoding. (The prompts fit
    the tiny config's 64-token page bucket.)"""
    tok = ByteTokenizer()
    assert sorted(seen) == sorted(texts)
    for rid, rec in seen.items():
        want = await _greedy(engine, req_cls, stop_cls, ctx_cls,
                             rec["prompt"], len(rec["tokens"]))
        assert rec["tokens"] == want, rid
        assert texts[rid] == tok.decode(want), rid
    assert {len(r["tokens"]) for r in seen.values()} == {9, 12, 7}


def test_port_worker_behind_reference_frontend():
    """A port worker (serve_openai_model over the tiny TorchEngine) is
    discovered by the reference's ModelWatcher and served by the
    reference's HttpService; its greedy tokens are JaxEngine's."""

    async def main():
        from dynamo_tpu.llm.http.discovery import ModelWatcher
        from dynamo_tpu.llm.http.service import HttpService
        from dynamo_tpu.runtime.runtime import DistributedRuntime as RefDrt
        from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
        from dynamo_tpu_torch.llm.worker import serve_openai_model
        from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

        jeng, teng = _engines()
        seen = {}
        tap(teng, seen)
        front = await RefDrt.detached()
        worker = await DistributedRuntime.attach(front.dcp.address)
        handle = await serve_openai_model(
            worker, ModelDeploymentCard(name="tiny"), teng,
            namespace="dynamo", stats_handler=teng.stats, model_type="both")
        service = HttpService()
        watcher = ModelWatcher(front, service.manager)
        await watcher.start()
        await service.start(host="127.0.0.1", port=0)
        try:
            texts = await _traffic(f"http://127.0.0.1:{service.port}",
                                   "tiny")
        finally:
            await service.stop()
            await watcher.stop()
            await handle.stop()
            await teng.stop()
            await worker.shutdown()
            await front.shutdown()
        try:
            await _check_against(seen, texts, jeng, JaxRequest, JaxStop,
                                 JaxContext)
        finally:
            await jeng.stop()

    asyncio.run(main())


def test_port_frontend_before_reference_worker():
    """The port's frontend (ModelWatcher + HttpService) in front of a
    reference worker serving JaxEngine: the tokens the JAX worker serves
    are the port engine's greedy tokens on the same weights, and the
    texts their decoding."""

    async def main():
        from dynamo_tpu.llm.model_card import ModelDeploymentCard as RefCard
        from dynamo_tpu.llm.worker import serve_openai_model as ref_serve
        from dynamo_tpu.runtime.runtime import DistributedRuntime as RefDrt
        from dynamo_tpu_torch.llm.http.discovery import ModelWatcher
        from dynamo_tpu_torch.llm.http.service import HttpService
        from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

        jeng, teng = _engines()
        seen = {}
        tap(jeng, seen)
        front = await DistributedRuntime.detached()
        worker = await RefDrt.attach(front.dcp.address)
        handle = await ref_serve(worker, RefCard(name="tiny"), jeng,
                                 namespace="dynamo", stats_handler=jeng.stats,
                                 model_type="both")
        service = HttpService()
        watcher = ModelWatcher(front, service.manager)
        await watcher.start()
        await service.start(host="127.0.0.1", port=0)
        try:
            texts = await _traffic(f"http://127.0.0.1:{service.port}",
                                   "tiny")
        finally:
            await service.stop()
            await watcher.stop()
            await handle.stop()
            await jeng.stop()
            await worker.shutdown()
            await front.shutdown()
        try:
            await _check_against(seen, texts, teng, PreprocessedRequest,
                                 StopConditions, Context)
        finally:
            await teng.stop()

    asyncio.run(main())


def test_discovery_and_withdrawal():
    """The reference's discovery test (tests/test_llm_layer.py) on the
    port: a worker's model appears on the frontend, streams end to end,
    leaves on an explicit remove, comes back on re-registration, and
    leaves again when the worker's lease ends; its card is on the control
    plane."""

    async def main():
        import aiohttp

        from dynamo_tpu_torch.llm.entry import (ModelEntry, list_models,
                                                register_model, remove_model)
        from dynamo_tpu_torch.llm.http.discovery import ModelWatcher
        from dynamo_tpu_torch.llm.http.service import HttpService
        from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
        from dynamo_tpu_torch.llm.worker import serve_openai_model
        from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

        _jeng, teng = _engines()
        front = await DistributedRuntime.detached()
        worker = await DistributedRuntime.attach(front.dcp.address)
        mdc = ModelDeploymentCard(name="test-model", kv_block_size=8)
        handle = await serve_openai_model(worker, mdc, teng, namespace="demo")
        service = HttpService()
        watcher = ModelWatcher(front, service.manager)
        await watcher.start()
        await service.start(host="127.0.0.1", port=0)
        base = f"http://127.0.0.1:{service.port}"
        try:
            await _wait_models(base, ["test-model"])
            card = await ModelDeploymentCard.load(front.dcp, "test-model")
            assert card.to_dict() == mdc.to_dict()
            entries = await list_models(front.dcp)
            assert [e.to_dict() for e in entries] == [{
                "name": "test-model", "endpoint":
                    "dyn://demo.test-model.generate", "model_type": "chat"}]
            body = {"model": "test-model", "stream": True, "max_tokens": 4,
                    "messages": [{"role": "user", "content": "distributed!"}]}
            async with aiohttp.ClientSession() as http:
                async with http.post(f"{base}/v1/chat/completions",
                                     json=body) as r:
                    assert r.status == 200
                    lines = [ln.decode().strip() async for ln in r.content]
                assert "data: [DONE]" in lines
                assert any(ln.startswith("data: {") for ln in lines)
                # chat only: the completions route is not registered
                async with http.post(f"{base}/v1/completions", json={
                        "model": "test-model", "prompt": "x"}) as r:
                    assert r.status == 404
            assert await remove_model(front.dcp, "test-model") is True
            await _wait_models(base, [])
            await register_model(front.dcp, entries[0],
                                 lease=worker.primary_lease)
            await _wait_models(base, ["test-model"])
            # the worker leaves: stop withdraws its instance, the lease
            # revoke deletes its model entry
            await handle.stop()
            await worker.shutdown()
            await _wait_models(base, [])
            assert await list_models(front.dcp) == []
            assert ModelEntry.from_dict(entries[0].to_dict()).address.\
                component == "test-model"
        finally:
            await service.stop()
            await watcher.stop()
            await teng.stop()
            await front.shutdown()

    asyncio.run(main())


LAUNCHER_ARGVS = [
    ["in=http", "out=dyn", "--dcp", "127.0.0.1:7000", "--http-port", "9000"],
    ["in=dyn://ns.comp.ep", "--model", "tiny", "--dcp", "h:1",
     "--namespace", "n2", "--endpoint", "dyn://a.b.c", "--max-batch-size",
     "4", "--seed", "3"],
    ["in=dyn://ns.comp", "--model", "8b", "--tensor-parallel-size", "2"],
    ["in=dyn", "--model", "tiny", "--namespace", "space"],
    ["in=none", "--model", "tiny", "--no-warmup"],
]


@pytest.mark.parametrize("argv", LAUNCHER_ARGVS,
                         ids=[a[0] for a in LAUNCHER_ARGVS])
def test_launcher_modes_parse_as_the_reference(argv):
    """The new modes and flags parse to the reference launcher's values
    (the engine is ``out=torch`` where the reference's is ``out=jax``)."""
    from dynamo_tpu.run import parse_args as ref_parse
    from dynamo_tpu_torch.run import parse_args

    out = next((a for a in argv if a.startswith("out=")), None)
    ours = parse_args(argv if out else [argv[0], "out=torch", *argv[1:]])
    theirs = ref_parse(argv if out else [argv[0], "out=jax", *argv[1:]])
    for key in ("input", "dcp", "namespace", "endpoint", "model", "seed",
                "http_port", "http_host", "max_batch_size",
                "tensor_parallel_size", "no_warmup"):
        assert getattr(ours, key) == getattr(theirs, key), key
    assert ours.output == (out[4:] if out else "torch")


def test_launcher_worker_path_and_refusals():
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.run import parse_args, worker_path

    mdc = ModelDeploymentCard(name="Meta/Llama-3.1")
    assert worker_path(parse_args(["in=dyn://a.b.c"]), mdc) == "dyn://a.b.c"
    assert worker_path(parse_args(["in=dyn://a.b.c", "--endpoint",
                                   "dyn://x.y.z"]), mdc) == "dyn://x.y.z"
    assert worker_path(parse_args(["in=dyn", "--namespace", "ns"]), mdc) == \
        "dyn://ns.meta-llama-3-1.generate"
    for argv in (["in=http", "out=jax"], ["in=dyn://a.b", "out=dyn"],
                 ["in=none", "out=dyn"], ["in=text", "out=dyn"],
                 ["in=batch:x.jsonl", "out=dyn"],
                 ["in=http", "out=dyn", "--tensor-parallel-size", "2"]):
        with pytest.raises(SystemExit):
            parse_args(argv)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launcher_processes_end_to_end(tmp_path):
    """``python -m dynamo_tpu_torch.runtime.dcp_server``, a worker
    (``in=dyn://… out=torch --model tiny --device cpu``) and a frontend
    (``in=http out=dyn``): the model appears, chat and completions answer
    (the stream ends in [DONE]), and after SIGTERM the worker prints its
    serving summary and the model leaves the frontend."""
    import urllib.request

    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
    dcp_port, http_port = _free_port(), _free_port()
    dcp = f"127.0.0.1:{dcp_port}"
    logs = {n: open(tmp_path / f"{n}.log", "w") for n in
            ("dcp", "worker", "frontend")}
    cmds = {
        "dcp": ["-m", "dynamo_tpu_torch.runtime.dcp_server", "--port",
                str(dcp_port)],
        "worker": ["-m", "dynamo_tpu_torch.run", "in=dyn://dynamo.tiny.gen",
                   "out=torch", "--model", "tiny", "--device", "cpu",
                   "--dcp", dcp, "--max-batch-size", "4"],
        "frontend": ["-m", "dynamo_tpu_torch.run", "in=http", "out=dyn",
                     "--dcp", dcp, "--http-host", "127.0.0.1",
                     "--http-port", str(http_port)],
    }
    procs = {}
    base = f"http://127.0.0.1:{http_port}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return json.loads(r.read())

    def post(path, body):
        req = urllib.request.Request(
            base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.read().decode()

    def models():
        try:
            return [m["id"] for m in get("/v1/models")["data"]]
        except OSError:
            return None

    try:
        procs["dcp"] = subprocess.Popen([sys.executable, *cmds["dcp"]],
                                        cwd=REPO, env=env, stdout=logs["dcp"],
                                        stderr=subprocess.STDOUT)
        wait_for_dcp(procs["dcp"], tmp_path / "dcp.log")
        for n in ("worker", "frontend"):
            procs[n] = subprocess.Popen([sys.executable, *cmds[n]], cwd=REPO,
                                        env=env, stdout=logs[n],
                                        stderr=subprocess.STDOUT)
        t0 = time.monotonic()
        while models() != ["tiny"]:
            assert time.monotonic() - t0 < 90, (tmp_path / "worker.log") \
                .read_text()[-2000:]
            for p in procs.values():
                assert p.poll() is None
            time.sleep(0.2)
        chat = json.loads(post("/v1/chat/completions", {
            "model": "tiny", "max_tokens": 5,
            "messages": [{"role": "user", "content": "hi"}]}))
        assert chat["choices"][0]["finish_reason"] == "length"
        comp = json.loads(post("/v1/completions", {
            "model": "tiny", "max_tokens": 3, "prompt": "abc"}))
        assert comp["choices"][0]["finish_reason"] == "length"
        stream = post("/v1/chat/completions", {
            "model": "tiny", "max_tokens": 3, "stream": True,
            "messages": [{"role": "user", "content": "hi"}]})
        assert stream.rstrip().endswith("data: [DONE]")
        procs["worker"].send_signal(signal.SIGTERM)
        assert procs["worker"].wait(timeout=30) == 0
        t0 = time.monotonic()
        while models() != []:
            assert time.monotonic() - t0 < 10
            time.sleep(0.1)
        out = (tmp_path / "worker.log").read_text()
        summary = json.loads(out.split("serving summary ", 1)[1]
                             .splitlines()[0])
        assert summary["post_warmup_compiles_total"] == 0
        assert summary["batch_dispatches_total"] > 0
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs.values():
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
        for f in logs.values():
            f.close()
