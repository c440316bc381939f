"""The port's launcher modes and flags against ``dynamo_tpu/run.py``, on
the CPU:

- ``in=batch:FILE`` with ``out=echo_core`` in both launchers (processes):
  the same per-request ``index``/``tokens_in``/``tokens_out`` lines in
  file order and the same aggregate keys;
- ``in=batch`` on the tiny preset's engine config with the same weights
  (the JAX package's seed-3 draw, bridged: the presets' random draws
  differ between the packages) through each launcher's ``run_batch``:
  the port's counts are the reference's ``out=jax`` counts; and the
  port's ``in=batch out=torch --model tiny --device cpu`` as a process:
  a line a request, the aggregate, the serving summary on stderr; and
  at ``--tensor-parallel-size 2`` (two gloo ranks), rank 0 runs the batch
  and rank 1 follows;
- ``in=text`` with piped stdin (processes): two turns, the second echoing
  the first (the history is kept), answers capped by ``--max-tokens``,
  the port's output the reference's;
- ``out=echo_full`` and user engines (``pystr:``/``pytok:`` files in
  tmp_path) over HTTP (stream and unary) and in batch mode, the Python
  engines' batch counts the reference's;
- worker mode (``in=dyn://``) serves ``echo_core`` behind the port's
  frontend and refuses an OpenAI-level engine with the reference's
  message;
- ``--context-length`` sets the card's context length as the reference's
  ``build_mdc`` does (a preset, a checkpoint directory), and the
  preprocessor holds a request to it;
- ``--profile-dir`` writes a Chrome trace of the engine's host ops on the
  CPU;
- the JAX launcher's flags of features not ported yet parse at their
  defaults and are refused at any other value.
"""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import jax
import numpy as np
import pytest

from dynamo_tpu import run as jax_run
from dynamo_tpu.engine.jax_engine import JaxEngine
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu_torch import run
from dynamo_tpu_torch.engine.torch_engine import TorchEngine
from dynamo_tpu_torch.models.bridge import params_from_numpy
from torch_dcp_wait import wait_for_dcp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = [{"text": "hello there world"}, {"prompt": "one two", "max_tokens": 3},
         {"text": "The quick brown fox jumps over the lazy dog",
          "max_tokens": 9}]
PYSTR = '''
async def generate(request, context):
    text = request["messages"][-1]["content"]
    base = {"id": "u", "object": "chat.completion.chunk", "created": 0,
            "model": request["model"]}
    for w in text.split():
        yield {**base, "choices": [{"index": 0, "finish_reason": None,
                                    "delta": {"content": w.upper() + " "}}]}
    yield {**base, "choices": [{"index": 0, "delta": {},
                                "finish_reason": "stop"}]}
'''
PYTOK = '''
async def generate(request, context):
    n = request["stop"].get("max_tokens") or 4
    for t in request["token_ids"][-n:]:
        yield {"token_ids": [t]}
    yield {"token_ids": [], "finish_reason": "length"}
'''


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return env


def _launch(module: str, argv: list, stdin: str = "",
            timeout: float = 240) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO,
                          env=_env(), input=stdin, capture_output=True,
                          text=True, timeout=timeout)


def _jsonl(path, rows) -> str:
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(path)


def _lines(stdout: str) -> tuple:
    """(the per-request lines, the aggregate) of a batch run's output."""
    rows = [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]
    return rows[:-1], rows[-1]["aggregate"]


def _counts(rows) -> list:
    return [(r["index"], r["tokens_in"], r["tokens_out"]) for r in rows]


def test_batch_echo_core_matches_reference(tmp_path):
    """Both launchers' ``in=batch:FILE out=echo_core``: a line a request in
    file order with equal counts, then the aggregate with the same keys
    (``tokens_in`` counts the prompt's words, ``tokens_out`` the stream's
    chunks that carried text)."""
    path = _jsonl(tmp_path / "b.jsonl", BATCH)
    argv = [f"in=batch:{path}", "out=echo_core", "--max-tokens", "16"]
    ours, ref = _launch("dynamo_tpu_torch.run", argv), \
        _launch("dynamo_tpu.run", argv)
    assert ours.returncode == 0, ours.stderr[-3000:]
    assert ref.returncode == 0, ref.stderr[-3000:]
    (rows, agg), (rrows, ragg) = _lines(ours.stdout), _lines(ref.stdout)
    assert _counts(rows) == _counts(rrows)
    assert [r["index"] for r in rows] == [0, 1, 2]
    assert [r["tokens_in"] for r in rows] == [3, 2, 9]
    assert set(rows[0]) == set(rrows[0])
    assert set(agg) == set(ragg) == {"requests", "wall_s",
                                     "output_tok_per_s"}
    assert agg["requests"] == 3
    assert "serving summary" not in ours.stdout


def _same_weight_engines(monkeypatch, args, jargs):
    """Both launchers' build_engine patched to the tiny preset's config
    and engine config (each launcher's own) on the same weights."""
    cfg, ecfg, _, _, _ = jax_run._jax_engine_setup(jargs)
    jparams = jax_init_params(cfg, jax.random.PRNGKey(3))
    tcfg = run.build_model_config(args)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 jparams.items()}, tcfg, device="cpu")

    def jax_build(a):
        mdc = jax_run.build_mdc(a)
        mdc.kv_block_size = ecfg.page_size
        return JaxEngine(cfg, ecfg, params=jparams), mdc, False

    def port_build(a):
        mdc = run.build_mdc(a)
        mdc.kv_block_size = ecfg.page_size
        return TorchEngine(tcfg, run.build_engine_config(a), params=tparams,
                           device="cpu"), mdc, False

    monkeypatch.setattr(jax_run, "build_engine", jax_build)
    monkeypatch.setattr(run, "build_engine", port_build)


def test_batch_torch_counts_match_jax_launcher(tmp_path, monkeypatch,
                                               capsys):
    """``in=batch`` on the tiny preset (float32, the same weights in both
    launchers): the port's per-request counts and aggregate keys are the
    JAX launcher's ``out=jax``; then the port's launcher as a process
    (``--model tiny --device cpu``, its own seed-0 weights): a line a
    request, the aggregate, and the serving summary on stderr with no
    capture after warmup."""
    path = _jsonl(tmp_path / "b.jsonl", BATCH)
    argv = ["--model", "tiny", "--max-tokens", "12"]
    args = run.parse_args([f"in=batch:{path}", "out=torch", *argv,
                           "--device", "cpu"])
    jargs = jax_run.parse_args([f"in=batch:{path}", "out=jax", *argv])
    _same_weight_engines(monkeypatch, args, jargs)
    asyncio.run(jax_run.run_batch(jargs, path))
    want = _lines(capsys.readouterr().out)
    asyncio.run(run.run_batch(args, path))
    got = _lines(capsys.readouterr().out)
    assert _counts(got[0]) == _counts(want[0])
    assert all(0 < r["tokens_out"] <= 12 for r in got[0])
    assert set(got[1]) == set(want[1])
    proc = _launch("dynamo_tpu_torch.run", [f"in=batch:{path}", "out=torch",
                                            *argv, "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows, agg = _lines(proc.stdout)
    assert [r["index"] for r in rows] == [0, 1, 2]
    assert [r["tokens_in"] for r in rows] == [3, 2, 9]
    assert agg["requests"] == 3
    summary = json.loads(proc.stderr.split("serving summary ", 1)[1]
                         .splitlines()[0])
    assert summary["post_warmup_compiles_total"] == 0
    assert summary["batch_dispatches_total"] > 0


def test_batch_at_tensor_parallel_two(tmp_path):
    """``in=batch`` with ``--tensor-parallel-size 2`` (the one-command
    form, two gloo ranks on the CPU), as ``in=http`` runs at tp=2: rank 0
    runs the batch and rank 1 follows; standard output holds only the
    request lines and the aggregate, standard error both ranks' serving
    summaries, at mesh model=2 with the same dispatches and no capture
    after warmup."""
    path = _jsonl(tmp_path / "b.jsonl", BATCH[:2])
    proc = _launch("dynamo_tpu_torch.run", [
        f"in=batch:{path}", "out=torch", "--model", "tiny", "--device", "cpu",
        "--tensor-parallel-size", "2", "--max-tokens", "6"])
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = proc.stdout.splitlines()
    assert all(ln.startswith("{") for ln in out if ln.strip()), out
    rows, agg = _lines(proc.stdout)
    assert [r["index"] for r in rows] == [0, 1] and agg["requests"] == 2
    summaries = sorted((json.loads(ln.split("serving summary ", 1)[1])
                        for ln in proc.stderr.splitlines()
                        if "serving summary " in ln), key=lambda s: s["rank"])
    assert [s["rank"] for s in summaries] == [0, 1], proc.stderr[-3000:]
    assert {s["mesh_shape"] for s in summaries} == {"model=2"}
    assert summaries[0]["batch_dispatches_total"] == \
        summaries[1]["batch_dispatches_total"] > 0
    assert [s["post_warmup_compiles_total"] for s in summaries] == [0, 0]


def test_text_mode_keeps_history_and_caps_tokens():
    """``in=text out=echo_core`` with two piped turns: the second turn's
    echo (the start of its prompt) holds the first turn, so the history
    is kept; every answer is at most ``--max-tokens`` bytes (the byte
    tokenizer); the port's output is the reference's, and a larger cap
    gives longer answers."""
    turns = "hello\nsecond turn\n\n"
    outs = {}
    for cap in ("24", "200"):
        argv = ["in=text", "out=echo_core", "--max-tokens", cap]
        ours = _launch("dynamo_tpu_torch.run", argv, stdin=turns)
        ref = _launch("dynamo_tpu.run", argv, stdin=turns)
        assert ours.returncode == 0, ours.stderr[-3000:]
        assert ours.stdout == ref.stdout
        answers = ours.stdout.split("> ")[1:]
        assert len(answers) == 3  # two answers, then the empty line
        outs[cap] = [a.rstrip("\n") for a in answers[:2]]
    first, second = outs["200"]
    assert "hello" in first and "second turn" not in first
    assert "hello" in second and "second turn" in second
    assert all(len(a.encode()) <= 24 for a in outs["24"])
    assert len(outs["200"][1]) > len(outs["24"][1])


async def _http_chat(engine, mdc, full: bool) -> tuple:
    """A streamed and a unary chat request to a local service over the
    engine: (the stream's text, its last data line, the unary text, the
    completions endpoint's status)."""
    import aiohttp

    svc = await run.serve_http(engine, mdc, "127.0.0.1", 0, full)
    base = f"http://127.0.0.1:{svc.port}"
    body = {"model": mdc.name, "max_tokens": 5,
            "messages": [{"role": "user", "content": "alpha beta gamma"}]}
    try:
        async with aiohttp.ClientSession() as s:
            async with s.post(f"{base}/v1/chat/completions",
                              json={**body, "stream": True}) as r:
                assert r.status == 200, await r.text()
                lines = [ln.decode().strip() async for ln in r.content]
            data = [ln[6:] for ln in lines if ln.startswith("data: ")]
            text = "".join(c["delta"].get("content") or ""
                           for d in data[:-1]
                           for c in json.loads(d)["choices"])
            async with s.post(f"{base}/v1/chat/completions", json=body) as r:
                assert r.status == 200, await r.text()
                unary = (await r.json())["choices"][0]["message"]["content"]
            async with s.post(f"{base}/v1/completions", json={
                    "model": mdc.name, "prompt": "abc",
                    "max_tokens": 2}) as r:
                comp = r.status
    finally:
        await svc.stop()
    return text, data[-1], unary, comp


@pytest.mark.parametrize("out", ["echo_full", "pystr", "pytok"])
def test_full_and_python_engines_over_http_and_batch(out, tmp_path, capsys):
    """``out=echo_full`` and the user engines over HTTP: the stream ends
    in [DONE] and its text is the unary answer's; the OpenAI-level
    engines serve chat only (completions 404), the token-level one both;
    then in batch mode a line a request, the Python engines' counts the
    reference launcher's on the same files."""
    files = {"pystr": PYSTR, "pytok": PYTOK}
    spec = out
    if out in files:
        (tmp_path / f"{out}.py").write_text(files[out])
        spec = f"{out}:{tmp_path / (out + '.py')}"
    engine, mdc, full = run.build_engine(run.parse_args([f"out={spec}"]))
    assert full == (out != "pytok")
    text, last, unary, comp = asyncio.run(_http_chat(engine, mdc, full))
    assert last == "[DONE]" and text == unary
    want = {"echo_full": "alpha beta gamma ",
            "pystr": "ALPHA BETA GAMMA "}.get(out)
    if want is not None:
        assert text == want
    else:
        assert 0 < len(text.encode()) <= 5
    assert comp == (404 if full else 200)
    path = _jsonl(tmp_path / "b.jsonl", BATCH)
    args = run.parse_args([f"in=batch:{path}", f"out={spec}"])
    asyncio.run(run.run_batch(args, path))
    rows, agg = _lines(capsys.readouterr().out)
    assert len(rows) == 3 and agg["requests"] == 3
    assert all(r["tokens_out"] > 0 for r in rows)
    if out in files:
        jargs = jax_run.parse_args([f"in=batch:{path}", f"out={spec}"])
        asyncio.run(jax_run.run_batch(jargs, path))
        assert _counts(rows) == _counts(_lines(capsys.readouterr().out)[0])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_worker_serves_echo_core_and_refuses_full_level(tmp_path):
    """An OpenAI-level engine (``echo_full``, ``pystr:``) is refused in
    worker mode with the reference's message; ``in=dyn://… out=echo_core``
    registers behind the port's frontend and answers a chat with the
    echo of its prompt, and SIGTERM withdraws it."""
    (tmp_path / "u.py").write_text(PYSTR)
    for out in ("echo_full", f"pystr:{tmp_path / 'u.py'}"):
        args = run.parse_args(["in=dyn://a.b.c", f"out={out}"])
        with pytest.raises(SystemExit, match="worker mode needs a "
                                             "token-level engine"):
            asyncio.run(run.run_worker(args))
    dcp, http = _free_port(), _free_port()
    cmds = {"dcp": ["-m", "dynamo_tpu_torch.runtime.dcp_server", "--port",
                    str(dcp)],
            "worker": ["-m", "dynamo_tpu_torch.run", "in=dyn://dynamo.echo.gen",
                       "out=echo_core", "--dcp", f"127.0.0.1:{dcp}"],
            "frontend": ["-m", "dynamo_tpu_torch.run", "in=http", "out=dyn",
                         "--dcp", f"127.0.0.1:{dcp}", "--http-host",
                         "127.0.0.1", "--http-port", str(http)]}
    base = f"http://127.0.0.1:{http}"
    procs = {}

    def models():
        try:
            with urllib.request.urlopen(base + "/v1/models", timeout=5) as r:
                return [m["id"] for m in json.loads(r.read())["data"]]
        except OSError:
            return None

    try:
        for name, cmd in cmds.items():
            procs[name] = subprocess.Popen(
                [sys.executable, *cmd], cwd=REPO, env=_env(),
                stdout=open(tmp_path / f"{name}.log", "w"),
                stderr=subprocess.STDOUT)
            if name == "dcp":
                wait_for_dcp(procs["dcp"], tmp_path / "dcp.log")
        t0 = time.monotonic()
        while models() != ["echo"]:
            assert time.monotonic() - t0 < 60, \
                (tmp_path / "worker.log").read_text()[-2000:]
            time.sleep(0.2)
        req = urllib.request.Request(
            base + "/v1/chat/completions", data=json.dumps({
                "model": "echo", "max_tokens": 64,
                "messages": [{"role": "user", "content": "ping"}]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            answer = json.loads(r.read())["choices"][0]["message"]["content"]
        assert "ping" in answer
        procs["worker"].send_signal(signal.SIGTERM)
        assert procs["worker"].wait(timeout=30) == 0
        t0 = time.monotonic()
        while models() != []:
            assert time.monotonic() - t0 < 15
            time.sleep(0.1)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()


def test_context_length_sets_the_card_as_the_reference(tmp_path):
    """``--context-length`` overrides the card's context length (a
    preset's default 8192, a checkpoint's ``max_position_embeddings``) as
    the reference's ``build_mdc`` does, for every engine; the
    preprocessor refuses a prompt that does not fit it."""
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest

    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "llama", "vocab_size": 512, "hidden_size": 64,
         "intermediate_size": 128, "num_hidden_layers": 2,
         "num_attention_heads": 4, "max_position_embeddings": 256}))
    for extra in ([], ["--model-path", str(tmp_path)]):
        for flag in ([], ["--context-length", "4096"], ["--context-length",
                                                        "40"]):
            for out, jout in (("torch", "jax"), ("echo_core", "echo_core")):
                ours = run.build_mdc(run.parse_args(
                    ["in=http", f"out={out}", *extra, *flag]))
                ref = jax_run.build_mdc(jax_run.parse_args(
                    ["in=http", f"out={jout}", *extra, *flag]))
                assert ours.context_length == ref.context_length
                assert ours.name == ref.name or out == "torch"
    mdc = run.build_mdc(run.parse_args(["in=http", "out=echo_core",
                                        "--context-length", "40"]))
    assert mdc.context_length == 40
    pre = OpenAIPreprocessor(mdc)
    with pytest.raises(ValueError, match="context length"):
        pre.preprocess_chat(ChatCompletionRequest(
            model="echo", messages=[{"role": "user", "content": "x" * 64}]))


def test_profile_dir_writes_a_trace_on_the_cpu(tmp_path, monkeypatch):
    """``--profile-dir`` (and ``DYN_PROFILE_DIR`` as its default) around a
    batch on the tiny engine on the CPU: a Chrome trace of the process,
    the engine threads' host ops in it, written when the run ends."""
    path = _jsonl(tmp_path / "b.jsonl", BATCH[:1])
    prof = tmp_path / "prof"
    proc = _launch("dynamo_tpu_torch.run", [
        f"in=batch:{path}", "out=torch", "--model", "tiny", "--device",
        "cpu", "--no-warmup", "--max-tokens", "4", "--profile-dir",
        str(prof)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    trace = json.loads((prof / "rank0.pt.trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"aten::mm", "aten::index_select"} & names, sorted(names)[:40]
    assert run.parse_args(["in=http"]).profile_dir is None
    monkeypatch.setenv("DYN_PROFILE_DIR", str(tmp_path / "env"))
    assert run.parse_args(["in=http"]).profile_dir == str(tmp_path / "env")


NOT_PORTED = [("--sequence-parallel-size", "2", "--sequence-parallel-size"),
              ("--long-prefill-threshold", "4096", "--long-prefill-threshold"),
              ("--mesh-shape", "model=2", "--mesh-shape"),
              ("--dp-replicas", "2", "--dp-replicas")]


def test_model_id_resolves_a_local_directory(tmp_path):
    """``--model-id`` is ported (``models/hub.py``): a local directory
    resolves to itself and is served as ``--model-path``, named after the
    id unless ``--model-name`` names it, as the JAX launcher does."""
    args = run.parse_args(["in=http", "--model-id", str(tmp_path)])
    ref = jax_run.parse_args(["in=http", "--model-id", str(tmp_path)])
    assert (args.model_path, args.model_name) == \
        (ref.model_path, ref.model_name) == (str(tmp_path), str(tmp_path))
    args = run.parse_args(["in=http", "--model-id", str(tmp_path),
                           "--model-name", "m"])
    assert (args.model_path, args.model_name) == (str(tmp_path), "m")


@pytest.mark.parametrize("flag,value,named", NOT_PORTED,
                         ids=[f for f, _, _ in NOT_PORTED])
def test_flags_of_unported_features_refused_off_their_default(
        flag, value, named, capsys):
    """Each JAX-launcher flag of a feature not ported yet parses at its
    default (1 or None, as the reference's command lines pass it) and
    exits naming what is missing at any other value."""
    default = {"--sequence-parallel-size": "1", "--dp-replicas": "1"}
    if flag in default:
        args = run.parse_args(["in=http", flag, default[flag]])
        assert getattr(args, flag[2:].replace("-", "_")) == 1
    with pytest.raises(SystemExit):
        run.parse_args(["in=http", flag, value])
    assert named in capsys.readouterr().err
