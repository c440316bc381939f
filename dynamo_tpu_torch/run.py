"""Launcher for the PyTorch port: ``in=… out=…``.

    python -m dynamo_tpu_torch.run in=http out=torch --model-path DIR
    python -m dynamo_tpu_torch.run in=http out=torch --model 8b
    python -m dynamo_tpu_torch.run in=http out=torch --model 8b --dtype int8
    python -m dynamo_tpu_torch.run in=http out=torch --model tiny --device cpu
    python -m dynamo_tpu_torch.run in=dyn://ns.comp.generate out=torch \
        --model 8b --dcp 127.0.0.1:6650                          # worker
    python -m dynamo_tpu_torch.run in=http out=dyn --dcp 127.0.0.1:6650
    python -m dynamo_tpu_torch.run in=none out=torch --model tiny
    python -m dynamo_tpu_torch.run in=text out=echo_core
    python -m dynamo_tpu_torch.run in=batch:prompts.jsonl out=torch \
        --model 8b --max-tokens 32 --profile-dir /tmp/trace

Inputs, as the JAX launcher names them:

- ``in=http``: the OpenAI HTTP front end (chat + completions + models +
  health). With an engine (``out=torch``, an echo or a Python engine) it
  serves it locally; with ``out=dyn`` it is the standalone frontend: it
  runs no engine and no device, and serves the models that workers
  register on the control plane (``llm/http/discovery.py
  ModelWatcher``).
- ``in=text``: a chat loop over standard input, the conversation's
  history kept, each answer capped at ``--max-tokens``; an empty line or
  end of input ends it.
- ``in=batch:FILE``: the benchmark mode. FILE holds one JSON object a
  line, ``{"text"|"prompt": ..., "max_tokens"?: N}`` (``--max-tokens``
  where it has none); every request is sent at once, and one JSON line a
  request is printed (``index``, ``tokens_in``: the prompt's words,
  ``tokens_out``: the stream's chunks that carried text, ``elapsed_ms``),
  then ``{"aggregate": {"requests", "wall_s", "output_tok_per_s"}}``.
- ``in=dyn://namespace.component[.endpoint]``: worker mode. The engine is
  built and warmed first, then the process attaches to the control plane
  (``--dcp``, else ``DYN_DCP_ADDRESS``, else an embedded server) and
  serves the model behind ``OpenAIPreprocessor -> Backend -> engine`` at
  that endpoint, registered for discovery under its lease
  (``llm/worker.py serve_openai_model``). ``--endpoint PATH`` overrides
  the path; a bare ``in=dyn`` serves at
  ``dyn://<--namespace>.<model slug>.generate``. SIGTERM drains
  (``runtime/revive.py drain_worker``): the discovery record goes first,
  the in-flight streams finish within ``DYN_DRAIN_TIMEOUT_MS``, then the
  endpoint stops; SIGINT stops the endpoint at once. Then the engine
  stops and the lease is revoked (its model entry goes).
- ``in=none``: build and warm the engine, then idle until a signal.

Engines (``out=``):

- ``torch``: :class:`~dynamo_tpu_torch.engine.torch_engine.TorchEngine`
  on the card (``--device cpu`` runs it on the CPU), below;
- ``echo_core``: echoes the prompt's tokens, token level behind the
  Backend (``engine/echo.py``); ``echo_full``: echoes the last user
  message's words at the OpenAI level. Neither needs a device;
- ``pystr:FILE`` and ``pytok:FILE``: a user engine, a Python file that
  defines ``async def generate(request, context)``, an async generator.
  ``pystr`` is OpenAI level: it gets the chat request as a dict and
  yields OpenAI chat chunk dicts, which go straight to the HTTP chain.
  ``pytok`` is token level, behind the preprocessor and the Backend: it
  gets the preprocessed request as a dict (``token_ids``, ``stop``,
  ``sampling``, ...) and yields ``EngineOutput`` dicts (``token_ids``,
  ``finish_reason``, ...).

A worker (``in=dyn://``) needs a token-level engine: ``torch``,
``echo_core`` or ``pytok:``. Every engine takes ``--context-length N``,
which sets the model card's context length (the preprocessor refuses a
prompt that does not fit it and caps ``max_tokens`` to what is left).

``--profile-dir DIR`` (default ``DYN_PROFILE_DIR``) traces the process
with ``torch.profiler`` (host ops, and the card's kernels and copies
when it runs on one) from the start of the mode to its end, warmup
included, and writes a Chrome trace per rank into DIR
(``rank<r>.pt.trace.json``). The profiler keeps every event in host
memory until the process ends: over a long HTTP session that grows
without bound.

The engine (``out=torch``) is :class:`~dynamo_tpu_torch.engine.
torch_engine.TorchEngine`. With
``--model-path``, a local HF-style dense checkpoint (``config.json`` and
safetensors, one file or shards with their index): its config, the
default ``EngineConfig()``, its weights (``models/loader.py``; each
tensor-parallel rank loads its own shard) and its card, with the HF
tokenizer when ``tokenizer.json`` or ``tokenizer_config.json`` is there
and the byte tokenizer otherwise. A path with no weights is an error:
random weights are never served under a checkpoint's name. Without it,
a ``--model`` preset with random weights drawn from ``--seed`` and the
byte tokenizer. ``--dtype int8`` serves weight-only int8 projections
(``models/quant.py``, the int8 GEMM kernel) at every
``--tensor-parallel-size``, for random weights and for ``--model-path``
(quantized on the device at load). ``--kv-cache-block-size``,
``--num-pages`` and ``--max-batch-size`` override the engine config as
the JAX launcher maps them (page size, with the prefill chunk kept a
multiple of it; pages; batch rows); a smaller batch also warms fewer
decode graphs. ``--prefill-token-budget N`` (budgeted prefill mixing),
``--spec-decode`` and ``--spec-tokens K`` (self-speculative decoding)
set the engine's scheduler arms as the JAX launcher sets them.

Tensor parallel, under the JAX launcher's flag names
(``--tensor-parallel-size``, ``--coordinator``, ``--num-processes``,
``--process-id``), one process per rank:

    # every process runs the same command with its own --process-id
    python -m dynamo_tpu_torch.run in=http out=torch --model 8b \
        --tensor-parallel-size 2 --coordinator 127.0.0.1:29500 \
        --num-processes 2 --process-id 0      # and --process-id 1
    # or one command, which starts ranks 1..N-1 on this host itself
    python -m dynamo_tpu_torch.run in=http out=torch --model 8b \
        --tensor-parallel-size 2

Process 0 serves (HTTP, the text loop, the batch, or the worker
endpoint: only rank 0 attaches to the control plane) and schedules; the
others follow its dispatches
(``TorchEngine.follow``). Rank r runs on ``cuda:{r % device_count}``.
Where two ranks share a card, NCCL must see them as two hosts (it
refuses two ranks of one communicator on one device): each rank then
needs its own ``NCCL_HOSTID`` and ``NCCL_SOCKET_IFNAME=lo``, which the
one-command form sets itself (:func:`shared_device_env`). Every rank
prints one ``serving summary`` JSON line when it ends: its capture count
after warmup and its kernel launches (int8 GEMM calls by route) and
graph replays since warmup (in ``in=text`` and ``in=batch`` to standard
error, where it stays out of the mode's output).

``--model-id ID`` resolves a model id to a local checkpoint
(``models/hub.py``: a local directory as is, else the HuggingFace cache,
then the hub) and serves it as ``--model-path`` would, named after the
id unless ``--model-name`` is given. ``in=http`` over a local engine
wires the service's admission control to the engine's own load signals
(``runtime/revive.py``; it sheds nothing until ``DYN_SHED_*`` is set) and
``POST /drain`` to the engine's ``drain()`` (``DYN_DRAIN_TIMEOUT_MS``).

The JAX launcher's flags of features not ported yet are parsed, so its
command lines run unchanged, and refused at any value but their default:
``--sequence-parallel-size``, ``--long-prefill-threshold``,
``--mesh-shape`` and ``--dp-replicas`` (sequence parallelism and replica
sets).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import resource
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Tuple

log = logging.getLogger("dynamo_tpu_torch.run")
# when this module was imported: the start of a rank's engine-ready clock
_T0 = time.monotonic()


# the engines of out=: the device engine, the echo engines, and the user
# Python engines (a prefix and a file)
ENGINES = ("torch", "echo_core", "echo_full")
PY_ENGINES = ("pystr:", "pytok:")
# the JAX launcher's flags of features not ported yet: (flag, its default,
# what is missing). Each parses, and any other value than the default
# exits naming what is missing
NOT_PORTED = (
    ("sequence_parallel_size", 1, "--sequence-parallel-size (the seq mesh "
     "axis and ring-attention prefill) is not ported"),
    ("long_prefill_threshold", None, "--long-prefill-threshold (the ring-"
     "attention prefill of long prompts) is not ported"),
    ("mesh_shape", None, "--mesh-shape (replica sets on submeshes) is not "
     "ported: use --tensor-parallel-size"),
    ("dp_replicas", 1, "--dp-replicas (data-parallel replica sets) is not "
     "ported"),
)


def is_engine(output: str) -> bool:
    return output in ENGINES or output.startswith(PY_ENGINES)


def parse_args(argv=None):
    from .runtime.config import env_int, env_str

    ap = argparse.ArgumentParser(
        prog="dynamo_tpu_torch.run",
        usage="%(prog)s in=<http|text|batch:FILE|dyn://…|none> "
              "out=<torch|echo_core|echo_full|pystr:FILE|pytok:FILE|dyn> "
              "[flags]")
    ap.add_argument("io", nargs="*", help="in=… and out=… positionals")
    ap.add_argument("--model-path",
                    help="local HF-style checkpoint directory (config.json "
                         "+ safetensors) to serve")
    ap.add_argument("--model-id", default=None,
                    help="HuggingFace model id or local directory, "
                         "resolved to a checkpoint directory (local "
                         "cache first, then the hub) and served as "
                         "--model-path")
    ap.add_argument("--model-name", help="served model name")
    ap.add_argument("--model", default=None,
                    help="preset: tiny (default), 1b or 8b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--http-host", default="0.0.0.0")
    ap.add_argument("--http-port", type=int, default=8080)
    ap.add_argument("--dcp", default=None, help="control-plane address "
                    "(default: DYN_DCP_ADDRESS or embedded)")
    ap.add_argument("--namespace", default="dynamo",
                    help="namespace of a bare in=dyn worker's endpoint")
    ap.add_argument("--endpoint", default=None,
                    help="override dyn:// endpoint path")
    ap.add_argument("--context-length", type=int, default=None,
                    help="the model card's context length: the longest "
                         "prompt plus output a request may have")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--kv-cache-block-size", type=int, default=None,
                    help="tokens per KV page (the JAX launcher's flag)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="KV pages in the pool")
    ap.add_argument("--max-batch-size", type=int, default=None,
                    help="most requests the engine serves at once")
    ap.add_argument("--spec-decode", action="store_true",
                    help="self-speculative decoding: prompt-lookup drafts "
                         "verified in one [B, K+1] forward; greedy rows "
                         "only (token-identical), others bypass")
    ap.add_argument("--spec-tokens", type=int, default=4,
                    help="most draft tokens verified a step (K)")
    ap.add_argument("--prefill-token-budget", type=int, default=None,
                    help="cap the prompt tokens prefilled an engine "
                         "iteration and dispatch a decode window beside "
                         "them (budgeted prefill mixing)")
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "int8"],
                    help="int8 = weight-only int8 serving (models/quant.py, "
                         "the int8 GEMM kernel): random weights quantized "
                         "as drawn, checkpoints on the device at load; "
                         "half the weight bytes of bf16")
    ap.add_argument("--tensor-parallel-size", type=int, default=1,
                    help="ranks of the model axis (Megatron tensor "
                         "parallel), one process each")
    ap.add_argument("--sequence-parallel-size", type=int, default=1,
                    help="the seq mesh axis (the JAX launcher's flag; not "
                         "ported: only 1)")
    ap.add_argument("--mesh-shape", default=env_str("DYN_MESH_SHAPE"),
                    help="a replica's mesh as axis=N pairs (the JAX "
                         "launcher's flag; not ported: refused)")
    ap.add_argument("--dp-replicas", type=int,
                    default=env_int("DYN_DP_REPLICAS") or 1,
                    help="data-parallel engine replicas (the JAX "
                         "launcher's flag; not ported: only 1)")
    ap.add_argument("--long-prefill-threshold", type=int, default=None,
                    help="ring prefill above this prompt length (the JAX "
                         "launcher's flag; not ported: refused)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0's rendezvous; every "
                         "process passes the same value (without it, "
                         "--tensor-parallel-size N starts ranks 1..N-1 "
                         "on this host)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--max-tokens", type=int, default=128,
                    help="in=text and in=batch: the most tokens an answer "
                         "has (a batch line's max_tokens wins)")
    ap.add_argument("--profile-dir", default=env_str("DYN_PROFILE_DIR"),
                    help="trace the process with torch.profiler from the "
                         "start of the mode to its end and write a Chrome "
                         "trace per rank into this directory; the "
                         "profiler holds every event in host memory until "
                         "then, so a long HTTP session grows without "
                         "bound")
    args = ap.parse_args(argv)
    args.input, args.output = "http", "torch"
    for tok in args.io:
        if tok.startswith("in="):
            args.input = tok[3:]
        elif tok.startswith("out="):
            args.output = tok[4:]
        else:
            ap.error(f"positional args must be in=…/out=…, got {tok!r}")
    for key, default, what in NOT_PORTED:
        if getattr(args, key) != default:
            ap.error(what)
    if args.model_id and not args.model_path:
        from .models.hub import resolve_model

        args.model_path = resolve_model(args.model_id)
        if not args.model_name:
            args.model_name = args.model_id
    front = args.output == "dyn" or args.output.startswith("dyn://")
    if not (front or is_engine(args.output)):
        ap.error(f"unknown out={args.output!r}: this launcher takes "
                 f"out=torch, echo_core, echo_full, pystr:FILE, "
                 f"pytok:FILE and dyn")
    if not (args.input in ("http", "text", "none", "dyn")
            or args.input.startswith(("batch:", "dyn://"))):
        ap.error(f"unknown in={args.input!r}: this launcher takes in=http, "
                 f"in=text, in=batch:FILE, in=dyn://… and in=none")
    if front and args.input != "http":
        ap.error(f"in={args.input} needs an engine (out=torch, echo_core, "
                 f"echo_full, pystr:FILE or pytok:FILE), not "
                 f"out={args.output}")
    tp = args.tensor_parallel_size
    if tp != 1 and args.output != "torch":
        ap.error(f"out={args.output} runs no model: --tensor-parallel-size "
                 f"needs out=torch")
    if tp < 1:
        ap.error("--tensor-parallel-size must be >= 1")
    if args.coordinator and args.num_processes != tp:
        ap.error(f"--num-processes ({args.num_processes}) must equal "
                 f"--tensor-parallel-size ({tp}): one process per rank")
    if not args.coordinator and (args.num_processes != 1
                                 or args.process_id != 0):
        ap.error("--num-processes/--process-id need --coordinator")
    if not 0 <= args.process_id < args.num_processes:
        ap.error(f"--process-id {args.process_id} outside "
                 f"[0, {args.num_processes})")
    return args


def build_model_config(args):
    from .models.config import ModelConfig

    if args.model_path:
        return ModelConfig.from_local_path(args.model_path)
    preset = args.model or "tiny"
    if preset == "tiny":
        return ModelConfig.tiny()
    if preset == "1b":
        return ModelConfig.llama_1b()
    if preset == "8b":
        return ModelConfig.llama3_8b()
    raise SystemExit(f"unknown --model preset {preset!r}")


def build_engine_config(args):
    """The engine config the JAX launcher builds for these arguments
    (``dynamo_tpu/run.py`` ``_jax_engine_setup``): its tiny-model config
    or the default, then ``--kv-cache-block-size`` (the prefill chunk
    rounded down to a multiple of it, at least one page),
    ``--num-pages``, ``--max-batch-size``, ``--prefill-token-budget``
    and ``--spec-decode`` with ``--spec-tokens``, checked as a direct
    construction is."""
    import dataclasses

    from .engine.torch_engine import EngineConfig

    ecfg = EngineConfig()
    if not args.model_path and args.model in (None, "tiny"):
        # the JAX launcher's tiny-model engine config
        ecfg = EngineConfig(page_size=16, num_pages=256, max_batch=16,
                            prefill_chunk=128, prefill_buckets=(128,),
                            batch_buckets=(4, 16), page_buckets=(16,))
    overrides = {}
    if args.kv_cache_block_size:
        overrides["page_size"] = args.kv_cache_block_size
        overrides["prefill_chunk"] = max(
            ecfg.prefill_chunk // args.kv_cache_block_size, 1
        ) * args.kv_cache_block_size
    if args.num_pages:
        overrides["num_pages"] = args.num_pages
    if args.max_batch_size:
        overrides["max_batch"] = args.max_batch_size
    if args.prefill_token_budget is not None:
        overrides["prefill_token_budget"] = args.prefill_token_budget
    if args.spec_decode:
        overrides["spec_decode"] = True
        overrides["spec_tokens"] = args.spec_tokens
    return dataclasses.replace(ecfg, **overrides) if overrides else ecfg


def peak_rss_gib() -> float:
    """This process's peak resident set (GiB): ``VmHWM`` of
    /proc/self/status, else ``ru_maxrss``. Some container runtimes
    report one figure for every process of the container."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 2**20
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def build_mdc(args):
    """The model card of the arguments, as the JAX launcher's
    ``build_mdc`` makes it: the checkpoint's card, else one named by
    ``--model-name``, else the preset (an engine that runs no model:
    "echo"); ``--context-length`` and ``--kv-cache-block-size`` set its
    context length and page size."""
    from .llm.model_card import ModelDeploymentCard

    if args.model_path:
        mdc = ModelDeploymentCard.from_local_path(args.model_path,
                                                  name=args.model_name)
    else:
        mdc = ModelDeploymentCard(name=args.model_name or args.model or (
            "tiny" if args.output == "torch" else "echo"))
    if args.context_length:
        mdc.context_length = args.context_length
    if args.kv_cache_block_size:
        mdc.kv_block_size = args.kv_cache_block_size
    return mdc


def build_engine(args) -> Tuple[object, object, bool]:
    """(engine, model card, whether the engine is OpenAI level) for the
    parsed arguments, as the JAX launcher's ``build_engine``: a token-level
    engine goes behind the preprocessor and the Backend, an OpenAI-level
    one (``echo_full``, ``pystr:``) straight to the HTTP chain."""
    from .engine.echo import EchoEngineCore, EchoEngineFull

    if args.output == "torch":
        engine, mdc = build_torch_engine(args)
        return engine, mdc, False
    mdc = build_mdc(args)
    if args.output == "echo_core":
        return EchoEngineCore(), mdc, False
    if args.output == "echo_full":
        return EchoEngineFull(), mdc, True
    kind, path = args.output.split(":", 1)
    return load_python_engine(path, kind), mdc, kind == "pystr"


def load_python_engine(path: str, kind: str):
    """A user engine file (``pystr:FILE`` / ``pytok:FILE``, the JAX
    launcher's ``_load_python_engine``): the module must define ``async
    def generate(request, context)``, an async generator. ``pystr`` gets
    the OpenAI request as a dict and yields OpenAI chunk dicts; ``pytok``
    gets the preprocessed request as a dict and yields EngineOutput dicts
    (or EngineOutputs)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("dyn_user_engine", path)
    if spec is None or spec.loader is None:
        raise SystemExit(f"cannot load python engine from {path!r}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    gen = getattr(mod, "generate", None)
    if gen is None:
        raise SystemExit(f"{path} must define `async def generate(request, "
                         f"context)`")
    if kind == "pystr":
        return PyStrEngine(gen)
    return PyTokEngine(gen)


class PyStrEngine:
    """An OpenAI-level user engine: called as the HTTP service calls a
    chat engine."""

    def __init__(self, gen):
        self.gen = gen

    def __call__(self, request, context):
        payload = request.model_dump(exclude_none=True) \
            if hasattr(request, "model_dump") else request
        return self.gen(payload, context)


class PyTokEngine:
    """A token-level user engine: the Backend's core engine."""

    def __init__(self, gen):
        self.gen = gen

    async def generate(self, request, context):
        from .llm.protocols.common import EngineOutput

        payload = request.to_dict() if hasattr(request, "to_dict") \
            else request
        async for out in self.gen(payload, context):
            yield out if isinstance(out, EngineOutput) \
                else EngineOutput.from_dict(out)


def build_torch_engine(args) -> Tuple[object, object]:
    """(TorchEngine, model card) for ``out=torch``: with
    ``--coordinator``, this process's rank of the tensor-parallel mesh
    (it joins the process group here); with ``--model-path``, the
    checkpoint's weights (the rank's shard), or FileNotFoundError when
    the path holds none. The kernel launch counts restart after warmup,
    so the serving summary counts the served path alone. Logs one
    ``engine ready`` JSON line: where the rank's start went, in seconds
    since this module's import (imports, the process group, the
    checkpoint load, the engine's weights and pools, warmup)."""
    t = {"start": time.monotonic()}
    from .engine.torch_engine import TorchEngine
    from .ops import int8_gemm
    from .ops.paged_attention import reset_launch_counts
    from .runtime.device import resolve_device

    cfg = build_model_config(args)
    ecfg = build_engine_config(args)
    mdc = build_mdc(args)
    mdc.kv_block_size = ecfg.page_size
    t["imports"] = time.monotonic()
    mesh = None
    if args.coordinator:
        from .parallel.mesh import MeshSpec, initialize_multihost

        initialize_multihost(args.coordinator, args.num_processes,
                             args.process_id)
        mesh = MeshSpec(model=args.tensor_parallel_size).build(
            resolve_device(args.device).type)
    t["process_group"] = time.monotonic()
    params = None
    quant = "int8" if args.dtype == "int8" else None
    if args.model_path:
        from .models.loader import load_params

        rank, size = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
        t0 = time.monotonic()
        params = load_params(args.model_path, cfg,
                             mesh.device if mesh is not None else args.device,
                             rank=rank, size=size, quant=quant)
        seconds = time.monotonic() - t0
        nbytes = sum(t.nbytes for t in params.values())
        # one JSON line: the rank's load (its shard's bytes), its rate and
        # the process's peak host RSS so far (ru_maxrss is in KiB)
        log.info("checkpoint loaded %s", json.dumps({
            "rank": rank, "path": args.model_path, "tensors": len(params),
            "bytes": nbytes, "seconds": seconds,
            "gb_per_s": nbytes / 1e9 / max(seconds, 1e-9),
            "peak_rss_gib": peak_rss_gib()}))
    t["load"] = time.monotonic()
    engine = TorchEngine(cfg, ecfg, params=params, seed=args.seed,
                         device=args.device, mesh=mesh, quant=quant)
    t["engine"] = time.monotonic()
    log.info("engine built (weights and pools on %s in %.1f s); warming up",
             engine.device, t["engine"] - t["load"])
    graphs = 0 if args.no_warmup else engine.warmup()
    t["warmup"] = time.monotonic()
    stages = list(t)
    log.info("engine ready %s", json.dumps({
        "rank": mesh.rank if mesh is not None else 0, "graphs": graphs,
        "max_batch": ecfg.max_batch, "page_size": ecfg.page_size,
        "seconds": t["warmup"] - _T0,
        **{f"{b}_s": t[b] - t[a] for a, b in zip(stages, stages[1:])}}))
    reset_launch_counts()
    int8_gemm.reset_launch_counts()
    return engine, mdc


def serving_summary(engine) -> dict:
    """What a rank did since warmup: captures after warmup, kernel
    launches (by kernel, by decode and prefill route and, for the int8
    GEMM, by route and form: small_m, wgmma, small_m_f16, wgmma_f16,
    small_m_f32, wgmma_f32; replays counting the calls their capture recorded) and
    graph replays (every variant's)."""
    from .ops import int8_gemm
    from .ops import paged_attention as ops

    return {"rank": engine.mesh.rank if engine.mesh is not None else 0,
            "mesh_shape": engine.mesh_shape,
            "post_warmup_compiles_total": engine.fence.post_warmup_compiles,
            "batch_dispatches_total": engine.batch_dispatches_total,
            "launches": dict(ops.LAUNCHES),
            "route_launches": dict(ops.DECODE_ROUTE_LAUNCHES),
            "prefill_route_launches": dict(ops.PREFILL_ROUTE_LAUNCHES),
            "int8_gemm_launches": dict(int8_gemm.INT8_GEMM_LAUNCHES),
            "replays": engine.graph_replays()}


def _print_summary(engine, stream) -> None:
    # one write of the whole line: ranks sharing a log file must not
    # interleave inside each other's lines (print writes the end apart)
    stream.write(f"serving summary {json.dumps(serving_summary(engine))}\n")
    stream.flush()


def _summary_stream(args):
    """Where a rank's serving summary goes: standard error in the text and
    batch modes, whose standard output is the mode's own, else standard
    output."""
    if args.input == "text" or args.input.startswith("batch:"):
        return sys.stderr
    return sys.stdout


async def _finish(args, engine) -> None:
    """Stop the engine; a TorchEngine then prints its serving summary and
    leaves its process groups."""
    if hasattr(engine, "stop"):
        await engine.stop()
    if args.output == "torch":
        _print_summary(engine, _summary_stream(args))
        _leave(engine)


def _leave(engine) -> None:
    if engine.mesh is not None:
        from .parallel.mesh import leave_process_groups

        leave_process_groups(engine.mesh)


async def serve_http(engine, mdc, host: str, port: int, full: bool = False):
    """Start the HTTP service over ``engine``; returns the service (its
    ``.port`` is the bound port — pass ``port=0`` for a free one). A
    token-level engine serves chat and completions behind the
    preprocessor and the Backend; an OpenAI-level one (``full``) is the
    chat model itself. An engine with ``stats()`` feeds the service's
    admission control, and one with ``drain()`` is what ``POST /drain``
    drains."""
    from .llm.engines import LocalChatChain, LocalCompletionChain
    from .llm.http.service import HttpService, ModelManager

    manager = ModelManager()
    if full:
        manager.add_chat_model(mdc.name, engine)
    else:
        chat = LocalChatChain(mdc, engine)
        comp = LocalCompletionChain(mdc, engine, chat.preprocessor)
        manager.add_chat_model(mdc.name, chat)
        manager.add_completions_model(mdc.name, comp)
    svc = HttpService(manager)
    from .runtime import revive

    if hasattr(engine, "stats"):
        # admission control over the engine's own load signals; sheds
        # nothing until DYN_SHED_* thresholds are set
        svc.set_admission(revive.AdmissionController(
            lambda: revive.signals_from_stats(engine.stats())))
    if hasattr(engine, "drain"):
        # POST /drain: stop admitting, finish what is in flight bounded
        # by DYN_DRAIN_TIMEOUT_MS
        svc.on_drain(lambda: engine.drain(revive.drain_timeout_s()))
    await svc.start(host, port)
    return svc


async def _wait_for_signal() -> int:
    """Park until SIGINT or SIGTERM; returns the first signal's number,
    so a worker can pick the fast teardown (SIGINT) or the graceful
    drain (SIGTERM)."""
    stop = asyncio.Event()
    fired: list = []
    loop = asyncio.get_running_loop()

    def on_signal(signum: int) -> None:
        if not fired:
            fired.append(signum)
        stop.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, on_signal, sig)
    await stop.wait()
    return fired[0]


async def _attach(args):
    """The control plane of ``--dcp``, else ``DYN_DCP_ADDRESS``, else an
    embedded server in this process."""
    from .runtime.config import env_str
    from .runtime.runtime import DistributedRuntime

    address = args.dcp or env_str("DYN_DCP_ADDRESS")
    if address:
        return await DistributedRuntime.attach(address)
    log.warning("no control plane configured; starting embedded DCP server")
    return await DistributedRuntime.detached()


async def run_http(args) -> None:
    if not is_engine(args.output):
        await run_frontend(args)
        return
    engine, mdc, full = await asyncio.to_thread(build_engine, args)
    svc = await serve_http(engine, mdc, args.http_host, args.http_port, full)
    log.info("OpenAI frontend on %s:%d serving %r", args.http_host, svc.port,
             mdc.name)
    await _wait_for_signal()
    await svc.stop()
    await _finish(args, engine)


async def run_frontend(args) -> None:
    """``in=http out=dyn``: the HTTP service over the models that workers
    register on the control plane; no engine, no device."""
    from .llm.http.discovery import ModelWatcher
    from .llm.http.service import HttpService, ModelManager

    manager = ModelManager()
    svc = HttpService(manager)
    drt = await _attach(args)
    watcher = ModelWatcher(drt, manager)
    await watcher.start()
    await svc.start(args.http_host, args.http_port)
    log.info("OpenAI frontend on %s:%d, models discovered on the control "
             "plane", args.http_host, svc.port)
    await _wait_for_signal()
    await svc.stop()
    await watcher.stop()
    await drt.shutdown()


def _chain(engine, mdc, full: bool):
    """The chat model of an engine: itself at the OpenAI level, else
    behind the preprocessor and the Backend."""
    from .llm.engines import LocalChatChain

    return engine if full else LocalChatChain(mdc, engine)


def _delta_texts(chunk) -> list:
    """The content deltas of one chat stream item."""
    from .llm.http.service import _chunk_dict

    d = _chunk_dict(chunk)
    if not isinstance(d, dict):
        return []
    return [t for c in d.get("choices") or []
            if (t := (c.get("delta") or {}).get("content"))]


async def run_text(args) -> None:
    """``in=text``: a chat loop over standard input (the JAX launcher's
    ``run_text``): each line is a user turn of one conversation, its
    answer streamed to standard output, capped at ``--max-tokens``; an
    empty line or the end of input ends it."""
    from .llm.protocols.openai import ChatCompletionRequest
    from .runtime.engine import Context

    engine, mdc, full = await asyncio.to_thread(build_engine, args)
    chain = _chain(engine, mdc, full)
    print(f"chat with {mdc.name} — empty line or ^D to exit", flush=True)
    history = []
    loop = asyncio.get_running_loop()
    while True:
        try:
            line = await loop.run_in_executor(None, lambda: input("> "))
        except (EOFError, KeyboardInterrupt):
            break
        if not line.strip():
            break
        history.append({"role": "user", "content": line})
        req = ChatCompletionRequest(model=mdc.name, messages=history,
                                    stream=True, max_tokens=args.max_tokens)
        text = []
        async for chunk in chain(req, Context()):
            for delta in _delta_texts(chunk):
                text.append(delta)
                print(delta, end="", flush=True)
        print()
        history.append({"role": "assistant", "content": "".join(text)})
    await _finish(args, engine)


async def run_batch(args, path: str) -> None:
    """``in=batch:FILE``, the benchmark mode (the JAX launcher's
    ``run_batch``): every line of FILE (``{"text"|"prompt": ...,
    "max_tokens"?: N}``) sent at once as a streamed chat request; then
    one JSON line a request in file order, ``index``, ``tokens_in`` (the
    prompt's words), ``tokens_out`` (the stream's chunks that carried
    text) and ``elapsed_ms``, and ``{"aggregate": {"requests", "wall_s",
    "output_tok_per_s"}}``."""
    from .llm.protocols.openai import ChatCompletionRequest
    from .runtime.engine import Context

    engine, mdc, full = await asyncio.to_thread(build_engine, args)
    chain = _chain(engine, mdc, full)

    def _read_jsonl() -> list:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]

    entries = await asyncio.to_thread(_read_jsonl)
    results = []
    t0 = time.monotonic()

    async def one(i, entry):
        text = entry.get("text") or entry.get("prompt") or ""
        req = ChatCompletionRequest(
            model=mdc.name, stream=True,
            messages=[{"role": "user", "content": text}],
            max_tokens=entry.get("max_tokens", args.max_tokens))
        start = time.monotonic()
        n_out = 0
        async for chunk in chain(req, Context()):
            n_out += bool(_delta_texts(chunk))
        elapsed = time.monotonic() - start
        results.append({"index": i, "tokens_in": len(text.split()),
                        "tokens_out": n_out,
                        "elapsed_ms": round(elapsed * 1000, 1)})

    await asyncio.gather(*(one(i, e) for i, e in enumerate(entries)))
    wall = time.monotonic() - t0
    for r in sorted(results, key=lambda r: r["index"]):
        print(json.dumps(r))
    total_out = sum(r["tokens_out"] for r in results)
    print(json.dumps({"aggregate": {
        "requests": len(results), "wall_s": round(wall, 3),
        "output_tok_per_s": round(total_out / wall, 1) if wall else 0.0}}),
        flush=True)
    await _finish(args, engine)


def worker_path(args, mdc) -> str:
    """The endpoint a worker serves: ``--endpoint``, else the in=dyn://
    path, else ``dyn://<--namespace>.<model slug>.generate``."""
    from .llm.worker import _component_slug

    if args.endpoint:
        return args.endpoint
    if args.input.startswith("dyn://"):
        return args.input
    return f"dyn://{args.namespace}.{_component_slug(mdc)}.generate"


async def run_worker(args) -> None:
    """``in=dyn://ns.comp[.ep]``: serve a token-level engine as a
    discoverable model worker. The engine is built and warmed before the
    process attaches, so a frontend never routes to a cold worker."""
    from .llm.worker import serve_openai_model
    from .runtime.component import EndpointAddress

    engine, mdc, full = await asyncio.to_thread(build_engine, args)
    if full:
        raise SystemExit("worker mode needs a token-level engine "
                         "(out=torch or out=echo_core)")
    path = worker_path(args, mdc)
    addr = EndpointAddress.parse(path)
    drt = await _attach(args)
    # chat and completions, as in=http serves a local engine
    handle = await serve_openai_model(
        drt, mdc, engine, namespace=addr.namespace,
        component=addr.component, endpoint=addr.endpoint,
        stats_handler=getattr(engine, "stats", None), model_type="both")
    log.info("worker serving %r at %s as instance %x", mdc.name,
             addr, drt.instance_id)
    if await _wait_for_signal() == signal.SIGTERM:
        # rolling restart: the discovery record goes first (no new
        # admissions), in-flight streams finish within
        # DYN_DRAIN_TIMEOUT_MS, then the lease is released
        from .runtime import revive

        await revive.drain_worker(handle, engine=engine)
    else:
        await handle.stop()
    if hasattr(engine, "stop"):
        await engine.stop()
    await drt.shutdown()
    if args.output == "torch":
        _print_summary(engine, _summary_stream(args))
        _leave(engine)


async def run_none(args) -> None:
    """``in=none``: build and warm the engine, then idle until a signal."""
    engine, mdc, _ = await asyncio.to_thread(build_engine, args)
    log.info("engine %s ready (in=none); SIGINT or SIGTERM to exit",
             mdc.name)
    await _wait_for_signal()
    await _finish(args, engine)


def run_rank0(args) -> None:
    if args.input == "http":
        asyncio.run(run_http(args))
    elif args.input == "text":
        asyncio.run(run_text(args))
    elif args.input.startswith("batch:"):
        asyncio.run(run_batch(args, args.input[len("batch:"):]))
    elif args.input == "none":
        asyncio.run(run_none(args))
    else:
        asyncio.run(run_worker(args))


def run_follower(args) -> None:
    """A rank > 0: build its shard of the engine, warm up with rank 0,
    then replay rank 0's dispatches until it stops."""
    engine, _ = build_torch_engine(args)
    engine.follow()
    _print_summary(engine, _summary_stream(args))
    _leave(engine)


def profiled(args, run) -> None:
    """``run()`` under ``torch.profiler`` when ``--profile-dir`` is set
    (host ops, and the card's activity on a CUDA device), from its start
    to its end; the rank's Chrome trace is then written into the
    directory as ``rank<r>.pt.trace.json``."""
    if not args.profile_dir:
        run()
        return
    import torch

    from .engine.profiler import trace_profiler

    cuda = args.device.startswith("cuda") and args.output == "torch"
    os.makedirs(args.profile_dir, exist_ok=True)
    prof = trace_profiler(cuda)
    try:
        run()
    finally:
        prof.stop()
        if cuda and torch.cuda.is_available():
            torch.cuda.synchronize()
        path = os.path.join(args.profile_dir,
                            f"rank{args.process_id}.pt.trace.json")
        t0 = time.monotonic()
        prof.export_chrome_trace(path)
        log.info("profiler trace written to %s (%.1f s)", path,
                 time.monotonic() - t0)


def shared_device_env(rank: int, ranks: int, devices: int) -> Dict[str, str]:
    """The NCCL settings rank ``rank`` of ``ranks`` needs when some ranks
    share one of ``devices`` cards (rank r runs on card r % devices): NCCL
    refuses two ranks of one communicator on one device, so each rank
    gets a host id of its own and the ranks talk over the loopback
    socket. Empty when every rank has a card of its own."""
    if ranks <= devices:
        return {}
    return {"NCCL_HOSTID": f"dynamo-tp-rank-{rank}",
            "NCCL_SOCKET_IFNAME": "lo"}


def spawn_local_ranks(args, argv: List[str]) -> List[subprocess.Popen]:
    """The one-command form: start ranks 1..N-1 of ``argv`` on this host
    with a rendezvous on a free local port, and make this process rank 0
    of the same group."""
    import torch

    n = args.tensor_parallel_size
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args.coordinator = f"127.0.0.1:{port}"
    args.num_processes = n
    devices = (torch.cuda.device_count()
               if args.device.startswith("cuda") else n)
    shared = shared_device_env(0, n, devices)
    if shared:
        log.info("%d ranks on %d card(s): each rank gets its own "
                 "NCCL_HOSTID, and NCCL talks over the loopback socket",
                 n, devices)
    os.environ.update(shared)
    procs = []
    for r in range(1, n):
        cmd = [sys.executable, "-m", "dynamo_tpu_torch.run", *argv,
               "--coordinator", args.coordinator, "--num-processes", str(n),
               "--process-id", str(r)]
        procs.append(subprocess.Popen(
            cmd, env={**os.environ, **shared_device_env(r, n, devices)}))
    return procs


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    ranks = []
    if args.tensor_parallel_size > 1 and not args.coordinator:
        ranks = spawn_local_ranks(args, argv)
    try:
        profiled(args, lambda: run_rank0(args) if args.process_id == 0
                 else run_follower(args))
    finally:
        for p in ranks:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()


if __name__ == "__main__":
    main()
