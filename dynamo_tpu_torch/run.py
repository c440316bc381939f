"""Launcher for the PyTorch port: ``in=http out=torch``.

    python -m dynamo_tpu_torch.run in=http out=torch --model 8b
    python -m dynamo_tpu_torch.run in=http out=torch --model tiny --device cpu

Serves the OpenAI HTTP front end (chat + completions + models + health)
over :class:`~dynamo_tpu_torch.engine.torch_engine.TorchEngine`. Weights
are random, drawn from ``--seed``; the byte tokenizer is the card's
default. ``--model-path`` is refused: the port has no weights loader yet,
and serving random weights under a checkpoint's name would pass them off
as the checkpoint's.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
from typing import Tuple

log = logging.getLogger("dynamo_tpu_torch.run")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="dynamo_tpu_torch.run",
        usage="%(prog)s in=http out=torch [flags]")
    ap.add_argument("io", nargs="*", help="in=… and out=… positionals")
    ap.add_argument("--model-path",
                    help="refused: the port cannot load weights yet")
    ap.add_argument("--model-name", help="served model name")
    ap.add_argument("--model", default=None,
                    help="preset: tiny (default), 1b or 8b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--http-host", default="0.0.0.0")
    ap.add_argument("--http-port", type=int, default=8080)
    ap.add_argument("--no-warmup", action="store_true")
    args = ap.parse_args(argv)
    args.input, args.output = "http", "torch"
    for tok in args.io:
        if tok.startswith("in="):
            args.input = tok[3:]
        elif tok.startswith("out="):
            args.output = tok[4:]
        else:
            ap.error(f"positional args must be in=…/out=…, got {tok!r}")
    if args.input != "http" or args.output != "torch":
        ap.error("this launcher serves in=http out=torch only")
    if args.model_path:
        ap.error("--model-path: the PyTorch port has no weights loader yet "
                 "(the dense safetensors loader is next on ROADMAP.md's "
                 "queue of modules to port), and will not serve random "
                 "weights under a checkpoint's name; use --model "
                 "tiny|1b|8b for random weights")
    return args


def build_model_config(args):
    from .models.config import ModelConfig

    preset = args.model or "tiny"
    if preset == "tiny":
        return ModelConfig.tiny()
    if preset == "1b":
        return ModelConfig.llama_1b()
    if preset == "8b":
        return ModelConfig.llama3_8b()
    raise SystemExit(f"unknown --model preset {preset!r}")


def build_engine_config(args):
    from .engine.torch_engine import EngineConfig

    if args.model in (None, "tiny"):
        # the JAX launcher's tiny-model engine config
        return EngineConfig(page_size=16, num_pages=256, max_batch=16,
                            prefill_chunk=128, prefill_buckets=(128,),
                            batch_buckets=(4, 16), page_buckets=(16,))
    return EngineConfig()


def build_engine(args) -> Tuple[object, object]:
    """(TorchEngine, model card) for the parsed arguments."""
    from .engine.torch_engine import TorchEngine
    from .llm.model_card import ModelDeploymentCard

    cfg = build_model_config(args)
    ecfg = build_engine_config(args)
    mdc = ModelDeploymentCard(name=args.model_name or (args.model or "tiny"))
    mdc.kv_block_size = ecfg.page_size
    engine = TorchEngine(cfg, ecfg, seed=args.seed, device=args.device)
    if not args.no_warmup:
        engine.warmup()
    return engine, mdc


async def serve_http(engine, mdc, host: str, port: int):
    """Start the HTTP service over ``engine``; returns the service (its
    ``.port`` is the bound port — pass ``port=0`` for a free one)."""
    from .llm.engines import LocalChatChain, LocalCompletionChain
    from .llm.http.service import HttpService, ModelManager

    manager = ModelManager()
    chat = LocalChatChain(mdc, engine)
    comp = LocalCompletionChain(mdc, engine, chat.preprocessor)
    manager.add_chat_model(mdc.name, chat)
    manager.add_completions_model(mdc.name, comp)
    svc = HttpService(manager)
    await svc.start(host, port)
    return svc


async def run_http(args) -> None:
    engine, mdc = await asyncio.to_thread(build_engine, args)
    svc = await serve_http(engine, mdc, args.http_host, args.http_port)
    log.info("OpenAI frontend on %s:%d serving %r", args.http_host, svc.port,
             mdc.name)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await svc.stop()
    await engine.stop()


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    asyncio.run(run_http(parse_args(argv)))


if __name__ == "__main__":
    main()
