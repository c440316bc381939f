"""Profile the fused decode window, or a prefill chunk, of the 8B model
on the GPU: by CUDA-graph replay against eager calls, in one run.

    python -m dynamo_tpu_torch.profile_step [--rows 4 32] [--context 512]
                                            [--windows 10] [--logprobs]
                                            [--penalties]
    python -m dynamo_tpu_torch.profile_step --prefill [PBxTxP ...]
                                            [--windows 10] [--penalties]
    ... [--dtype bf16 int8 f16 f16-int8 f32-1b f32-1b-int8]

Builds the engine at Llama-3-8B widths (random weights, seed 0), once
per ``--dtype`` in turn (``int8``: weight-only int8 projections through
the int8 GEMM, ``TorchEngine(quant="int8")``; ``f16``: the model in
float16, ``f16-int8`` the same with int8 projections; ``f32-1b``: the
model at Llama-3.2-1B's widths in float32, as chip_smoke.py's phase 11
serves it, ``f32-1b-int8`` the same with int8 projections, the int8
GEMM's float32 forms), so one run traces the bf16 and the int8 window,
or chunk, side by side; every JSON line names its dtype.

For each ``--rows`` B it prefills B rows of ``--context`` tokens, then runs
decode windows (``EngineConfig.decode_steps`` steps each) three ways, on
the engine's stream, each window's carry feeding the next:

- ``eager``: the window function called from Python, tokens read back
  after each window (a device sync), as the engine decoded before it
  captured graphs;
- ``graph``: one replay of the bucket's CUDA graph per window, read back
  after each (sync);
- ``graph_pipelined``: as the engine serves: window N+1 is replayed
  before window N's tokens are read back (pinned copies and an event per
  window), so the host's work overlaps the device's.

``--logprobs`` runs the windows in the engine's logprobs variant (each
step also returns the ``max_top_logprobs`` top logprobs of its raw
logits, as a window with a logprobs request does; the variant's graph
set). ``--penalties`` runs them in the penalised variant, as a window of
a batch with penalties is dispatched: every row with repetition 1.1,
frequency 0.5, presence 0.5 and four logit_bias entries, uploaded once
(``PenaltyBuffers.upload``), and the penalty state rebuilt on the device
from the rows' [B, context] token ids before every window
(``PenaltyBuffers.fill``; the host's assembly of those ids is not
timed). It traces one window of each of the first two with
``torch.profiler``.
Prints one JSON object per row count: wall ms per window (all windows,
sorted) and per step, the kernels a traced window ran, the device-busy
time (the union of the kernels' intervals), the device's idle share of
the traced and of the untraced window wall (untraced: 1 - busy / median
wall), the projections' share of the busy time (kernels named as cuBLAS's
and the int8 GEMM's, :data:`MATMUL_KERNELS`), and the kernels that took
the most device time.

``--prefill`` profiles prefill chunks instead (default 1x64x8, 1x512x8
and 8x512x64: prefill batch x chunk length x page bucket), each of PB
rows of T prompt tokens from position 0 with their first-token draw, two
ways: ``eager`` as the engine dispatched a chunk before it captured
prefill graphs (the inputs uploaded, the forward and the draw called from
Python), and ``graph`` as it dispatches one now (one upload of the packed
inputs, one replay of the bucket's graph); both then copy the drawn
tokens to pinned memory and wait on an event. Per mode: the host's time
until the dispatch returns (µs, all chunks, sorted), the wall per chunk
including the wait, and the traced figures above; plus whether both
modes drew the same tokens. With ``--penalties`` a third mode,
``graph_penalised``, replays the same graph and then draws the first
tokens eagerly with penalties and logit_bias, as the engine does for a
batch with either (``TorchEngine._penalised_draw``): its chunk wall less
``graph``'s is the penalised draw's cost.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


# names of the projection products' kernels: cuBLAS's (bf16) and the
# int8 GEMM's
MATMUL_KERNELS = ("gemm", "gemv", "xmma", "nvjet", "cutlass")


def _union_ms(intervals) -> float:
    """Total length of the union of (start_us, end_us) intervals, in ms."""
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def _trace(run) -> dict:
    """Trace one call of ``run`` (ending in a sync): its wall, the kernels
    it ran and their busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type.name == "CUDA" and e.time_range is not None]
    busy = _union_ms([(e.time_range.start, e.time_range.end)
                      for e in kernels])
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    matmul = sum(ms for n, (ms, _) in by_name.items()
                 if any(k in n for k in MATMUL_KERNELS))
    return {"traced_window_wall_ms": wall, "kernels_per_window": len(kernels),
            "device_busy_ms": busy,
            "traced_idle_share": 1.0 - busy / wall if wall else None,
            "matmul_ms": matmul,
            "matmul_share": matmul / busy if busy else None,
            "top_kernels": [{"name": n[:80], "ms": ms, "launches": c}
                            for n, (ms, c) in top]}


def _timed(run, n: int) -> list:
    """Sorted walls (ms) of ``n`` calls of ``run``, each ending in a
    device sync."""
    import torch

    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return sorted(walls)


def _penalty_inputs(B: int, T: int, V: int, tokens):
    """The ``--penalties`` sampler inputs of B rows whose last T//2
    tokens of ``tokens`` [B, T] count as generated: (``pargs`` of
    ``PenaltyBuffers.upload``, (ids, starts) of ``PenaltyBuffers.fill``)."""
    import numpy as np

    rng = np.random.RandomState(1)
    f32 = np.float32
    at = np.stack([np.repeat(np.arange(B), 4),
                   rng.randint(0, V, 4 * B)]).astype(np.int32)
    # one entry per (row, token)
    _, first = np.unique(at[0].astype(np.int64) * V + at[1],
                         return_index=True)
    at = at[:, np.sort(first)]
    pargs = (np.full(B, 1.1, f32), np.full(B, 0.5, f32),
             np.full(B, 0.5, f32), at,
             rng.uniform(-5, 5, at.shape[1]).astype(f32))
    return pargs, (np.ascontiguousarray(tokens, np.int32),
                   np.full(B, T // 2, np.int32))


def profile_rows(engine, B: int, T: int, windows: int,
                 logprobs: bool = False, penalties: bool = False) -> dict:
    import numpy as np
    import torch

    from .engine.cuda_graphs import PEN_FULL, PEN_NONE, to_host

    ecfg = engine.ecfg
    dev = engine.device
    ps, K = ecfg.page_size, ecfg.decode_steps
    # every window run below (2 x (windows + 2) sync'ed, 3 x windows
    # pipelined) writes K more positions per row
    total = T + K * (5 * windows + 8)
    pages_per_row = -(-total // ps)
    P = ecfg.bucket_pages(pages_per_row)
    if B * pages_per_row > ecfg.num_pages - 1:
        raise SystemExit(f"{B} rows of {total} positions need "
                         f"{B * pages_per_row} pages; the pool has "
                         f"{ecfg.num_pages - 1}")
    table = np.zeros((B, P), np.int32)
    for b in range(B):
        table[b, :pages_per_row] = 1 + b * pages_per_row + np.arange(
            pages_per_row)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 256, (B, T)).astype(np.int32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    slots = (table[:, :, None] * ps + np.arange(ps)).reshape(B, -1)[:, :T]
    i32 = dict(dtype=torch.int32, device=dev)
    topn = ecfg.max_top_logprobs if logprobs else 0
    graphs = engine.decode_set(topn, PEN_FULL if penalties else PEN_NONE)
    bk = graphs.bucket(B, P)
    state = None
    with graphs.stream_ctx():
        if penalties:
            pargs, state = _penalty_inputs(B, T, engine.cfg.vocab_size,
                                           tokens)
            engine.penalties().upload(B, *pargs)
        logits, _, _ = engine.prefill_fn(
            engine.params, torch.tensor(tokens, **i32),
            torch.tensor(positions, **i32), engine.kv_k, engine.kv_v,
            torch.tensor(table, **i32),
            torch.tensor(slots.astype(np.int32), **i32),
            torch.full((B,), T - 1, **i32))
        bk.tok.copy_(torch.argmax(logits, -1).to(torch.int32))
        bk.pos.fill_(T)
        bk.done.zero_()
        bk.steps.zero_()
        bk.rem.fill_(1 << 20)
        bk.table.copy_(torch.tensor(table, **i32))
        bk.temperature.zero_()
        bk.top_k.zero_()
        bk.top_p.fill_(1.0)
        bk.seeds.zero_()
        bk.eos.fill_(-1)
    torch.cuda.synchronize()

    def rebuild():
        """The state a penalised dispatch rebuilds before its window."""
        if state is not None:
            engine.penalty_buffers.fill(B, *state)

    def eager():
        rebuild()
        out = engine.decode_multi_fn(
            engine.params, *bk.carry_in, engine.kv_k, engine.kv_v, bk.table,
            bk.temperature, bk.top_k, bk.top_p, bk.seeds, bk.eos, bk.pen,
            k_steps=K, logprobs_topn=topn)
        toks, carry = out[0], out[-3]
        toks.cpu()  # the tokens are read back after each window
        for dst, src in zip(bk.carry_in, carry):
            dst.copy_(src)

    def graph():
        rebuild()
        graphs.launch(bk)
        bk.toks.cpu()
        for dst, src in zip(bk.carry_in, bk.carry):
            dst.copy_(src)

    def pipelined(n):
        """n windows, each read back after the next is enqueued; wall per
        window over the run."""
        t0 = time.perf_counter()
        pending = None
        for _ in range(n):
            rebuild()
            graphs.launch(bk)
            nxt = to_host(bk.toks, *(bk.aux or ()))
            for dst, src in zip(bk.carry_in, bk.carry):
                dst.copy_(src)
            if pending is not None:
                pending[1].synchronize()
                pending[0][0].numpy()
            pending = nxt
        pending[1].synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    out = {"rows": B, "context": T, "steps_per_window": K, "bucket": [B, P],
           "variant": graphs.variant}
    with graphs.stream_ctx():
        for name, run in (("eager", eager), ("graph", graph)):
            run()
            torch.cuda.synchronize()
            walls = _timed(run, windows)
            median = walls[len(walls) // 2]
            tr = _trace(run)
            out[name] = {
                "window_wall_ms": walls, "step_wall_ms_median": median / K,
                "untraced_idle_share": 1.0 - tr["device_busy_ms"] / median,
                **tr}
        out["graph_pipelined"] = {
            "window_wall_ms_mean": [pipelined(windows) for _ in range(3)]}
    return out


def profile_prefill(engine, B: int, T: int, P: int, chunks: int,
                    penalties: bool = False) -> dict:
    """One (B, T, P) prefill chunk and its first-token draw, eagerly and
    by graph replay (module docstring)."""
    import numpy as np
    import torch

    from .engine.cuda_graphs import to_device, to_host
    from .engine.sampling import sample_tokens

    ecfg = engine.ecfg
    ps = ecfg.page_size
    npg = -(-T // ps)
    if npg > P or B * npg > ecfg.num_pages - 1:
        raise SystemExit(f"{B} rows of {T} positions do not fit {P} pages "
                         f"a row and a pool of {ecfg.num_pages - 1}")
    paged = T % ps == 0
    graphs = engine.prefill_graphs
    bk = graphs.bucket(B, T, P, paged)
    img, f = bk.host_inputs()
    pages = 1 + np.arange(B * npg).reshape(B, npg)
    pos = np.arange(T)
    f["tokens"][:] = np.random.RandomState(0).randint(0, 256, (B, T))
    f["positions"][:] = pos
    f["table"][:, :npg] = pages
    f["last_idx"][:] = T - 1
    f["slots"][:] = pages[:, pos // ps] * ps + pos % ps
    if paged:
        f["pslots"][:] = pages
    host = {k: np.array(v) for k, v in f.items()}
    host_us = {"eager": [], "graph": [], "graph_penalised": []}
    if penalties:
        pen = _penalty_inputs(B, T, engine.cfg.vocab_size, f["tokens"])
    drawn = {}

    def eager():
        t0 = time.perf_counter()
        d = {k: to_device(v, engine.device) for k, v in host.items()}
        logits, _, _ = engine.prefill_fn(
            engine.params, d["tokens"], d["positions"], engine.kv_k,
            engine.kv_v, d["table"], d["slots"], d["last_idx"],
            d["pslots"] if paged else None)
        tok = sample_tokens(logits, d["temperature"], d["top_k"],
                            d["top_p"], d["seeds"], d["steps"],
                            max_top_k=ecfg.max_top_k)
        (out,), event = to_host(tok)
        host_us["eager"].append((time.perf_counter() - t0) * 1e6)
        event.synchronize()
        drawn["eager"] = out.tolist()

    def graph():
        t0 = time.perf_counter()
        graphs.run(bk, img)
        (out,), event = to_host(bk.sampled)
        host_us["graph"].append((time.perf_counter() - t0) * 1e6)
        event.synchronize()
        drawn["graph"] = out.tolist()

    def graph_penalised():
        t0 = time.perf_counter()
        graphs.run(bk, img)
        tok, _ = engine._penalised_draw(bk, *pen, 0)
        (out,), event = to_host(tok)
        host_us["graph_penalised"].append((time.perf_counter() - t0) * 1e6)
        event.synchronize()

    out = {"chunk": [B, T, P], "paged": paged}
    modes = [("eager", eager), ("graph", graph)]
    if penalties:
        modes.append(("graph_penalised", graph_penalised))
    with graphs.stream_ctx():
        for name, run in modes:
            run()
            torch.cuda.synchronize()
            host_us[name].clear()
            walls = _timed(run, chunks)
            median = walls[len(walls) // 2]
            tr = _trace(run)
            out[name] = {
                "host_us": sorted(host_us[name][:chunks]),
                "chunk_wall_ms": walls,
                "untraced_idle_share": 1.0 - tr["device_busy_ms"] / median,
                **tr}
    out["same_tokens"] = drawn["eager"] == drawn["graph"]
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, nargs="+", default=[4, 32])
    ap.add_argument("--context", type=int, default=512)
    ap.add_argument("--windows", type=int, default=10,
                    help="timed windows (or prefill chunks) per mode")
    ap.add_argument("--logprobs", action="store_true",
                    help="decode windows in the logprobs variant")
    ap.add_argument("--penalties", action="store_true",
                    help="decode windows in the penalised variant, and a "
                         "penalised first-token draw after each prefill "
                         "chunk")
    ap.add_argument("--prefill", nargs="*", metavar="PBxTxP", default=None,
                    help="profile prefill chunks instead of decode windows "
                         "(default 1x64x8 1x512x8 8x512x64)")
    ap.add_argument("--dtype", nargs="+", default=["bf16"],
                    choices=["bf16", "int8", "f16", "f16-int8", "f32-1b",
                             "f32-1b-int8"],
                    help="the engine's weights, one engine after the other "
                         "in one run (int8: weight-only int8, the launcher's "
                         "--dtype int8; f16: float16 activations and "
                         "weights; f16-int8: float16 with int8 weights; "
                         "f32-1b: Llama-3.2-1B's widths in float32; "
                         "f32-1b-int8: the same with int8 weights)")
    args = ap.parse_args()

    import dataclasses
    import gc

    import torch

    from .engine.torch_engine import EngineConfig, TorchEngine
    from .models.config import ModelConfig

    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()
    for dtype in args.dtype:
        cfg = ModelConfig.llama3_8b()
        if dtype.startswith("f16"):
            cfg = dataclasses.replace(cfg, dtype="float16")
        if dtype.startswith("f32-1b"):
            cfg = dataclasses.replace(ModelConfig.llama_1b(), dtype="float32")
        engine = TorchEngine(cfg, EngineConfig(), seed=0, device="cuda",
                             quant="int8" if dtype.endswith("int8") else None)
        head = {"card": card, "dtype": dtype}
        if args.prefill is not None:
            for spec in args.prefill or ["1x64x8", "1x512x8", "8x512x64"]:
                B, T, P = (int(x) for x in spec.split("x"))
                res = profile_prefill(engine, B, T, P, args.windows,
                                      args.penalties)
                print(json.dumps({**head, **res}), flush=True)
        else:
            for B in args.rows:
                res = profile_rows(engine, B, args.context, args.windows,
                                   args.logprobs, args.penalties)
                print(json.dumps({**head, **res}), flush=True)
        del engine
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
