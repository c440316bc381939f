"""Device time of the int8 GEMM (``int8_matmul``) at the 8B model's
projection shapes, for comparing two trees on one card.

    python -m dynamo_tpu_torch.ops.time_int8_gemm   # from a checkout's root

Shapes (K x N): wq/wo 4096 x 4096, wk/wv 4096 x 1024, w_gate/w_up
4096 x 14336, w_down 14336 x 4096, lm_head 4096 x 128256, at M = 4, 16,
32, 48, 64, 512 and 4,096 rows of bfloat16 x (seeded). ``--dtype
float16`` takes float16 x at the same shapes (the float16 forms of the
small-M and wgmma routes); ``--dtype float32`` float32 x at
Llama-3.2-1B's projections (wq/wo 2048 x 2048, wk/wv 2048 x 512,
w_gate/w_up 2048 x 8192, w_down 8192 x 2048, lm_head 2048 x 128256: the
float32 forms of both routes, small-M at 16 rows and fewer; ``--shapes
all`` adds the 8B model's), its cells also carrying the FFMA bound
(``bound_ffma``) where the tree's ``int8_gemm_work`` gives it. Each call is
timed three times: a CUDA graph of calls that cycle over copies of the
weights holding 256 MiB of int8 (so each call finds its weights out of
the 50 MB L2, as a layer's call does), replayed between two CUDA events.
Each output is first held to ``int8_gemm_tolerance``. Prints one JSON
line: the card, its power limit, and per shape and M the three times in
µs beside ``int8_gemm_work``'s bound, and a digest of the output's bits
(``digest``), so that two trees' kernels can be shown bitwise equal on
the same seeded inputs.

    python -m dynamo_tpu_torch.ops.time_int8_gemm --write-x

also times each call after a kernel that writes its x
(``torch.add(x_src, 0, out=x)``), as a layer's wq, wo and w_down follow
a norm, attention or SiLU-mul: a graph of (writer, call) pairs less a
graph of the writer alone (``after_write``, three times, µs). Back to
back, a call whose launch is programmatic overlaps the call before it,
as wq, wk and wv do in a layer; after a writer it can overlap only the
writer.

The module uses only what every tree of the port since int8 serving has
(``int8_matmul``, ``int8_gemm_tolerance``, ``int8_gemm_work``), so to
compare a change with its parent, unpack the parent into a git-ignored
directory, copy this file into its ``dynamo_tpu_torch/ops/``, and run,
in one chip call, parent, change, change, parent.

    python -m dynamo_tpu_torch.ops.time_int8_gemm --plans

instead times, at the same shapes and rows (ROWS, or ``--rows``), the
launch ``int8_gemm_plan`` picks, the small-M route where it can take
the rows (with ``--write-x``, also after a writer: ``small_m
after_write``), and every wgmma tile and split that fits the card in one
round or more (this tree only): the measurements the plan's crossover
and its time model (``WG_CHUNK_US``, ``WG_FOLD_US``) are fitted to.
``rule`` names the swept launch a fixed rule would take instead of the
model's (:func:`fixed_rule`). One JSON line per shape and M.
``--shapes tp2`` takes one rank's shapes at tensor-parallel size 2
instead (TP2_SHAPES), ``--shapes all`` both sets. Its first line holds
the CUDA driver's co-resident counts the plans use
(:func:`resident_counts`).
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import subprocess
import sys

SHAPES = {"wq_wo": (4096, 4096), "wk_wv": (4096, 1024),
          "gate_up": (4096, 14336), "down": (14336, 4096),
          "lm_head": (4096, 128256)}
# Llama-3.2-1B's, the shapes served in float32
SHAPES_1B = {"1b wq_wo": (2048, 2048), "1b wk_wv": (2048, 512),
             "1b gate_up": (2048, 8192), "1b down": (8192, 2048),
             "1b lm_head": (2048, 128256)}
# one rank's at tp=2: column-parallel wq, wk/wv, w_gate/w_up and lm_head
# halve N, row-parallel wo and w_down halve K
TP2_SHAPES = {"tp2 wq": (4096, 2048), "tp2 wk_wv": (4096, 512),
              "tp2 gate_up": (4096, 7168), "tp2 lm_head": (4096, 64128),
              "tp2 wo": (2048, 4096), "tp2 down": (7168, 4096)}
ROWS = (4, 16, 32, 48, 64, 512, 4096)
COLD_BYTES = 256 * 2**20
REPEATS = 3


def time_us(fn, iters: int) -> float:
    """Device µs per call: ``iters`` calls captured in one CUDA graph,
    replayed five times between two CUDA events (warmed on the stream
    that is then captured)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e3 / (iters * 5)


def after_write_us(fn, x, iters: int) -> float:
    """Device µs of ``fn`` after a kernel that writes x: a graph of
    (``torch.add(x_src, 0, out=x)``, ``fn``) pairs less a graph of the
    writer alone (x_src: a copy of x)."""
    import torch

    x_src = x.clone()

    def write():
        torch.add(x_src, 0, out=x)

    def pair():
        write()
        return fn()

    return time_us(pair, iters) - time_us(write, iters)


def digest(t) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes."""
    import torch

    raw = t.contiguous().cpu().view(-1).view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16]


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def fixed_rule(M: int, N: int, K: int, sms: int, resident) -> tuple:
    """(tokens, splits) of the fixed rule the wgmma plan's time model is
    held against: the smallest tile of at least min(M, 256) tokens, then
    the splits doubled while every tile's cluster fits on the card at
    once, the blocks stay fewer than the card's ``sms`` and each
    split keeps two 64-wide chunks of K."""
    from dynamo_tpu_torch.ops.int8_gemm import (MAX_SPLITS, WG_TILE_N,
                                                WG_TOKENS)

    tokens = next(t for t in WG_TOKENS if t >= min(M, WG_TOKENS[-1]))
    tiles = -(-M // tokens) * -(-N // WG_TILE_N)
    splits = 1
    while (splits < MAX_SPLITS and tiles * splits < sms
           and -(-K // 64) >= 4 * splits
           and tiles <= resident(tokens, 2 * splits)):
        splits *= 2
    return tokens, splits


def sweep_plans(x, ws, M: int, K: int, N: int,
                write_x: bool = False) -> dict:
    """µs of every launch of one call: the plan's, the small-M route's
    (M <= SMALL_M_ROWS; with ``write_x`` also after a kernel that writes
    x, :func:`after_write_us`) and each wgmma (tokens, splits) whose
    tile is no more than twice the rows; and which of them
    :func:`fixed_rule` takes."""
    import torch

    from dynamo_tpu_torch.ops.int8_gemm import (MAX_SPLITS, SMALL_M_ROWS,
                                                SMALL_M_ROWS_F32, WG_TILE_N,
                                                WG_TOKENS, WG_TOKENS_F32,
                                                Int8Plan, device_plan,
                                                int8_matmul, int8_gemm_work,
                                                resident_of, small_m_plan)

    f32 = x.dtype == torch.float32
    plans = {"chosen": device_plan(M, N, K, x.device, x.dtype)}
    resident = resident_of(x.device, x.dtype)
    if M <= (SMALL_M_ROWS_F32 if f32 else SMALL_M_ROWS):
        plans["small_m"] = small_m_plan(M, N, K, _sms(x.device), resident,
                                        x.dtype)
    for tokens in WG_TOKENS_F32 if f32 else WG_TOKENS:
        if tokens > 2 * max(M, 16) or (tokens < M // 4 and tokens < 128):
            continue
        tiles = -(-M // tokens) * -(-N // WG_TILE_N)
        splits = 1
        while splits <= MAX_SPLITS and -(-K // 64) >= 2 * splits:
            plans[f"{tokens}/{splits}"] = Int8Plan(
                "wgmma", tokens, splits,
                min(tiles, resident(tokens, splits)) * splits)
            splits *= 2
    turn = itertools.count()
    work = int8_gemm_work(M, K, N, x.dtype)
    iters = 20 if work["bound_ms"] < 0.2 else 5 if work["bound_ms"] < 2 else 2
    out = {}
    for key, plan in plans.items():
        def call(plan=plan):
            q, s = ws[next(turn) % len(ws)]
            return int8_matmul(x, q, s, plan=plan)
        out[key] = {"plan": list(plan), "us": round(time_us(call, iters), 2)}
    if write_x and "small_m" in plans:
        def small(plan=plans["small_m"]):
            q, s = ws[next(turn) % len(ws)]
            return int8_matmul(x, q, s, plan=plan)
        out["small_m after_write"] = {
            "plan": list(plans["small_m"]),
            "us": round(after_write_us(small, x, iters), 2)}
    if not f32:
        out["rule"] = "%d/%d" % fixed_rule(M, N, K, _sms(x.device),
                                           resident)
    return out


def resident_counts(dtype) -> dict:
    """The CUDA driver's counts the plans use for the form of ``dtype``,
    by cluster size 1 to MAX_SPLITS: clusters of the wgmma kernel (one
    block an SM; the 16-token tile's) and blocks of the small-M kernel
    (1 and 2 tiles of tokens) the card holds at once."""
    from dynamo_tpu_torch.ops.int8_gemm import MAX_SPLITS, resident_count

    return {f"{name} (tile {tile})": [resident_count(tile, s, dtype)
                                      for s in range(1, MAX_SPLITS + 1)]
            for name, tile in (("wgmma clusters", 16),
                               ("small_m blocks", 1),
                               ("small_m blocks", 2))}


def _sms(device) -> int:
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def main() -> None:
    import argparse

    import torch

    from dynamo_tpu_torch.models.quant import quantize_int8
    from dynamo_tpu_torch.ops.int8_gemm import (int8_gemm_tolerance,
                                                int8_gemm_work, int8_matmul)

    ap = argparse.ArgumentParser()
    ap.add_argument("--plans", action="store_true",
                    help="time every launch of each call (this tree only)")
    ap.add_argument("--rows", type=int, nargs="+", default=list(ROWS))
    ap.add_argument("--shapes", choices=("tp1", "tp2", "all"),
                    default="tp1")
    ap.add_argument("--write-x", action="store_true",
                    help="also time each call after a kernel that writes "
                         "its x")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float16", "float32"),
                    help="x's dtype (float32: at the 1b's shapes)")
    args = ap.parse_args()
    dtype = getattr(torch, args.dtype)
    if not torch.cuda.is_available():
        sys.exit("time_int8_gemm: no CUDA GPU available")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    res = {"tree": os.getcwd(), "card": power_limit(), "dtype": args.dtype,
           "us": {}, "digest": {}}
    if args.plans:
        print(json.dumps({"card": res["card"],
                          "resident": resident_counts(dtype)}), flush=True)
    shapes = {"tp1": SHAPES, "tp2": TP2_SHAPES,
              "all": {**SHAPES, **TP2_SHAPES}}[args.shapes]
    if dtype == torch.float32:
        shapes = {**SHAPES_1B, **(SHAPES if args.shapes == "all" else {})}
    for name, (K, N) in shapes.items():
        copies = max(1, min(64, -(-COLD_BYTES // (K * N))))
        ws = []
        for _ in range(copies):
            qw = quantize_int8(torch.randn(K, N, generator=g, device=dev)
                               / K ** 0.5)
            ws.append((qw.q, qw.s.reshape(-1)))
        for M in args.rows:
            x = torch.randn(M, K, generator=g, device=dev).to(dtype)
            q, s = ws[0]
            ref, tol = int8_gemm_tolerance(x, q, s)
            y = int8_matmul(x, q, s)
            over = float(((y.float() - ref).abs() - tol).max())
            if over > 0:
                sys.exit(f"time_int8_gemm: {name} M={M} is {over:.3g} past "
                         f"its tolerance")
            res["digest"][f"{name} M={M}"] = digest(y)
            del ref, tol, y
            if args.plans:
                print(json.dumps({"card": res["card"], "shape": name,
                                  "M": M, "K": K, "N": N,
                                  "us": sweep_plans(x, ws, M, K, N,
                                                    args.write_x)}),
                      flush=True)
                continue
            turn = itertools.count()

            def call():
                q, s = ws[next(turn) % copies]
                return int8_matmul(x, q, s)

            work = int8_gemm_work(M, K, N, dtype)
            iters = (20 if work["bound_ms"] < 0.2 else
                     5 if work["bound_ms"] < 2 else 2)
            cell = res["us"][f"{name} M={M}"] = {
                "times": [round(time_us(call, iters), 2)
                          for _ in range(REPEATS)],
                "bound": round(work["bound_ms"] * 1e3, 2)}
            if "bound_ffma_ms" in work:
                cell["bound_ffma"] = round(work["bound_ffma_ms"] * 1e3, 2)
            if args.write_x:
                cell["after_write"] = [round(after_write_us(call, x, iters),
                                             2) for _ in range(REPEATS)]
        del ws
        torch.cuda.empty_cache()
    if not args.plans:
        print(json.dumps(res))


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    main()
