#!/usr/bin/env python3
"""Device time of the attention kernels at chip_smoke.py's phase-5
shapes, for comparing two trees on one card.

    python3 time_attention.py [--dtype bfloat16|float16|float32]
                              [--prefill-route generic]
                              [--decode-route generic]  # from a checkout

Llama-3-8B attention widths (H=32, KV=8, head_dim 128, page 64), a random
pool of 512 pages and queries from a seed:
- prefill: one 512-token chunk from position 0 (page table of 8) and the
  fourth chunk of a 2048-token prompt (positions 1536-2047, table of 64);
- decode, window form, the last step of a K = 4 window (table of 64):
  the served window (4 rows of 40, 64, 86 and 656 positions), 32 rows of
  520 positions, 8 rows of 3,968 positions;
- the same through the tensor-parallel wrapper
  (paged_attention_decode_window_sharded) at the heads one rank holds at
  tp 2, 4 and 8 (32/tp q heads, 8/tp kv heads; a pool of those kv
  heads): the served window, and at tp=8 the long-row guard, 8 rows of
  3,968 positions.
With ``--dtype float32`` the same prefill and decode shapes run on
float32 pools (the float32 routes), with the served window also in the
order chip_smoke.py's phase 4 served its rows, and the 1b's heads
(head_dim 64) at the first chunk and the served window beside them; the
sharded shapes are bf16 and float16 only. ``--dtype float16`` takes
every shape of the bf16 run in float16 (the float16 forms of the bf16
kernels). Every dtype also times the generic kernels at the 8B's heads
with head_dim 96, outside every fast set (``_hd96`` keys): decode
(``paged_decode_generic_kernel``) at the served window and prefill (``paged_prefill_generic_kernel``) at the first
chunk; and the bfloat16 and float16 runs the chunk chip_smoke.py's phase
13 serves, Llama-3.2-1B's heads (head_dim 64) at page 8
(``first_chunk_1b_ps8``); and the float32 run the tiny preset's heads
(4 on 2 kv heads, head_dim 16, page 16) at its served 16-token chunk
(``first_chunk_tiny``). On a parent tree whose wrapper refuses a shape (a
16-bit generic prefill before the generic kernel took 16 bits) the error
is recorded under the shape's key instead of times; on a tree with the
generic kernel in every dtype a refusal fails the run.
``--prefill-route generic`` runs every prefill shape on the generic
kernel (the wrapper's route choice replaced for this run only), to weigh
it against the route each shape takes by default; ``--decode-route
generic`` does the same for every decode shape (the sharded ones
included).
Each shape is timed three times (CUDA graph of 50 launches,
chip_smoke.time_ms) and held to its plain version (the tolerance of its
dtype: bf16 and float16 atol 2e-2 + rtol 1e-2, float32 atol 1e-5); the
line also
carries a digest of each output's bits (``digest``), so that two trees'
kernels can be shown bitwise equal on the same seeded inputs.
Prints one JSON line. The script uses only what earlier trees of the
port have as well, so to compare a change with its parent, unpack the
parent into a git-ignored directory, copy this script beside its
chip_smoke.py, and run, in one chip call, parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

DECODE_SHAPES = (("served", [40, 64, 86, 656]), ("rows32", [520] * 32),
                 ("long8", [3968] * 8))
# float32 only: the served window's rows in the order phase 4 of
# chip_smoke.py served them, the order its phase 5 times (the row of 656
# positions second, not last)
F32_DECODE_SHAPES = (("served_phase4_order", [86, 656, 64, 40]),)
# (name, tp, contexts): the sharded wrapper at one rank's heads
SHARDED_SHAPES = (("served_tp2", 2, [40, 64, 86, 656]),
                  ("served_tp4", 4, [40, 64, 86, 656]),
                  ("served_tp8", 8, [40, 64, 86, 656]),
                  ("long8_tp8", 8, [3968] * 8))


def decode_case(kp, vp, ctx, B: int, P: int, K: int, H: int, g):
    """Operands of one fused-window decode call, the last of K steps, on
    layer 0 of the pools [L, N, KV, ps, hd]: row b of ``ctx`` holds ctx[b]
    positions on distinct random pages; rows past len(ctx) are padding
    (start -1). Returns (q, table, start, q_pos, wk, wv)."""
    import torch

    dev = kp.device
    N, KV, ps, hd = kp.shape[1:]
    pages = [-(-n // ps) for n in ctx]
    perm = torch.randperm(N - 1, generator=g, device=dev)[:sum(pages)] + 1
    table = torch.zeros((B, P), dtype=torch.int32, device=dev)
    used = 0
    for b, n in enumerate(pages):
        table[b, :n] = perm[used:used + n]
        used += n
    start = torch.tensor(list(ctx) + [-1] * (B - len(ctx)),
                         dtype=torch.int32, device=dev)
    qp = (start.clamp(min=0) + K - 1).to(torch.int32)
    q = torch.randn(B, H, hd, generator=g, device=dev).to(kp.dtype)
    wk = torch.randn(B, K, KV, hd, generator=g, device=dev).to(kp.dtype)
    wv = torch.randn(B, K, KV, hd, generator=g, device=dev).to(kp.dtype)
    return q, table, start, qp, wk, wv


def digest(t) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes."""
    import torch

    raw = t.contiguous().cpu().view(-1).view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float16", "float32"))
    ap.add_argument("--prefill-route", default=None, choices=("generic",),
                    help="run every prefill shape on this route")
    ap.add_argument("--decode-route", default=None, choices=("generic",),
                    help="run every decode shape on this route")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    from chip_smoke import excess, fail, time_ms
    from dynamo_tpu_torch.ops import paged_attention as ops
    from dynamo_tpu_torch.ops.paged_attention import (
        paged_attention_decode_window_sharded, window_reference)
    from dynamo_tpu_torch.parallel.mesh import MeshSpec

    if not torch.cuda.is_available():
        fail("no CUDA GPU available")
    dev = torch.device("cuda")
    dtype = getattr(torch, args.dtype)
    # chip_smoke.tolerance, spelled out: the parent trees' chip_smoke.py
    # this script runs beside may not have it
    tol = (1e-5, 0.0) if dtype == torch.float32 else (2e-2, 1e-2)
    g = torch.Generator(device=dev).manual_seed(7)
    N, KV, H, hd, ps, T, K = 512, 8, 32, 128, 64, 512, 4
    kp = torch.randn(1, N, KV, ps, hd, generator=g, device=dev).to(dtype)
    vp = torch.randn(1, N, KV, ps, hd, generator=g, device=dev).to(dtype)
    res = {"tree": os.getcwd(), "card": torch.cuda.get_device_name(0),
           "dtype": args.dtype, "digest": {}}
    if args.prefill_route == "generic":
        # the wrapper looks its route up by this module-level name
        ops.prefill_route = lambda *shape: 0
        res["prefill_route"] = "generic"
    if args.decode_route == "generic":
        ops.decode_route = lambda *shape: 0
        res["decode_route"] = "generic"
    f32 = dtype == torch.float32
    time_shapes(res, kp, vp, g, tol, T, K, H, "",
                decode=DECODE_SHAPES + (F32_DECODE_SHAPES if f32 else ()))
    # the generic kernels: head_dim 96 is in no fast set
    k96 = torch.randn(1, N, KV, ps, 96, generator=g, device=dev).to(dtype)
    v96 = torch.randn(1, N, KV, ps, 96, generator=g, device=dev).to(dtype)
    time_shapes(res, k96, v96, g, tol, T, K, H, "_hd96", deep=False,
                decode=DECODE_SHAPES[:1])
    del k96, v96
    if not f32:
        # the 1b's heads at page 8 (a pool of 1,024 pages, a table of 128)
        k8 = torch.randn(1, 1024, KV, 8, 64, generator=g, device=dev).to(dtype)
        v8 = torch.randn(1, 1024, KV, 8, 64, generator=g, device=dev).to(dtype)
        time_shapes(res, k8, v8, g, tol, T, K, H, "_1b_ps8", deep=False,
                    decode=(), first_pages=128)
        del k8, v8
    if f32:
        # the 1b's heads: head_dim 64
        k64 = torch.randn(1, N, KV, ps, 64, generator=g, device=dev)
        v64 = torch.randn(1, N, KV, ps, 64, generator=g, device=dev)
        time_shapes(res, k64, v64, g, tol, T, K, H, "_hd64", deep=False,
                    decode=DECODE_SHAPES[:1])
        del k64, v64
        # the tiny preset's heads at its served chunk
        k16 = torch.randn(1, N, 2, 16, 16, generator=g, device=dev)
        v16 = torch.randn(1, N, 2, 16, 16, generator=g, device=dev)
        time_shapes(res, k16, v16, g, tol, 16, K, 4, "_tiny", deep=False,
                    decode=())
        print(json.dumps(res))
        return
    for name, tp, ctx in SHARDED_SHAPES:
        kv, h = KV // tp, H // tp
        kl = torch.randn(1, N, kv, ps, hd, generator=g, device=dev).to(dtype)
        vl = torch.randn(1, N, kv, ps, hd, generator=g, device=dev).to(dtype)
        B, P = len(ctx), 64
        q, table, start, qp, wk, wv = decode_case(kl, vl, ctx, B, P, K, h, g)
        mesh = MeshSpec(model=tp).view(0)
        run = lambda: paged_attention_decode_window_sharded(  # noqa: E731
            q, kl, vl, 0, table, start, qp, wk, wv, K, mesh=mesh,
            kv_heads=KV)
        over = excess(run(), window_reference(q, kl, vl, 0, table, start, qp,
                                              wk, wv, K, hd ** -0.5),
                      2e-2, 1e-2)
        if over > 0:
            fail(f"decode {name}: off its plain version by {over:.3g}")
        res["digest"][f"decode_{name}"] = digest(run())
        res[f"decode_{name}"] = [time_ms(run, iters=50) for _ in range(3)]
    print(json.dumps(res))


def time_shapes(res: dict, kp, vp, g, tol, T: int, K: int, H: int,
                tag: str, deep: bool = True, decode=DECODE_SHAPES,
                first_pages: int = 8) -> None:
    """Time and digest the prefill chunks (the first, with a page table
    of ``first_pages`` entries, and the deep one when ``deep``) and the
    ``decode`` window shapes on the pools ``kp``/``vp`` [1, N, KV, ps, hd]
    into ``res``, each key suffixed by ``tag``. A chunk the wrapper
    refuses (ValueError) records its message on a tree without the
    generic kernel in every dtype, and fails the run on one with it."""
    import torch

    from chip_smoke import excess, fail, time_ms
    from dynamo_tpu_torch.ops import paged_attention as ops
    from dynamo_tpu_torch.ops.paged_attention import (
        NO_WINDOW, paged_attention_decode_window, paged_attention_prefill,
        prefill_reference, window_reference)

    dev = kp.device
    N, KV, ps, hd = kp.shape[1:]
    chunks = (("first_chunk", 0, first_pages), ("deep_chunk", 1536, 64))
    for name, start, P in chunks[:2 if deep else 1]:
        name += tag
        used = (start + T) // ps
        table = torch.zeros((1, P), dtype=torch.int32, device=dev)
        table[0, :used] = torch.randperm(N - 1, generator=g,
                                         device=dev)[:used] + 1
        pos = torch.arange(start, start + T, dtype=torch.int32,
                           device=dev)[None]
        win = torch.full((1,), NO_WINDOW, dtype=torch.int32, device=dev)
        q = torch.randn(1, T, H, hd, generator=g, device=dev).to(kp.dtype)
        run = lambda: paged_attention_prefill(  # noqa: E731
            q, kp[0], vp[0], table, pos, eff_win=win)
        try:
            out = run()
        except ValueError as e:
            if hasattr(ops, "prefill_generic_shape"):
                fail(f"prefill {name}: refused: {e}")
            res[name] = f"refused: {e}"
            continue
        over = excess(out, prefill_reference(q, kp[0], vp[0], table, pos,
                                             hd ** -0.5, None, win), *tol)
        if over > 0:
            fail(f"prefill {name}: off its plain version by {over:.3g}")
        res["digest"][name] = digest(run())
        res[name] = [time_ms(run, iters=50) for _ in range(3)]
    for name, ctx in decode:
        name = f"decode_{name}{tag}"
        B, P = len(ctx), 64
        q, table, start, qp, wk, wv = decode_case(kp, vp, ctx, B, P, K, H, g)
        run = lambda: paged_attention_decode_window(  # noqa: E731
            q, kp, vp, 0, table, start, qp, wk, wv, K)
        over = excess(run(), window_reference(q, kp, vp, 0, table, start, qp,
                                              wk, wv, K, hd ** -0.5), *tol)
        if over > 0:
            fail(f"{name}: off its plain version by {over:.3g}")
        res["digest"][name] = digest(run())
        res[name] = [time_ms(run, iters=50) for _ in range(3)]


if __name__ == "__main__":
    main()
