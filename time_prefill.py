#!/usr/bin/env python3
"""Device time of the bf16 prefill kernel at chip_smoke.py's two phase-5
shapes, for comparing two trees on one card.

    python3 time_prefill.py            # from the root of a checkout

Llama-3-8B attention widths (H=32, KV=8, head_dim 128, page 64): one
512-token chunk from position 0 (page table of 8) and the fourth chunk of
a 2048-token prompt (positions 1536-2047, page table of 64), random pool
and queries from a seed. Each shape is timed three times (CUDA graph of
50 launches, chip_smoke.time_ms) and held to its plain version (bf16
tolerance). Prints one JSON line. To compare a change with its parent,
unpack the parent into a git-ignored directory and run, in one chip call,
parent, change, change, parent.
"""

from __future__ import annotations

import json
import os
import sys


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import torch

    from chip_smoke import excess, fail, time_ms
    from dynamo_tpu_torch.ops.paged_attention import (NO_WINDOW,
                                                      paged_attention_prefill,
                                                      prefill_reference)

    if not torch.cuda.is_available():
        fail("no CUDA GPU available")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    N, KV, H, hd, ps, T = 512, 8, 32, 128, 64, 512
    kp = torch.randn(N, KV, ps, hd, generator=g, device=dev).to(torch.bfloat16)
    vp = torch.randn(N, KV, ps, hd, generator=g, device=dev).to(torch.bfloat16)
    res = {"tree": os.getcwd(), "card": torch.cuda.get_device_name(0)}
    for name, start, P in (("first_chunk", 0, 8), ("deep_chunk", 1536, 64)):
        used = (start + T) // ps
        table = torch.zeros((1, P), dtype=torch.int32, device=dev)
        table[0, :used] = torch.randperm(N - 1, generator=g,
                                         device=dev)[:used] + 1
        pos = torch.arange(start, start + T, dtype=torch.int32,
                           device=dev)[None]
        win = torch.full((1,), NO_WINDOW, dtype=torch.int32, device=dev)
        q = torch.randn(1, T, H, hd, generator=g, device=dev).to(torch.bfloat16)
        run = lambda: paged_attention_prefill(  # noqa: E731
            q, kp, vp, table, pos, eff_win=win)
        over = excess(run(), prefill_reference(q, kp, vp, table, pos,
                                               hd ** -0.5, None, win),
                      2e-2, 1e-2)
        if over > 0:
            fail(f"prefill {name}: off its plain version by {over:.3g}")
        res[name] = [time_ms(run, iters=50) for _ in range(3)]
    print(json.dumps(res))


if __name__ == "__main__":
    main()
