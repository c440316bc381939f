"""Profile the fused decode window of the 8B model on the GPU.

    python -m dynamo_tpu_torch.profile_step [--rows 4] [--context 512]

Builds the engine at Llama-3-8B widths (random weights, seed 0), prefills
``--rows`` rows of ``--context`` tokens, then times decode windows
(``EngineConfig.decode_steps`` steps each) with a device sync after each,
and traces one window with ``torch.profiler``. Prints one JSON object:
wall ms per window and per step, the kernels the window launched, the
device-busy time (the union of the kernels' intervals), the device's
idle share of the window's wall time, and the kernels that took the most
device time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--context", type=int, default=512)
    ap.add_argument("--windows", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .engine.sampling import SamplingBatch
    from .engine.torch_engine import EngineConfig, TorchEngine
    from .models.config import ModelConfig

    cfg = ModelConfig.llama3_8b()
    ecfg = EngineConfig()
    engine = TorchEngine(cfg, ecfg, seed=0, device="cuda")
    engine.warmup()
    dev = engine.device
    B, T, ps, K = args.rows, args.context, ecfg.page_size, ecfg.decode_steps
    pages_per_row = -(-(T + K * (args.windows + 2)) // ps)
    P = ecfg.bucket_pages(pages_per_row)
    table = np.zeros((B, P), np.int32)
    for b in range(B):
        table[b, :pages_per_row] = 1 + b * pages_per_row + np.arange(
            pages_per_row)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 256, (B, T)).astype(np.int32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    slots = (table[:, :, None] * ps + np.arange(ps)).reshape(B, -1)[:, :T]
    i32 = dict(dtype=torch.int32, device=dev)
    logits, kv_k, kv_v = engine.prefill_fn(
        engine.params, torch.tensor(tokens, **i32),
        torch.tensor(positions, **i32), engine.kv_k, engine.kv_v,
        torch.tensor(table, **i32),
        torch.tensor(slots.astype(np.int32), **i32),
        torch.full((B,), T - 1, **i32))
    sb = SamplingBatch.build([], B)
    state = {"tok": torch.argmax(logits, -1).to(torch.int32),
             "pos": torch.full((B,), T, **i32)}

    def window():
        toks, _, carry, _, _ = engine.decode_multi_fn(
            engine.params, state["tok"], state["pos"],
            torch.zeros(B, dtype=torch.bool, device=dev),
            torch.zeros((B,), **i32), torch.full((B,), 1 << 20, **i32),
            kv_k, kv_v, torch.tensor(table, **i32), sb.temperature,
            sb.top_k, sb.top_p, sb.seeds,
            torch.full((B, ecfg.max_eos_ids), -1, **i32), k_steps=K)
        toks.cpu()  # the engine reads each window's tokens back
        state["tok"], state["pos"] = carry[0], carry[1]

    window()
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.windows):
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        traced_wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type.name == "CUDA" and e.time_range is not None]
    busy = _union_ms([(e.time_range.start, e.time_range.end)
                      for e in kernels])
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()
    print(json.dumps({
        "card": card, "rows": B, "context": T, "steps_per_window": K,
        "window_wall_ms": sorted(walls),
        "step_wall_ms_median": sorted(walls)[len(walls) // 2] / K,
        "traced_window_wall_ms": traced_wall,
        "kernels_per_window": len(kernels),
        "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / traced_wall if traced_wall else None,
        "top_kernels": [{"name": n[:80], "ms": ms, "launches": c}
                        for n, (ms, c) in top],
    }, indent=1))


if __name__ == "__main__":
    main()
