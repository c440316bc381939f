"""Timeline of the small-M int8 kernel's blocks on the card.

    python -m dynamo_tpu_torch.ops.trace_int8_small [SPEC ...]
        [--patch 'OLD=>NEW' ...]

Builds an instrumented copy of ``csrc/int8_gemm.cu`` (into the build
directory) whose small-M kernel stamps ``%globaltimer`` at twelve points
of each block (entry, barriers set up, first weights issued, grid
dependency resolved, first and last stage of warp 0 landed, its loop
done, K groups folded, peers started, partials pushed, slices received,
end) and records its SM, launches it through ``int8_matmul`` in a CUDA
graph of four calls on copies of the weights (back to back, or each
after a kernel that writes x), and prints one JSON line a SPEC: per
call, the min / median / max over blocks of each stamp in µs from the
graph's first stamp, and how many blocks shared an SM with another block
of the same call. SPEC is ``shape:M:writer`` (writer 0 or 1), with
``:S<splits>`` to force the K splits and ``:nopdl`` to switch
programmatic launch off. ``--patch`` replaces a piece of the copy's
source before the build, to time a variant (the stamps' anchors must
still match). It finds where a call's time goes; the package's kernel
carries no stamps.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

SHAPES = {"wq_wo": (4096, 4096), "wk_wv": (4096, 1024),
          "gate_up": (4096, 14336), "down": (14336, 4096),
          "tp2 wq": (4096, 2048), "tp2 wk_wv": (4096, 512),
          "tp2 wo": (2048, 4096), "tp2 down": (7168, 4096)}
STAMPS = ["entry", "init", "issued", "waited", "first", "last", "loop",
          "red", "foldA", "pushed", "foldB", "end"]
SLOT = 16     # 64-bit words a block: the stamps, and its SM last
BLOCKS = 4096  # blocks a launch at most
CALLS = 4
NL, BS = "\n", "\\"


def instrumented(patches) -> str:
    """The kernels' source with the small-M kernel's stamps, then
    ``patches`` ("OLD=>NEW") applied."""
    from .build import CSRC

    with open(os.path.join(CSRC, "int8_gemm.cu")) as f:
        src = f.read()

    def patch(old, new):
        nonlocal src
        if old not in src:
            sys.exit(f"trace_int8_small: anchor not found: {old!r}")
        src = src.replace(old, new, 1)

    patch("namespace {" + NL, """namespace {
__device__ unsigned long long* g_trace = nullptr;
int g_trace_slot = 0;
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
""")
    patch("int splits, int cps, int early) {" + NL
          + "  using Tile = SmTile<MT, T>;",
          "int splits, int cps, int early, int trace_slot) {" + NL
          + "  using Tile = SmTile<MT, T>;")
    # the 16-bit consumer warps' loop (small_consume) stamps too
    patch("    int half, int group, int lane) {" + NL
          + "  using Tile = SmTile<MT, T>;",
          "    int half, int group, int lane, unsigned long long* tr, "
          "int tid) {" + NL + "  using Tile = SmTile<MT, T>;")
    patch("small_consume<MT, T>(smem, red, full, empty, n_st, half, group, "
          "lane);", "small_consume<MT, T>(smem, red, full, empty, n_st, "
          "half, group, lane, tr, tid);")
    patch("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;"
          + NL + "  const int rank = blockIdx.x % splits;",
          "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;"
          + NL + f"  unsigned long long* tr = g_trace ? g_trace + ((size_t)"
          f"trace_slot * {BLOCKS} + blockIdx.x) * {SLOT} : nullptr;" + NL
          + "  if (tr && tid == 0) { unsigned sm; asm volatile(\"mov.u32 %0, "
          "%%smid;\" : \"=r\"(sm)); tr[0] = gtime(); tr[15] = sm; }" + NL
          + "  const int rank = blockIdx.x % splits;")
    fence = ('    asm volatile("fence.mbarrier_init.release.cluster;' + BS
             + 'n" ::: "memory");' + NL)
    patch(fence + "    // every rank",
          fence + "    if (tr) tr[1] = gtime();" + NL + "    // every rank")
    patch("(c_begin + i) * SM_BK, n0, &full[i]);" + NL + "    }" + NL
          + "  } else if (tid < SM_BN) {",
          "(c_begin + i) * SM_BK, n0, &full[i]);" + NL + "    }" + NL
          + "    if (tr) tr[2] = gtime();" + NL
          + "  } else if (tid < SM_BN) {")
    patch("      grid_dep_wait();" + NL + "      for (int i = 0; i < n_st; ++i) {",
          "      grid_dep_wait();" + NL + "      if (tr) tr[3] = gtime();" + NL
          + "      for (int i = 0; i < n_st; ++i) {")
    patch("    mbar_wait(&full[st], (i / STAGES) & 1);" + NL,
          "    mbar_wait(&full[st], (i / STAGES) & 1);" + NL
          + "    if (tr && tid == 0) tr[i == group ? 4 : 5] = gtime();" + NL)
    bar = ('  asm volatile("bar.sync 1, %0;' + BS
           + 'n" ::"n"(SM_CONSUMERS) : "memory");' + NL)
    patch(bar + "#pragma unroll",
          "  if (tr && tid == 0) tr[6] = gtime();" + NL + bar + "#pragma unroll")
    wait_a = ("  if (splits > 1) cluster_wait_acquire();  "
              "// every peer has started" + NL)
    patch(wait_a, "  if (tr && tid == 0) tr[7] = gtime();" + NL + wait_a
          + "  if (tr && tid == 0) tr[8] = gtime();" + NL)
    tail = ("  if (splits == 1 || owned == 0) return;" + NL
            + "  mbar_wait_cluster(folded, 0);" + NL)
    patch(tail, "  if (tr && tid == 0) tr[splits == 1 ? 11 : 9] = gtime();"
          + NL + tail + "  if (tr && tid == 0) tr[10] = gtime();" + NL)
    last = ("    store2(y, sc, N, row, n0, col + 2, v.z, v.w);" + NL + "  }"
            + NL + "}")
    patch(last, last[:-1] + "  if (tr && tid == 0) tr[11] = gtime();" + NL
          + "}")
    patch("y, M, N, K, splits, cps, early);",
          "y, M, N, K, splits, cps, early, g_trace_slot++);")
    src += """
extern "C" int dyn_trace_set(void* p) {
  g_trace_slot = 0;
  return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p));
}
"""
    for p in patches:
        old, new = p.split("=>", 1)
        patch(old.replace(BS + "n", NL), new.replace(BS + "n", NL))
    return src


def load(patches):
    """Build the instrumented copy and point ``int8_matmul`` at it."""
    from . import build, int8_gemm

    out = os.path.join(build.build_dir(), "trace")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "int8_gemm.cu"), "w") as f:
        f.write(instrumented(patches))
    for h in os.listdir(build.CSRC):
        if h.endswith(".cuh"):
            with open(os.path.join(build.CSRC, h)) as f, \
                    open(os.path.join(out, h), "w") as g:
                g.write(f.read())
    so = os.path.join(out, f"libtrace-{os.getpid()}.so")
    done = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", so,
                           os.path.join(out, "int8_gemm.cu")],
                          capture_output=True, text=True)
    if done.returncode:
        sys.exit(f"trace_int8_small: nvcc failed:\n{done.stdout}"
                 f"{done.stderr}")
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dyn_int8_gemm.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.dyn_int8_gemm.restype = i
    lib.dyn_int8_gemm_resident.argtypes = [i, i, i]
    lib.dyn_int8_gemm_resident.restype = i
    lib.dyn_int8_gemm_programmatic.argtypes = [i]
    lib.dyn_int8_gemm_programmatic.restype = i
    lib.dyn_trace_set.argtypes = [p]
    lib.dyn_trace_set.restype = i
    lib._dyn_typed = True
    int8_gemm._lib = lambda: lib
    return lib


def run(lib, spec: str) -> dict:
    """One SPEC's graph of CALLS launches, traced (see the module)."""
    import torch

    from ..models.quant import quantize_int8
    from . import int8_gemm

    parts = spec.split(":")
    name, M, writer = parts[0], int(parts[1]), parts[2] == "1"
    K, N = SHAPES[name]
    dev = torch.device("cuda")
    plan = None
    for p in parts[3:]:
        if p.startswith("S"):
            plan = int8_gemm.Int8Plan("small_m", 1 if M <= 16 else 2,
                                      int(p[1:]), -(-N // 64) * int(p[1:]))
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
    ws = []
    for _ in range(CALLS):
        qw = quantize_int8(torch.randn(K, N, generator=g, device=dev)
                           / K ** 0.5)
        ws.append((qw.q, qw.s.reshape(-1)))
    x_src = x.clone()
    trace = torch.zeros(CALLS * BLOCKS * SLOT, dtype=torch.int64,
                        device=dev)
    lib.dyn_int8_gemm_programmatic(int("nopdl" not in parts))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for q, s in ws:
            int8_gemm.int8_matmul(x, q, s, plan=plan)
    torch.cuda.synchronize()
    lib.dyn_trace_set(ctypes.c_void_p(trace.data_ptr()))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for q, s in ws:
            if writer:
                torch.add(x_src, 0, out=x)
            int8_gemm.int8_matmul(x, q, s, plan=plan)
    plan = plan or int8_gemm.device_plan(M, N, K, dev)
    for _ in range(3):  # the last of three replays
        trace.zero_()
        graph.replay()
        torch.cuda.synchronize()
    lib.dyn_trace_set(ctypes.c_void_p(0))
    lib.dyn_int8_gemm_programmatic(1)
    tr = trace.view(CALLS, BLOCKS, SLOT)[:, :plan.grid].cpu()
    stamps = tr[:, :, :len(STAMPS)]
    t0 = int(stamps[stamps > 0].min())
    calls = []
    for c in range(CALLS):
        sm = tr[c, :, SLOT - 1].tolist()
        row = {"shared_sm": sum(sm.count(v) > 1 for v in sm)}
        for k, stamp in enumerate(STAMPS):
            v = tr[c, :, k]
            v = (v[v > 0] - t0).double() / 1e3
            if v.numel():
                row[stamp] = [round(float(v.min()), 2),
                              round(float(v.median()), 2),
                              round(float(v.max()), 2)]
        calls.append(row)
    return {"spec": spec, "plan": list(plan), "us": calls}


def main() -> None:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("specs", nargs="*",
                    default=["wk_wv:4:1", "wq_wo:4:1", "wk_wv:4:0"])
    ap.add_argument("--patch", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("trace_int8_small: no CUDA GPU available")
    lib = load(args.patch)
    for spec in args.specs:
        print(json.dumps(run(lib, spec)), flush=True)


if __name__ == "__main__":
    main()
