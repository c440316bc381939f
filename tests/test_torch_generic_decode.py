"""The generic decode kernel, on the CPU, against the JAX package.

Route 0 of ``ops/csrc/paged_attention.cu`` (``paged_decode_generic_kernel``)
serves every decode shape outside routes 1-3, in float32, bfloat16 and
float16: any page size and GQA group, any head_dim up to the dtype's
shared-memory bound (past 256 in value-column tiles), the set the generic
prefill kernel takes. It runs only on
the card (tests/test_torch_kernels.py holds it to the plain version
there). Here, with inputs made with numpy from a seed and held to the JAX
kernel (``paged_attention_decode_layered`` with ``return_stats``, and the
window form ``_pool_window_attention_pallas``) in interpret mode:

- the wrapper's plain path (the CPU path) at the generic kernel's shapes:
  groups of 12, 16 and 71 on one kv head, pages of 1, 3, 48 and 256,
  head_dim 7, 16, 20, 80, 96 and 256, and 320 and 512 (two column
  tiles); a sliding window with the softcap, rows of length 0; atol 2e-2 in bfloat16 and float16 (one
  rounding of the output to the type), atol 1e-5 in float32;
- an emulation of the kernel's arithmetic in torch at the same shapes and
  tolerances: the plan's head tiles of 16 rows, a row's key blocks (16
  keys in 16 bits, 8 in float32) that cross page boundaries, cut into a
  cluster's splits (``decode_generic_shares``) and dealt to four warps,
  each warp's online softmax, the warps' merge and the splits' fold, the
  fused window's in-flight keys as blocks of split 0, past head_dim 256
  each value-column tile a block of its own that repeats the scores;
  in 16 bits the
  probabilities rounded to the type before P V, in float32 both products
  in 3xTF32 with each block's P V summed from zero (a control with one
  TF32 product must miss the tolerance); a page id outside the pool
  masked and never read;
- the plain float32 decode in fresh processes under each host setting
  that picks the CPU's float32 code paths (ATen's vector capability, one
  thread, MKL's instruction dispatch): within atol 1e-5 of the JAX
  kernel in every one, its exponent (float64, rounded once) bitwise the
  same in all;
- the routes by shape, the plan's cover of every (head, key) pair and
  its shared memory;
- a bfloat16 tiny engine with 12 heads on one kv head at page size 8
  (prefill and decode on the generic kernels on the card), whose greedy
  tokens equal JaxEngine's.
"""

import asyncio
import dataclasses
import itertools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.jax_engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.jax_engine import JaxEngine
from dynamo_tpu.llm.protocols.common import (PreprocessedRequest as
                                             JaxRequest)
from dynamo_tpu.llm.protocols.common import StopConditions as JaxStop
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import (_pool_window_attention_pallas as
                                     jax_pool_window_pallas)
from dynamo_tpu.ops.paged_attention import (
    paged_attention_decode_layered as jax_decode_layered)
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                   StopConditions)
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops import paged_attention as ops
from dynamo_tpu_torch.runtime.engine import Context

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = dict(rtol=0, atol=2e-2)
F32 = dict(rtol=0, atol=1e-5)
LOG2E = 1.4426950408889634
NEG_INF = ops.NEG_INF
DTYPES = ["float32", "bfloat16", "float16"]

# (name, head_dim, page size, group, kv heads, lengths, lower bounds,
# softcap or None): every row's pages distinct, one table entry to spare
CASES = [("group12_hd96_page48", 96, 48, 12, 1, [0, 1, 47, 130, 300],
          [0, 0, 0, 49, 0], None),
         ("group16_hd80_page3", 80, 3, 16, 1, [40, 7, 0], [0, 2, 0], None),
         ("mqa71_hd16_page1", 16, 1, 71, 1, [30, 5], [0, 0], None),
         ("page256_hd256", 256, 256, 2, 2, [300, 600, 0], [0, 257, 0],
          None),
         ("float32_hd7", 7, 5, 3, 2, [20, 9], [0, 0], None),
         ("sliding_softcap", 64, 8, 12, 2, [100, 37, 0], [70, 30, 0], 20.0),
         ("hd20_page16", 20, 16, 4, 2, [33, 5], [0, 0], None),
         ("wide_hd320_page16", 320, 16, 4, 1, [40, 0, 17], [0, 0, 3], None),
         ("wide_hd512_softcap", 512, 8, 12, 1, [30, 9], [2, 0], 20.0)]
# the window form's cases (a K = 4 window: start = the row's pool
# length, -1 for the padding row) and their sliding windows
WINDOW_CASES = [(CASES[0], None), (CASES[2], None), (CASES[5], 40),
                (CASES[8], None)]


def _inputs(case, dtype: str, L: int = 2):
    """q, the pools [L, N, KV, ps, hd], the page table, lengths and lower
    bounds of a case, as float32 numpy arrays of values exact in
    ``dtype``."""
    name, hd, ps, G, KV, lengths, lower, _ = case
    rng = np.random.RandomState(hd * ps + G)
    B = len(lengths)
    P = max(-(-n // ps) for n in lengths) + 1
    N = P * B + 2

    def exact(*shape):
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        return x.to(getattr(torch, dtype)).float().numpy()

    q = exact(B, KV * G, hd)
    kp, vp = exact(L, N, KV, ps, hd), exact(L, N, KV, ps, hd)
    table = np.stack([rng.permutation(np.arange(1, N))[:P]
                      for _ in range(B)]).astype(np.int32)
    return (q, kp, vp, table, np.array(lengths, np.int32),
            np.array(lower, np.int32))


def _window(case, dtype: str, K: int = 4):
    """wk, wv [B, K, KV, hd] of a case (exact in ``dtype``) and its
    window starts: the rows' lengths, the first row padding (-1)."""
    _, hd, _, _, KV, lengths, _, _ = case
    rng = np.random.RandomState(hd + KV)
    B = len(lengths)

    def exact(*shape):
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        return x.to(getattr(torch, dtype)).float().numpy()

    start = np.array([-1] + list(lengths[1:]), np.int32)
    return exact(B, K, KV, hd), exact(B, K, KV, hd), start


def _t(dtype: str, *arrays):
    dt = getattr(torch, dtype)
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        out.append(t.to(dt) if t.dtype == torch.float32 else t)
    return out


# ---------------------------------------------------- the kernel's arithmetic


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` as the kernels' tf32_rna takes it."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the 3xTF32 form: each operand a TF32 value and a
    remainder read as TF32 (13 low bits dropped), the small x small
    product left out."""
    def split(x):
        big = tf32(x)
        small = (x - big).contiguous().view(torch.int32) & -0x2000
        return big, small.view(torch.float32)
    ab, as_ = split(a)
    bb, bs = split(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product (the control)."""
    return tf32(a) @ tf32(b)


def generic_decode_emulated(q, k_pools, v_pools, layer, table, lengths=None,
                            lower=None, scale=1.0, softcap=None, splits=4,
                            window=None, mm=mm_3xtf32):
    """paged_decode_generic_kernel's arithmetic in torch, as its plan cuts
    the call: a block owns one (row, kv head, head tile of 16 rows, rows
    past the group zero) and split; the row's key blocks (plan.keys
    positions, key j on page table[b, j // ps] at slot j % ps, a page id
    outside the pool or past the table masked and not read) are cut into
    ``splits`` shares (decode_generic_shares); split 0 also walks the
    window's in-flight slots as blocks after its pool blocks. The
    split's blocks go to four warps in turn (a ring of plan.stages
    each); past head_dim 256 each of the plan's value-column tiles is a
    cluster of its own, which repeats the scores and folds and writes its
    columns alone; each warp's online softmax
    (exp2 of natural-unit scores times log2 e), S and P V by ``mm`` in
    float32 (each block's P V from zero), in 16 bits float32 products of
    the 16-bit values with P rounded to the type; the warps merged at the
    block's max, the splits folded at the joint max.
    ``window``: (start, q_pos, wk, wv, n_win, eff_win) of the fused
    window form, whose pool extent is [q_pos + 1 - eff_win, start).
    Returns float32 (out, m, l) as the kernel writes them."""
    B, H, hd = q.shape
    _, N, KV, ps, _ = k_pools.shape
    P = table.shape[1]
    G = H // KV
    f32 = q.dtype == torch.float32
    plan = ops.decode_generic_plan(G, ps, hd, q.dtype)
    kb, rows = plan.keys, plan.rows
    kf, vf, qf = k_pools[layer].float(), v_pools[layer].float(), q.float()
    out = torch.zeros(B, H, hd)
    m_out = torch.full((B, H), NEG_INF)
    l_out = torch.zeros(B, H)
    e2 = lambda x: torch.exp2(x * LOG2E)  # noqa: E731
    for b in range(B):
        if window is None:
            length, lo = int(lengths[b]), int(lower[b])
        else:
            start, qpos, wk, wv, n_win, eff = window
            length = max(int(start[b]), 0)
            lo = (min(max(int(qpos[b]) + 1 - int(eff[b]), 0), length)
                  if eff is not None else 0)
        shares = ops.decode_generic_shares(lo, length, P, ps, splits, plan)
        for kv, h0, c0 in itertools.product(range(KV), range(0, G, rows),
                                            range(0, hd, plan.col_width)):
            cols = slice(c0, min(c0 + plan.col_width, hd))
            gt = min(G - h0, rows)
            Q = torch.zeros(rows, hd)
            Q[:gt] = qf[b, kv * G + h0:kv * G + h0 + gt]
            parts = []
            for sp in range(max(len(shares), 1)):
                first, nb = shares[sp] if shares else (lo // kb, 0)
                blocks = [("pool", first + v) for v in range(nb)]
                if window is not None and sp == 0:
                    blocks += [("win", w) for w in
                               range(-(-wk.shape[1] // kb))]
                warps = []
                for w in range(4):
                    m = torch.full((rows,), NEG_INF)
                    l = torch.zeros(rows)
                    o = torch.zeros(rows, cols.stop - cols.start)
                    for kind, j in blocks[w::4]:
                        slot = torch.arange(j * kb, (j + 1) * kb)
                        if kind == "pool":
                            p = slot // ps
                            page = torch.where(
                                p < P, table[b, p.clamp(max=P - 1)].long(),
                                torch.tensor(-1))
                            vis = ((slot >= lo) & (slot < length)
                                   & (page >= 0) & (page < N))
                            pc = page.clamp(0, N - 1)
                            K, V = kf[pc, kv, slot % ps], vf[pc, kv, slot % ps]
                        else:
                            floor = (int(qpos[b]) - int(eff[b])
                                     if eff is not None else -(1 << 31))
                            vis = ((slot < wk.shape[1]) & (slot < n_win)
                                   & (int(start[b]) >= 0)
                                   & (int(start[b]) + slot > floor))
                            sc = slot.clamp(max=wk.shape[1] - 1)
                            K = wk[b, sc, kv].float()
                            V = wv[b, sc, kv].float()
                        if not vis.any():
                            continue
                        zero = torch.zeros(())
                        K = torch.where(vis[:, None], K, zero)
                        V = torch.where(vis[:, None], V[:, cols], zero)
                        x = (mm(Q, K.T) if f32 else Q @ K.T) * scale
                        if softcap:
                            x = softcap * torch.tanh(x / softcap)
                        mx = torch.where(vis, x, NEG_INF).amax(-1)
                        m_new = torch.maximum(m, mx)
                        alpha = e2(m - m_new)
                        pr = torch.where(vis, e2(x - m_new[:, None]), 0.0)
                        l = l * alpha + pr.sum(-1)
                        pv = (mm(pr, V) if f32
                              else pr.to(q.dtype).float() @ V)
                        o = o * alpha[:, None] + pv
                        m = m_new
                    warps.append((o, m, l))
                M = torch.stack([x[1] for x in warps]).amax(0)
                ew = [e2(x[1] - M) for x in warps]
                parts.append((sum(e[:, None] * x[0]
                                  for e, x in zip(ew, warps)),
                              M, sum(e * x[2] for e, x in zip(ew, warps))))
            ms = torch.stack([x[1] for x in parts])      # [S, rows]
            M = ms.amax(0).clamp(min=NEG_INF)
            es = e2(ms - M)
            L = (es * torch.stack([x[2] for x in parts])).sum(0)
            acc = sum(e[:, None] * x[0] for e, x in zip(es, parts))
            hs = slice(kv * G + h0, kv * G + h0 + gt)
            out[b, hs, cols] = (acc / L.clamp(min=1e-9)[:, None])[:gt]
            m_out[b, hs], l_out[b, hs] = M[:gt], L[:gt]
    return out, m_out, l_out


def _jax_decode(case, dtype, arrays, layer):
    q, kp, vp, table, lengths, lower = arrays
    jt = getattr(jnp, dtype)
    out, m, l = jax_decode_layered(
        jnp.asarray(q, jt), jnp.asarray(kp, jt), jnp.asarray(vp, jt),
        jnp.int32(layer), jnp.asarray(table), jnp.asarray(lengths),
        scale=case[1] ** -0.5, interpret=True, return_stats=True,
        softcap=case[7], lower=jnp.asarray(lower))
    return (np.asarray(out.astype(jnp.float32)), np.asarray(m),
            np.asarray(l))


@pytest.mark.parametrize("case,dtype", [(c, d) for c in CASES for d in DTYPES],
                         ids=[f"{c[0]}-{d}" for c in CASES for d in DTYPES])
def test_generic_decode_plain_and_emulation_match_jax_kernel(case, dtype):
    """At each generic shape, in each dtype, layer 1 of a 2-layer pool:
    the wrapper's plain path and the kernel's emulated arithmetic (a
    cluster of four splits) against the JAX kernel in interpret mode
    (atol 2e-2 in 16 bits, 1e-5 in float32), with the stats (m, l);
    length-0 rows zero with m = NEG_INF and l = 0."""
    arrays = _inputs(case, dtype)
    want = _jax_decode(case, dtype, arrays, 1)
    q, kp, vp, table, lengths, lower = _t(dtype, *arrays)
    tol = F32 if dtype == "float32" else BF16
    got = ops.paged_attention_decode_layered(
        q, kp, vp, 1, table, lengths, return_stats=True, softcap=case[7],
        lower=lower)
    emu = generic_decode_emulated(q, kp, vp, 1, table, lengths, lower,
                                  case[1] ** -0.5, case[7])
    for out, m, l in (got, emu):
        np.testing.assert_allclose(out.to(q.dtype).float().numpy(), want[0],
                                   **tol)
        np.testing.assert_allclose(m.numpy(), want[1], rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(l.numpy(), want[2], rtol=1e-5, atol=1e-5)
        empty = lengths == 0
        assert not out[empty].any() and not l[empty].any()
        assert (m[empty] == NEG_INF).all()


# one fresh process: the plain float32 decode of a case's saved inputs and
# the plain path's exponent of a fixed ramp, written beside them
PLAIN_WORKER = """
import sys
import numpy as np
import torch
from dynamo_tpu_torch.ops import paged_attention as ops

d = np.load(sys.argv[1])
t = {k: torch.from_numpy(d[k]) for k in d.files}
out, m, l = ops.paged_attention_decode_layered(
    t["q"], t["kp"], t["vp"], 1, t["table"], t["lengths"],
    return_stats=True, lower=t["lower"])
ramp = ops.exp_f32(torch.from_numpy(
    np.linspace(-80.0, 0.0, 100001).astype(np.float32)))
np.savez(sys.argv[2], out=out.numpy(), m=m.numpy(), l=l.numpy(),
         ramp=ramp.numpy(), cap=torch.backends.cpu.get_cpu_capability(),
         threads=torch.get_num_threads())
"""


def _host_settings() -> list:
    """The CPU settings that choose the host's float32 code paths: ATen's
    vector capability (each this processor offers), the thread count, and
    MKL's own instruction dispatch (its float32 exp and GEMM), as
    environment variables of a fresh process."""
    flags = open("/proc/cpuinfo").read().split()
    caps = ["default"] + [c for c, f in (("avx2", "avx2"),
                                         ("avx512", "avx512f")) if f in flags]
    out = [{"ATEN_CPU_CAPABILITY": c} for c in caps]
    out.append({"OMP_NUM_THREADS": "1"})
    out += [{"MKL_ENABLE_INSTRUCTIONS": i} for i, f in (
        ("SSE4_2", "sse4_2"), ("AVX2", "avx2")) if f in flags]
    out.append({"MKL_CBWR": "COMPATIBLE"})
    return out


def test_plain_float32_decode_holds_under_every_host_setting(tmp_path):
    """The plain float32 decode (the CPU serving path) against the JAX
    kernel at ``group12_hd96_page48`` in fresh processes, one a host
    setting (each ATen vector capability the processor offers, one
    thread, MKL's SSE4.2 / AVX2 dispatch and its compatible mode): within
    atol 1e-5 in every one; the plain path's exponent (``exp_f32``,
    float64 rounded once) bitwise the same in all of them, and the whole
    output bitwise the same wherever MKL keeps its own dispatch (only its
    GEMM then moves bits, within the tolerance)."""
    case = CASES[0]
    arrays = _inputs(case, "float32")
    want = _jax_decode(case, "float32", arrays, 1)
    np.savez(tmp_path / "in.npz", **dict(zip(
        ("q", "kp", "vp", "table", "lengths", "lower"), arrays)))
    (tmp_path / "plain.py").write_text(PLAIN_WORKER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "ATEN_CPU_CAPABILITY",
                        "OMP_NUM_THREADS", "MKL_ENABLE_INSTRUCTIONS",
                        "MKL_CBWR")}
    env["PYTHONPATH"] = REPO
    settings = _host_settings()
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "plain.py"), str(tmp_path / "in.npz"),
         str(tmp_path / f"out{i}.npz")], env={**env, **extra}, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i, extra in enumerate(settings)]
    outs = []
    for i, p in enumerate(procs):
        text = p.communicate(timeout=240)[0].decode()
        assert p.returncode == 0, f"{settings[i]}:\n{text[-3000:]}"
        outs.append(np.load(tmp_path / f"out{i}.npz"))
    for extra, got in zip(settings, outs):
        np.testing.assert_allclose(got["out"], want[0], rtol=0, atol=1e-5,
                                   err_msg=str(extra))
        np.testing.assert_allclose(got["m"], want[1], rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(got["l"], want[2], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got["ramp"], outs[0]["ramp"],
                                      err_msg=str(extra))
        if not any(k.startswith("MKL") for k in extra):
            np.testing.assert_array_equal(got["out"], outs[0]["out"],
                                          err_msg=str(extra))
    assert {str(o["cap"]) for o in outs} >= {"DEFAULT"}
    assert {int(o["threads"]) for o in outs} >= {1}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case,win", WINDOW_CASES,
                         ids=[c[0][0] for c in WINDOW_CASES])
def test_generic_decode_window_matches_jax(case, win, dtype):
    """The fused window form (the served path's): the pool plus 1 to 4
    in-flight keys in one softmax, the wrapper's plain path and the
    emulation (the window's slots as split 0's last block) against the
    JAX package's pool-window attention on its Pallas kernel, at the
    first and last step of a K = 4 window, with and without a sliding
    window; the padding row zero."""
    arrays = _inputs(case, dtype, L=1)
    wk, wv, start = _window(case, dtype)
    q, kp, vp, table, _, _ = _t(dtype, *arrays)
    wkt, wvt = _t(dtype, wk, wv)
    jt = getattr(jnp, dtype)
    scale = case[1] ** -0.5
    tol = F32 if dtype == "float32" else BF16
    B = q.shape[0]
    eff = None if win is None else torch.full((B,), win, dtype=torch.int32)
    for i in (0, 3):
        qpos = np.maximum(start + i, 0).astype(np.int32)
        want = jax_pool_window_pallas(
            jnp.asarray(arrays[0], jt)[:, None], jnp.asarray(arrays[1], jt),
            jnp.asarray(arrays[2], jt), jnp.int32(0), jnp.asarray(table),
            jnp.asarray(start), jnp.asarray(wk, jt), jnp.asarray(wv, jt), i,
            scale, interpret=True, q_pos=jnp.asarray(qpos), softcap=case[7],
            window=win, is_sliding=win is not None)
        want = np.asarray(want.astype(jnp.float32))[:, 0]
        st, qp = torch.from_numpy(start), torch.from_numpy(qpos)
        got = ops.paged_attention_decode_window(
            q, kp, vp, 0, table, st, qp, wkt, wvt, i + 1, softcap=case[7],
            eff_win=eff)
        emu, _, _ = generic_decode_emulated(
            q, kp, vp, 0, table, scale=scale, softcap=case[7],
            window=(st, qp, wkt, wvt, i + 1, eff))
        for out in (got, emu.to(q.dtype)):
            # row 0 is padding, which the JAX merge does not zero
            np.testing.assert_allclose(out.float().numpy()[1:], want[1:],
                                       **tol)
            assert not out[0].any()


def test_generic_decode_one_tf32_product_misses_float32():
    """The control: the emulation with one TF32 product for each float32
    product misses atol 1e-5, so the test can see the 3xTF32 form."""
    case = CASES[0]
    arrays = _inputs(case, "float32")
    want = _jax_decode(case, "float32", arrays, 1)
    q, kp, vp, table, lengths, lower = _t("float32", *arrays)
    emu, _, _ = generic_decode_emulated(q, kp, vp, 1, table, lengths, lower,
                                        case[1] ** -0.5, mm=mm_tf32)
    assert np.abs(emu.numpy() - want[0]).max() > 1e-5


def test_generic_decode_masks_pages_outside_the_pool():
    """A table entry outside [0, N) contributes nothing and is not read,
    as the kernel takes it: with row 1's entries 0 and 1 set to N + 3 and
    -2, the emulation equals the plain version over the row's other
    keys (its lower bound past those pages), and row 0 is unchanged."""
    case = CASES[1]
    q, kp, vp, table, lengths, lower = _t("float32",
                                          *_inputs(case, "float32"))
    N, ps = kp.shape[1], kp.shape[3]
    scale = case[1] ** -0.5
    bad = table.clone()
    bad[0, 0], bad[0, 1] = N + 3, -2
    got = generic_decode_emulated(q, kp, vp, 1, bad, lengths, lower, scale)
    past = lower.clone()
    past[0] = 2 * ps
    want = ops.decode_reference(q, kp, vp, 1, table, lengths, past, scale)
    np.testing.assert_allclose(got[0][0].numpy(), want[0][0].numpy(), **F32)
    np.testing.assert_allclose(got[2][0].numpy(), want[2][0].numpy(),
                               rtol=1e-5, atol=1e-5)
    ref = ops.decode_reference(q, kp, vp, 1, table, lengths, lower, scale)
    np.testing.assert_allclose(got[0][1:].numpy(), ref[0][1:].numpy(), **F32)


# ------------------------------------------------------- routes and plans


@pytest.mark.parametrize("dtype", DTYPES)
def test_generic_decode_routes_by_shape(dtype):
    """Every CASES shape of the dtype runs the generic decode kernel; the
    fast sets keep their routes (float32 route 2 up to 8 heads a kv head
    at the float32 set, 16 bits routes 1 and 3 at the bf16 set), and
    every group above 8, page 256 and head_dim 80 or 96 take route 0."""
    dt = getattr(torch, dtype)
    for _, hd, ps, G, KV, *_ in CASES:
        assert ops.decode_route(dt, KV * G, KV, ps, hd) == 0
        assert ops.prefill_generic_shape(dt, hd)
    fast = {"float32": 2, "bfloat16": 1, "float16": 3}[dtype]
    for hd in (16, 64, 80, 96, 128, 256):
        for ps in (1, 8, 16, 64, 128, 256):
            for G in (1, 8, 9, 12, 16, 71):
                if dtype == "float32":
                    inside = (hd in ops.F32_HEAD_DIMS
                              and ps in ops.F32_PAGE_SIZES and G <= 8)
                else:
                    inside = (hd in ops.DECODE_BF16_HEAD_DIMS
                              and ps in ops.DECODE_BF16_PAGE_SIZES and G <= 8)
                assert ops.decode_route(dt, 8 * G, 8, ps, hd) == (
                    fast if inside else 0), (hd, ps, G)


@pytest.mark.parametrize("dtype", DTYPES)
def test_generic_decode_plan_covers_every_pair_once(dtype):
    """The plan's head tiles cover every head of a group once, and the
    cut of a row's key blocks over any cluster covers every key of its
    extent once (each block in one split, as many live splits as the row
    fills rings of blocks, none past the cap the plan gives the cluster);
    at
    every head_dim the shared memory fits a block's 227 KB, two blocks an
    SM up to head_dim 128 (each block also takes 1 KB of the SM's
    228 KB), and the padded width holds the head_dim."""
    dt = getattr(torch, dtype)
    for G in (1, 3, 8, 12, 16, 17, 71, 128):
        plan = ops.decode_generic_plan(G, 8, 64, dt)
        heads = [t * plan.rows + r for t in range(plan.head_tiles)
                 for r in range(plan.rows) if t * plan.rows + r < G]
        assert heads == list(range(G)) and plan.heads == min(G, 16)
    for ps in (1, 3, 8, 48, 64, 256):
        plan = ops.decode_generic_plan(4, ps, 64, dt)
        kb = plan.keys
        for P in (1, 2, 7, 64):
            cap = ops.decode_generic_splits_cap(P, ps, plan)
            for S in ops.DECODE_CLUSTER_SIZES:
                for lo, length in ((0, 0), (0, 1), (5, 5), (3, 47),
                                   (0, 700), (190, 2000), (0, P * ps + 9)):
                    shares = ops.decode_generic_shares(lo, length, P, ps, S,
                                                       plan)
                    assert len(shares) <= min(S, cap)
                    keys = [k for first, n in shares
                            for k in range(first * kb, (first + n) * kb)]
                    assert len(keys) == len(set(keys))
                    end = min(length, P * ps)
                    assert [k for k in keys if lo <= k < end] == list(
                        range(lo, end)), (ps, P, S, lo, length)
                    # as many live splits as the row fills rings of
                    # blocks: each share non-empty, half a ring at least
                    # once there are two
                    least = plan.ring_keys // kb // 2 if len(shares) > 1 else 1
                    assert all(n >= least for _, n in shares)
    bound = ops.GENERIC_MAX_HEAD_DIM[dt]
    for hd in range(1, bound + 1):
        plan = ops.decode_generic_plan(4, 16, hd, dt)
        assert plan.head_dim >= hd and plan.head_dim % 16 == 0
        assert plan.keys == (8 if dtype == "float32" else 16)
        assert plan.smem <= ops.SMEM_LIMIT
        # the wide form (head_dim above 256): fewer stages, value-column
        # tiles of at most 256 columns
        assert plan.stages == (3 if hd <= 256 else
                               1 if dtype == "float32" else 2)
        assert plan.ring_keys == 4 * plan.stages * plan.keys
        assert plan.col_tiles == -(-hd // 256)
        assert plan.col_width * plan.col_tiles >= hd
        assert plan.col_width * (plan.col_tiles - 1) < hd
        if hd <= 128:
            assert 2 * (plan.smem + 1024) <= 228 * 1024, (hd, plan)
    for hd in (0, bound + 1):
        assert not ops.prefill_generic_shape(dt, hd)


# ------------------------------------------------------------- an engine


ECFG = dict(page_size=8, num_pages=64, max_batch=4, prefill_chunk=16,
            prefill_buckets=(16,), batch_buckets=(1, 2, 4), page_buckets=(8,),
            decode_steps=4)


def _generate(engine, request_cls, stop_cls, ctx_cls, prompt, n):
    async def run():
        toks = []
        try:
            req = request_cls(token_ids=list(prompt),
                              stop=stop_cls(max_tokens=n))
            async for out in engine.generate(req, ctx_cls()):
                toks += out.token_ids
        finally:
            await engine.stop()
        return toks
    return asyncio.run(run())


def test_bf16_engine_with_12_heads_a_kv_head_matches_jax_engine():
    """The tiny preset with 12 query heads on one kv head (Mistral-Large's
    group; head_dim 16) in bfloat16 at page size 8, so that on the card
    both its prefill and its decode run the generic kernels, on seed-3
    JAX params carried over by params_from_numpy, greedy on a 40-token
    prompt prefilled in three chunks and decoded in windows of 4: the
    port's tokens equal JaxEngine's."""
    over = dict(num_heads=12, num_kv_heads=1)
    jcfg = dataclasses.replace(JaxModelConfig.tiny(**over), dtype="bfloat16")
    tcfg = ModelConfig.tiny(dtype="bfloat16", **over)
    for route in (ops.decode_route, ops.prefill_route):
        assert route(torch.bfloat16, 12, 1, ECFG["page_size"], 16) == 0
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(3))
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                               tcfg, device="cpu")
    jeng = JaxEngine(jcfg, JaxEngineConfig(**ECFG), params=jparams)
    prompt = range(30, 70)
    want = _generate(jeng, JaxRequest, JaxStop, JaxContext, prompt, 8)
    teng = TorchEngine(tcfg, EngineConfig(**ECFG), params=params,
                       device="cpu")
    got = _generate(teng, PreprocessedRequest, StopConditions, Context,
                    prompt, 8)
    assert got == want
