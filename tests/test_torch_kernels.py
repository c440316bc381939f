"""The CUDA kernels of the port against their plain PyTorch versions.

These run only where there is an NVIDIA GPU (``cuda`` marker; they skip
elsewhere, deciding inside the fixture): the kernels have no CPU mode.
The file imports nothing of JAX, so it runs on a machine without it:

    python -m pytest -m cuda tests/test_torch_kernels.py

Tolerances: atol 1e-5 in float32 (same math, another summation order);
atol 2e-2 + rtol 1e-2 in bfloat16 and in float16 (one or two bf16
roundings of the output at any magnitude, more than two float16 ones;
the bf16 kernels and their float16 forms also round the probabilities to
their type before P V). Over rows of thousands of keys, where the outputs
are as small as that tolerance, the bf16 decode kernel and its float16
form are also held to a tenth of the reference's rms. The int8 GEMM is
held to the float32 evaluation of its plain version within one rounding
of the output to x's dtype plus the float32 summation order
(``ops/int8_gemm.py int8_gemm_tolerance``). Each bf16 kernel's check
runs in both 16-bit types (``HALF``): bfloat16 on the bf16 kernel,
float16 on its float16 form."""

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.models.quant import QuantInt8, quantize_int8
from dynamo_tpu_torch.ops import int8_gemm
from dynamo_tpu_torch.ops import paged_attention as ops
from dynamo_tpu_torch.ops.int8_gemm import (int8_gemm_tolerance, int8_matmul,
                                            int8_matmul_plain)
from dynamo_tpu_torch.ops.paged_attention import (
    paged_attention_decode_layered, paged_attention_decode_window,
    paged_attention_prefill, window_reference)


def _np(x):
    return x.float().cpu().numpy()


# the 16-bit types, and the decode and prefill routes of each at the bf16
# kernels' shapes
HALF = [torch.bfloat16, torch.float16]
MMA_ROUTE = {torch.bfloat16: "bf16_mma", torch.float16: "f16_mma"}
PF_ROUTE = {torch.bfloat16: "bf16", torch.float16: "f16"}


def _counts(routes, **n):
    """Launch counts by route: ``n`` where named, 0 elsewhere."""
    assert set(n) <= set(routes), n
    return {r: n.get(r, 0) for r in routes}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


DTYPE_TOLS = [(torch.float32, 1e-5, 0.0), (torch.bfloat16, 2e-2, 1e-2),
              (torch.float16, 2e-2, 1e-2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,rtol", DTYPE_TOLS)
@pytest.mark.parametrize("rows", [5, 48])  # pages split over blocks / not
def test_cuda_decode_kernel_matches_plain(cuda_device, dtype, tol, rtol,
                                          rows):
    g = torch.Generator().manual_seed(0)
    L, N, KV, ps, hd, H, P = 2, 40, 8, 64, 128, 32, 6
    B = rows
    kp = torch.randn(L, N, KV, ps, hd, generator=g).to(dtype)
    vp = torch.randn(L, N, KV, ps, hd, generator=g).to(dtype)
    q = torch.randn(B, H, hd, generator=g).to(dtype)
    table = torch.randint(1, N, (B, P), generator=g, dtype=torch.int32)
    lengths = torch.tensor([0, 1, 64, 300, 384] * (B // 5) + [17] * (B % 5),
                           dtype=torch.int32)
    lower = torch.tensor([0, 0, 10, 200, 0] * (B // 5) + [3] * (B % 5),
                         dtype=torch.int32)
    for layer in range(L):
        want = paged_attention_decode_layered(
            q, kp, vp, layer, table, lengths, return_stats=True,
            softcap=30.0, lower=lower)
        got = paged_attention_decode_layered(
            *(t.to(cuda_device) for t in (q, kp, vp)), layer,
            *(t.to(cuda_device) for t in (table, lengths)),
            return_stats=True, softcap=30.0, lower=lower.to(cuda_device))
        np.testing.assert_allclose(_np(got[0].cpu()), _np(want[0]),
                                   rtol=rtol, atol=tol)
        # the float32 stats: l sums up to hundreds of terms
        for w, x in zip(want[1:], got[1:]):
            np.testing.assert_allclose(_np(x.cpu()), _np(w), rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,rtol", DTYPE_TOLS)
def test_cuda_prefill_kernel_matches_plain(cuda_device, dtype, tol, rtol):
    g = torch.Generator().manual_seed(1)
    N, KV, ps, hd, B, H, P, T = 40, 8, 64, 128, 2, 32, 8, 96
    kp = torch.randn(N, KV, ps, hd, generator=g).to(dtype)
    vp = torch.randn(N, KV, ps, hd, generator=g).to(dtype)
    q = torch.randn(B, T, H, hd, generator=g).to(dtype)
    table = torch.randint(1, N, (B, P), generator=g, dtype=torch.int32)
    pos = torch.full((B, T), -1, dtype=torch.int32)
    pos[0] = torch.arange(64, 64 + T)
    pos[1, :50] = torch.arange(50)
    win = torch.tensor([40, 1 << 30], dtype=torch.int32)
    want = paged_attention_prefill(q, kp, vp, table, pos, eff_win=win)
    got = paged_attention_prefill(
        *(t.to(cuda_device) for t in (q, kp, vp, table, pos)),
        eff_win=win.to(cuda_device))
    np.testing.assert_allclose(_np(got.cpu()), _np(want), rtol=rtol,
                               atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,rtol", DTYPE_TOLS)
@pytest.mark.parametrize("window", [None, 50])
def test_cuda_decode_window_matches_plain(cuda_device, dtype, tol, rtol,
                                          window):
    """The fused-window form: pool pages + the in-flight buffer, folded in
    the decode kernel."""
    from dynamo_tpu_torch.ops.paged_attention import (
        paged_attention_decode_window, window_reference)

    g = torch.Generator().manual_seed(2)
    L, N, KV, ps, hd, H, P, Kw = 2, 40, 8, 64, 128, 32, 6, 4
    start = torch.tensor([-1, 0, 64, 200, 380], dtype=torch.int32)
    B = start.numel()
    kp = torch.randn(L, N, KV, ps, hd, generator=g).to(dtype)
    vp = torch.randn(L, N, KV, ps, hd, generator=g).to(dtype)
    q = torch.randn(B, H, hd, generator=g).to(dtype)
    wk = torch.randn(B, Kw, KV, hd, generator=g).to(dtype)
    wv = torch.randn(B, Kw, KV, hd, generator=g).to(dtype)
    table = torch.randint(1, N, (B, P), generator=g, dtype=torch.int32)
    qp = (start.clamp(min=0) + 2).to(torch.int32)
    eff = None if window is None else torch.full((B,), window,
                                                 dtype=torch.int32)
    want = window_reference(q, kp, vp, 1, table, start, qp, wk, wv, 3,
                            hd ** -0.5, 20.0, eff)
    d = cuda_device
    got = paged_attention_decode_window(
        q.to(d), kp.to(d), vp.to(d), 1, table.to(d), start.to(d), qp.to(d),
        wk.to(d), wv.to(d), 3, softcap=20.0,
        eff_win=None if eff is None else eff.to(d))
    np.testing.assert_allclose(_np(got.cpu()), _np(want), rtol=rtol,
                               atol=tol)
    assert (got[0] == 0).all()


def _prefill_case(dev, G, hd, ps, pos, win=None, softcap=None, KV=2,
                  seed=3, dtype=torch.bfloat16, route=None):
    """The bf16 prefill kernel (or its float16 form; or ``route``) and its
    plain version on one input: q and the pool from a seed, each row's
    pages distinct and shuffled."""
    g = torch.Generator().manual_seed(seed)
    B, T = pos.shape
    used = -(-(int(pos.max()) + 1) // ps)
    N, P = 2 * used + 4, used + 2  # trailing table entries stay 0
    kp = torch.randn(N, KV, ps, hd, generator=g).to(dtype)
    vp = torch.randn(N, KV, ps, hd, generator=g).to(dtype)
    q = torch.randn(B, T, KV * G, hd, generator=g).to(dtype)
    table = torch.zeros((B, P), dtype=torch.int32)
    for b in range(B):
        table[b, :used] = torch.randperm(N - 1, generator=g)[:used] + 1
    want = paged_attention_prefill(q, kp, vp, table, pos, softcap=softcap,
                                   eff_win=win)
    ops.reset_launch_counts()
    got = paged_attention_prefill(
        *(t.to(dev) for t in (q, kp, vp, table, pos)), softcap=softcap,
        eff_win=None if win is None else win.to(dev))
    torch.cuda.synchronize()
    assert ops.PREFILL_ROUTE_LAUNCHES == _counts(
        ops.PREFILL_ROUTES, **{route or PF_ROUTE[dtype]: 1})
    return got.cpu(), want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 7, 8])
def test_cuda_bf16_prefill_kernel_matches_plain(cuda_device, G, hd, ps,
                                                dtype):
    """Groups that do and do not divide the 64 rows of a block (G = 7:
    9 queries, one padding row): a chunk continuing at position 40, a
    row with padding queries at its end, and a row of padding only."""
    T = 80
    pos = torch.full((3, T), -1, dtype=torch.int32)
    pos[0] = torch.arange(40, 40 + T)
    pos[1, :33] = torch.arange(33)
    got, want = _prefill_case(cuda_device, G, hd, ps, pos, dtype=dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=2e-2)
    assert (got[1, 33:] == 0).all() and (got[2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
def test_cuda_bf16_prefill_deep_chunk(cuda_device, dtype):
    """The fourth 512-token chunk of a 2048-token prompt at the 8B widths:
    every block walks 25 to 32 pages."""
    pos = torch.arange(1536, 2048, dtype=torch.int32)[None]
    got, want = _prefill_case(cuda_device, 4, 128, 64, pos, KV=8,
                              dtype=dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("ps", [16, 128])
def test_cuda_bf16_prefill_window_and_softcap(cuda_device, ps, dtype):
    """Sliding windows of 100 and 7 keys with the Gemma-2 softcap: key
    blocks wholly below a block's window are skipped."""
    T = 96
    pos = torch.stack([torch.arange(200, 200 + T),
                       torch.arange(300, 300 + T)]).to(torch.int32)
    pos[1, 70:] = -1
    win = torch.tensor([100, 7], dtype=torch.int32)
    got, want = _prefill_case(cuda_device, 4, 128, ps, pos, win=win,
                              softcap=30.0, dtype=dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=2e-2)
    assert (got[1, 70:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("hd,ps,G", [(32, 64, 4), (96, 64, 4), (128, 8, 4),
                                     (128, 48, 4), (128, 64, 16)])
def test_cuda_bf16_prefill_refuses_shapes_it_is_not_built_for(
        cuda_device, hd, ps, G, dtype):
    """The bf16 prefill kernel and its float16 form are built for head_dim
    64/128/256, pages of 16/32/64/128 and groups up to 8; the shapes
    outside (head_dim 32 or 96, page 8 or 48, a group of 16) run the
    generic kernel in the same 16-bit type, held to its plain version at
    the bf16 tolerance: a chunk continuing at position 40, a row with
    padding queries and a row of padding only, then the same with a
    sliding window and the softcap."""
    T = 80
    pos = torch.full((3, T), -1, dtype=torch.int32)
    pos[0] = torch.arange(40, 40 + T)
    pos[1, :33] = torch.arange(33)
    win = torch.tensor([30, 7, 1 << 30], dtype=torch.int32)
    for w, softcap in ((None, None), (win, 20.0)):
        got, want = _prefill_case(cuda_device, G, hd, ps, pos, win=w,
                                  softcap=softcap, dtype=dtype,
                                  route="generic")
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2,
                                   atol=2e-2)
        assert (got[1, 33:] == 0).all() and (got[2] == 0).all()


def _decode_pool(G, hd, ps, rows_pages, KV=2, L=2, seed=4,
                 dtype=torch.bfloat16):
    """A pool, queries and a page table from a seed: row b holds
    ``rows_pages[b]`` distinct shuffled pages, the rest of the table 0."""
    g = torch.Generator().manual_seed(seed)
    B, P = len(rows_pages), max(max(rows_pages), 1) + 2
    N = sum(rows_pages) + 4
    kp = torch.randn(L, N, KV, ps, hd, generator=g).to(dtype)
    vp = torch.randn(L, N, KV, ps, hd, generator=g).to(dtype)
    q = torch.randn(B, KV * G, hd, generator=g).to(dtype)
    table = torch.zeros((B, P), dtype=torch.int32)
    pages = torch.randperm(N - 1, generator=g) + 1
    used = 0
    for b, n in enumerate(rows_pages):
        table[b, :n] = pages[used:used + n]
        used += n
    return q, kp, vp, table


def _decode_check(dev, q, kp, vp, table, lengths, lower, softcap=None,
                  tol=2e-2, rtol=1e-2):
    """The decode kernel (stats form, every layer) against its plain
    version; returns the kernel's output of the last layer."""
    lengths = torch.tensor(lengths, dtype=torch.int32)
    lower = torch.tensor(lower, dtype=torch.int32)
    for layer in range(kp.shape[0]):
        want = paged_attention_decode_layered(
            q, kp, vp, layer, table, lengths, return_stats=True,
            softcap=softcap, lower=lower)
        got = paged_attention_decode_layered(
            *(t.to(dev) for t in (q, kp, vp)), layer,
            *(t.to(dev) for t in (table, lengths)), return_stats=True,
            softcap=softcap, lower=lower.to(dev))
        torch.cuda.synchronize()
        np.testing.assert_allclose(_np(got[0].cpu()), _np(want[0]),
                                   rtol=rtol, atol=tol)
        np.testing.assert_allclose(_np(got[1].cpu()), _np(want[1]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(got[2].cpu()), _np(want[2]),
                                   rtol=1e-4, atol=1e-5)
    return got[0].cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("ps", [16, 32, 64, 128])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 7, 8])
def test_cuda_bf16_decode_kernel_matches_plain(cuda_device, G, hd, ps,
                                               dtype):
    """Every head_dim x page size of the bf16 kernel, GQA groups that fill
    1 to 8 of the 8 head rows: rows of one key, of a page and a bit, of
    several pages with ``lower`` inside a page, a length-0 row, and a
    sliding view that masks everything (lower == length)."""
    lengths = [1, ps + 3, 5 * ps - 7, 0, 2 * ps + 5, 3 * ps]
    lower = [0, 0, ps + 9, 0, 2 * ps + 5, ps // 2]
    pages = [-(-n // ps) for n in lengths]
    q, kp, vp, table = _decode_pool(G, hd, ps, pages, dtype=dtype)
    ops.reset_launch_counts()
    got = _decode_check(cuda_device, q, kp, vp, table, lengths, lower,
                        softcap=30.0 if G == 7 else None)
    assert ops.DECODE_ROUTE_LAUNCHES == _counts(ops.DECODE_ROUTES,
                                                **{MMA_ROUTE[dtype]: 2})
    assert (got[3] == 0).all() and (got[4] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("rows", [3, 24])
def test_cuda_bf16_decode_long_rows(cuda_device, rows, dtype):
    """Rows of 40 to 62 pages at the 8B widths: at 3 rows each row's pages
    are split over about 11 blocks, at 24 rows the rows x kv heads fill
    most of the card and each block walks every page of its row.

    Over 2,560+ keys the outputs are small (rms ~0.03), so the bf16
    tolerance alone would pass a kernel that lost a 16-key block per row:
    the output is also held to a tenth of the reference's rms, which the
    reference one 16-key block short (``lower + 16``) exceeds."""
    rng = np.random.RandomState(5)
    lengths = [int(x) for x in rng.randint(40 * 64, 62 * 64, rows)]
    lower = [0] * (rows - 1) + [1000]
    q, kp, vp, table = _decode_pool(4, 128, 64, [-(-n // 64) for n in lengths],
                                    KV=8, L=1, dtype=dtype)
    first = _decode_check(cuda_device, q, kp, vp, table, lengths, lower)
    # a second call folds alike (no state is left between calls)
    again = _decode_check(cuda_device, q, kp, vp, table, lengths, lower)
    assert torch.equal(first, again)
    ln, lo = (torch.tensor(x, dtype=torch.int32) for x in (lengths, lower))
    want = paged_attention_decode_layered(q, kp, vp, 0, table, ln,
                                          lower=lo).float()
    short = paged_attention_decode_layered(q, kp, vp, 0, table, ln,
                                           lower=lo + 16).float()
    limit = 0.1 * float(want.pow(2).mean().sqrt())
    assert float((first.float() - want).abs().max()) <= limit
    assert float((first.float() - short).abs().max()) > limit


def _rows_within_rms(got, want, short, rows):
    """Each of ``rows`` of the kernel's output within a tenth of the plain
    output's rms in that row, a limit the plain version one 16-key block
    short (``short``, the control) exceeds in that row."""
    for b in rows:
        limit = 0.1 * float(want[b].float().pow(2).mean().sqrt())
        assert float((got[b].float() - want[b].float()).abs().max()) <= limit
        assert float((short[b].float() - want[b].float()).abs().max()) > limit


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_cuda_bf16_decode_cluster_splits_at_one_ranks_heads(cuda_device, tp,
                                                            dtype):
    """The bf16 kernel's cluster of splits at the heads one rank of tp
    holds of the 8B widths (32/tp q heads, 8/tp kv heads) in the 64-page
    bucket, where the plan takes clusters of 4 (tp=1) or 8: rows of no
    page, of one key, of fewer pages than one split's least (one live
    split), of 7 pages (3 live splits), of 40 pages (more than the
    splits), and of 5 pages whose last page id lies outside the pool
    (skipped: held to the same row without that page). Stats form with
    softcap and ``lower``, then the window form at step 3 of K = 4 with a
    row whose only keys are the window's. Held to the plain version at
    the bf16 tolerance and per row to a tenth of its rms, which the plain
    version one 16-key block short exceeds."""
    KV, G, hd, ps, P = 8 // tp, 4, 128, 64, 64
    pages = [0, 1, 3, 7, 40, 5]
    lengths = [0, 1, 3 * ps - 20, 7 * ps - 1, 40 * ps - 9, 5 * ps - 3]
    lo = torch.tensor([0, 0, 0, 70, 1000, 0], dtype=torch.int32)
    q, kp, vp, narrow = _decode_pool(G, hd, ps, pages, KV=KV, L=1, seed=tp,
                                     dtype=dtype)
    B, N = len(pages), kp.shape[1]
    table = torch.zeros((B, P), dtype=torch.int32)
    table[:, :narrow.shape[1]] = narrow
    table[5, 4] = N + 7
    ln = torch.tensor(lengths, dtype=torch.int32)
    # the plain version sees row 5 without its last page
    t_ref, ln_ref = table.clone(), ln.clone()
    t_ref[5, 4], ln_ref[5] = 0, 4 * ps
    scale, d = hd ** -0.5, cuda_device
    want = ops.decode_reference(q, kp, vp, 0, t_ref, ln_ref, lo, scale, 30.0)
    short = ops.decode_reference(q, kp, vp, 0, t_ref, ln_ref, lo + 16, scale,
                                 30.0)
    ops.reset_launch_counts()
    got = paged_attention_decode_layered(
        q.to(d), kp.to(d), vp.to(d), 0, table.to(d), ln.to(d),
        return_stats=True, softcap=30.0, lower=lo.to(d))
    torch.cuda.synchronize()
    got = [t.cpu() for t in got]
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-2,
                               atol=2e-2)
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_np(got[2]), _np(want[2]), rtol=1e-4,
                               atol=1e-5)
    assert (got[0][0] == 0).all() and (got[2][0] == 0).all()
    assert (got[1][0] == ops.NEG_INF).all()
    _rows_within_rms(got[0], want[0], short[0], range(1, B))

    Kw, n_win = 4, 3
    g = torch.Generator().manual_seed(10 + tp)
    wk = torch.randn(B, Kw, KV, hd, generator=g).to(dtype)
    wv = torch.randn(B, Kw, KV, hd, generator=g).to(dtype)
    start = torch.tensor([-1, 0] + lengths[2:5] + [4 * ps],
                         dtype=torch.int32)
    qp = (start.clamp(min=0) + n_win - 1).to(torch.int32)
    args = (q, kp, vp, 0, t_ref, start, qp, wk, wv, n_win)
    want = window_reference(*args, scale)
    short = window_reference(*args, scale, None, (qp + 1 - 16).to(torch.int32))
    out = paged_attention_decode_window(
        *(a.to(d) if torch.is_tensor(a) else a for a in args)).cpu()
    np.testing.assert_allclose(_np(out), _np(want), rtol=1e-2, atol=2e-2)
    assert (out[0] == 0).all()
    _rows_within_rms(out, want, short, range(1, B))
    assert ops.DECODE_ROUTE_LAUNCHES == _counts(ops.DECODE_ROUTES,
                                                **{MMA_ROUTE[dtype]: 2})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("KV", [8, 1])
def test_cuda_bf16_decode_graph_replay_equals_eager(cuda_device, KV, dtype):
    """A captured cluster launch, replayed, gives the eager call's output
    and stats bit for bit, at full heads (clusters of 4) and at tp=8's
    (clusters of 8); layered with stats, and the window form."""
    lengths = [40, 64 * 11 - 3, 0, 86]
    q, kp, vp, narrow = _decode_pool(4, 128, 64, [1, 11, 0, 2], KV=KV, L=1,
                                     dtype=dtype)
    d = cuda_device
    B = len(lengths)
    table = torch.zeros((B, 64), dtype=torch.int32)
    table[:, :narrow.shape[1]] = narrow
    q, kp, vp, table = (t.to(d) for t in (q, kp, vp, table))
    ln = torch.tensor(lengths, dtype=torch.int32, device=d)
    g = torch.Generator().manual_seed(3)
    wk = torch.randn(B, 4, KV, 128, generator=g).to(dtype).to(d)
    wv = torch.randn(B, 4, KV, 128, generator=g).to(dtype).to(d)
    start = torch.tensor([40, 701, -1, 86], dtype=torch.int32, device=d)
    qp = (start.clamp(min=0) + 3).to(torch.int32)

    def calls():
        return (*paged_attention_decode_layered(q, kp, vp, 0, table, ln,
                                                return_stats=True),
                paged_attention_decode_window(q, kp, vp, 0, table, start, qp,
                                              wk, wv, 4))

    eager = calls()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = calls()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_bf16_decode_calls_in_flight_on_two_streams(cuda_device):
    """Splitting bf16 calls in flight on two streams at once, each stream
    with its own queries, at full heads and at tp=8's: every call folds
    its own splits (no state is shared between calls)."""
    lengths = [3000, 2600, 3900, 700]
    d = cuda_device
    for KV in (8, 1):
        q, kp, vp, table = _decode_pool(4, 128, 64,
                                        [-(-n // 64) for n in lengths],
                                        KV=KV, L=1)
        q2 = torch.flip(q, dims=[0]).contiguous()
        ln = torch.tensor(lengths, dtype=torch.int32)
        wants = [paged_attention_decode_layered(x, kp, vp, 0, table, ln)
                 for x in (q, q2)]
        kd, vd, td, lnd = (t.to(d) for t in (kp, vp, table, ln))
        qs = [q.to(d), q2.to(d)]
        paged_attention_decode_layered(qs[0], kd, vd, 0, td, lnd)  # plan
        streams = [torch.cuda.Stream(), torch.cuda.Stream()]
        for s in streams:
            s.wait_stream(torch.cuda.current_stream())
        outs = [[], []]
        for _ in range(20):
            for s, x, out in zip(streams, qs, outs):
                with torch.cuda.stream(s):
                    out.append(paged_attention_decode_layered(x, kd, vd, 0,
                                                              td, lnd))
        torch.cuda.synchronize()
        for want, out in zip(wants, outs):
            limit = 0.1 * float(want.float().pow(2).mean().sqrt())
            for got in out:
                np.testing.assert_allclose(_np(got.cpu()), _np(want),
                                           rtol=0, atol=limit)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
def test_cuda_decode_bf16_shape_set_matches_the_kernel(cuda_device, dtype):
    """The wrapper's bf16 decode set (decode_route,
    DECODE_BF16_MAX_SPLITS) is the set the C side takes on route 1 (bf16)
    and route 3 (its float16 form): shapes inside get a cluster occupancy
    answer (at least one cluster of every size the plan picks from, as
    many as the bf16 kernel's), shapes outside are refused, and so are a
    cluster past DECODE_BF16_MAX_SPLITS and the other types. float32
    takes route 2 (the float32 kernel's set) or 0, never route 1 or 3;
    the float16 prefill set is the bf16 one, on route 3."""
    import ctypes

    lib, plib = ops._lib(), ops._prefill_lib()
    rt = 1 if dtype == torch.bfloat16 else 3
    code = ops._DTYPES[dtype]
    n, n_bf16 = ctypes.c_int(0), ctypes.c_int(0)
    stream = torch.cuda.current_stream().cuda_stream
    scratch = torch.zeros(16, device=cuda_device).data_ptr()
    for hd in (32, 64, 96, 128, 256, 512):
        for ps in (8, 16, 32, 48, 64, 128, 256):
            for G in (1, 3, 8, 9):
                route = ops.decode_route(dtype, 2 * G, 2, ps, hd)
                assert route in (0, rt)
                err = lib.dyn_paged_decode_clusters(rt, code, 2 * G, 2, ps,
                                                    hd, 1, ctypes.byref(n))
                assert (err == 0) == (route == rt), (hd, ps, G)
                assert ops.decode_route(torch.float32, 2 * G, 2, ps, hd) in (
                    0, 2)
                assert ops.prefill_route(dtype, 2 * G, 2, ps, hd) == route
                # B = 0: the prefill entry checks its arguments only
                err = plib.dyn_paged_attention_prefill(
                    rt, code, *[scratch] * 7, 0, 4, 2 * G, 2, 8, ps, hd, 4,
                    1.0, 0.0, stream)
                assert (err == 0) == (route == rt), (hd, ps, G)
    for hd in ops.DECODE_BF16_HEAD_DIMS:
        for S in ops.DECODE_CLUSTER_SIZES:
            n.value = n_bf16.value = 0
            assert lib.dyn_paged_decode_clusters(rt, code, 32, 8, 64, hd, S,
                                                 ctypes.byref(n)) == 0
            assert lib.dyn_paged_decode_clusters(1, 1, 32, 8, 64, hd, S,
                                                 ctypes.byref(n_bf16)) == 0
            assert n.value >= 1 and n.value == n_bf16.value, (hd, S)
    S = ops.DECODE_BF16_MAX_SPLITS
    for dt, splits in ((code, S), (code, S + 1), (0, S), (3 - code, S)):
        # B = 0: the entry checks its arguments and launches nothing
        err = lib.dyn_paged_attention_decode(
            rt, dt, *[scratch] * 3, 0, *[scratch] * 6, 0, 8, 2, 4, 64, 128,
            256, splits, 1.0, 0.0, stream)
        assert (err == 0) == (dt == code and splits <= S)
    assert plib.dyn_paged_attention_prefill(
        rt, 3 - code, *[scratch] * 7, 0, 4, 8, 2, 8, 64, 128, 4, 1.0, 0.0,
        stream) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("window", [None, 3, 70])
@pytest.mark.parametrize("n_win", [1, 2, 3, 4])
def test_cuda_bf16_decode_window_steps(cuda_device, n_win, window, dtype):
    """The window form on the bf16 kernel (and its float16 form) at every
    step of a K = 4 window, without and with a sliding window (3 keys: the
    pool is out of view)."""
    Kw, KV, G, hd, ps = 4, 8, 4, 128, 64
    start = torch.tensor([-1, 0, 64, 300, 700], dtype=torch.int32)
    q, kp, vp, table = _decode_pool(G, hd, ps, [0, 0, 1, 5, 11], KV=KV,
                                    dtype=dtype)
    g = torch.Generator().manual_seed(6)
    B = start.numel()
    wk = torch.randn(B, Kw, KV, hd, generator=g).to(dtype)
    wv = torch.randn(B, Kw, KV, hd, generator=g).to(dtype)
    qp = (start.clamp(min=0) + n_win - 1).to(torch.int32)
    eff = None if window is None else torch.full((B,), window,
                                                 dtype=torch.int32)
    want = window_reference(q, kp, vp, 1, table, start, qp, wk, wv, n_win,
                            hd ** -0.5, None, eff)
    d = cuda_device
    ops.reset_launch_counts()
    got = paged_attention_decode_window(
        q.to(d), kp.to(d), vp.to(d), 1, table.to(d), start.to(d), qp.to(d),
        wk.to(d), wv.to(d), n_win,
        eff_win=None if eff is None else eff.to(d)).cpu()
    assert ops.DECODE_ROUTE_LAUNCHES == _counts(ops.DECODE_ROUTES,
                                                **{MMA_ROUTE[dtype]: 1})
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=2e-2)
    assert (got[0] == 0).all()


# shapes outside every fast set, on the generic decode kernel: (dtype,
# head_dim, page size, group, kv heads)
GENERIC_DECODE_SHAPES = [
    (torch.float32, 96, 64, 4, 2),     # head_dim outside the float32 set
    (torch.bfloat16, 32, 16, 1, 2),    # head_dim outside the bf16 set
    (torch.bfloat16, 64, 8, 2, 2),     # page size outside the bf16 set
    (torch.float16, 32, 16, 1, 2),     # and in float16
    (torch.float16, 96, 4, 3, 2),      # chip_smoke.py's check shape
    # groups past 8: Mistral-Large's 12, 16, and 71 on one kv head (five
    # head tiles); page 256 at head_dim 128, which staged pages refused;
    # float32 head_dim 7 (4-byte copies) and 256
    *[(dt, 128, 64, 12, 2) for dt in (torch.float32, torch.bfloat16,
                                      torch.float16)],
    *[(dt, 64, 16, 16, 1) for dt in (torch.float32, torch.bfloat16)],
    *[(dt, 80, 48, 71, 1) for dt in (torch.float32, torch.bfloat16,
                                     torch.float16)],
    *[(dt, 128, 256, 4, 2) for dt in (torch.float32, torch.bfloat16,
                                      torch.float16)],
    (torch.float32, 7, 5, 3, 2), (torch.float32, 256, 8, 12, 1),
    (torch.bfloat16, 256, 1, 2, 2),
    # float32 head_dim 32 at page 4 (the HDP-32 form); the tiny preset's
    # served shapes (4 heads on 2 kv heads, head_dim 16: page 16 in 16
    # bits, page 4 in float32); head_dim 192 (the HDP-192 forms)
    (torch.float32, 32, 4, 2, 2),
    *[(dt, 16, 16, 2, 2) for dt in (torch.bfloat16, torch.float16)],
    (torch.float32, 16, 4, 2, 2),
    *[(dt, 192, 32, 6, 2) for dt in (torch.float32, torch.bfloat16,
                                     torch.float16)],
    # 16-bit head_dim 20 and 7 (8-byte copies, 2-byte elements)
    *[(dt, hd, 16, 4, 2) for dt in (torch.bfloat16, torch.float16)
      for hd in (20, 7)]]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,ps,G,KV", GENERIC_DECODE_SHAPES)
def test_cuda_decode_other_shapes_run_the_generic_kernel(cuda_device, dtype,
                                                         hd, ps, G, KV):
    """float32 shapes outside the float32 kernel's set, and bfloat16 and
    float16 shapes outside the bf16 kernel's, run on the generic kernel,
    chosen by shape, one launch a call: groups of 12, 16 and 71, page 256,
    float32 head_dim 7; rows of several pages with a lower bound inside a
    page, an empty row, the softcap on layer 1 (stats within 1e-4)."""
    lengths = [3 * ps + 1, 0, 2 * ps, 40]
    lower = [0, 0, ps + 1, 3]
    q, kp, vp, table = _decode_pool(G, hd, ps, [4, 0, 2, -(-40 // ps)],
                                    KV=KV, dtype=dtype)
    ops.reset_launch_counts()
    f32 = dtype == torch.float32
    got = _decode_check(cuda_device, q, kp, vp, table, lengths, lower,
                        softcap=30.0, tol=1e-5 if f32 else 2e-2,
                        rtol=0.0 if f32 else 1e-2)
    assert ops.DECODE_ROUTE_LAUNCHES == _counts(ops.DECODE_ROUTES, generic=2)
    assert ops.LAUNCHES["paged_attention_decode"] == 2
    assert (got[1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,ps,G,KV", GENERIC_DECODE_SHAPES)
def test_cuda_decode_window_other_shapes_run_the_generic_kernel(
        cuda_device, hd, ps, G, KV, dtype):
    """The window form of the shapes outside every fast set runs on the
    generic kernel, chosen by shape: every step of K = 4 with a sliding
    window, the softcap and a padding row, one launch a step (float32 at
    atol 1e-5, 16 bits at their tolerance)."""
    d, Kw = cuda_device, 4
    q, kp, vp, table = _decode_pool(G, hd, ps, [5, 2, 3, 1], KV=KV,
                                    dtype=dtype)
    B = q.shape[0]
    g = torch.Generator().manual_seed(hd + ps)
    wk = torch.randn(B, Kw, KV, hd, generator=g).to(dtype)
    wv = torch.randn(B, Kw, KV, hd, generator=g).to(dtype)
    tol, rtol = (1e-5, 0) if dtype == torch.float32 else (2e-2, 1e-2)
    start = torch.tensor([5 * ps - 3, 2 * ps, 3 * ps - 1, -1],
                         dtype=torch.int32)
    eff = torch.full((B,), 2 * ps + 3, dtype=torch.int32)
    ops.reset_launch_counts()
    for n_win in range(1, Kw + 1):
        qp = (start.clamp(min=0) + n_win - 1).to(torch.int32)
        args = (q, kp, vp, 1, table, start, qp, wk, wv, n_win)
        want = window_reference(*args, hd ** -0.5, 30.0, eff)
        got = paged_attention_decode_window(
            *(a.to(d) if torch.is_tensor(a) else a for a in args),
            softcap=30.0, eff_win=eff.to(d)).cpu()
        np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=tol)
        assert (got[3] == 0).all()
    assert ops.DECODE_ROUTE_LAUNCHES == _counts(ops.DECODE_ROUTES,
                                                generic=Kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("G,KV", [(12, 8), (71, 1)])
def test_cuda_generic_decode_long_rows(cuda_device, G, KV, dtype):
    """Rows of 2,000 to 3,900 positions at page 48 (outside every fast
    set), at Mistral-Large's 12 heads on 8 kv heads and at 71 on one (five
    head tiles), in three rows (a cluster of splits each) and, with 12
    heads, 24 rows: within a tenth of the plain output's rms in every row,
    a limit the plain version one 16-key block short exceeds in every
    row; a second call gives the same bits."""
    rng = np.random.RandomState(G + KV)
    for rows in ((3, 24) if G == 12 else (3,)):
        lengths = [int(x) for x in rng.randint(2000, 3900, rows)]
        lower = [0] * (rows - 1) + [1000]
        q, kp, vp, table = _decode_pool(G, 128, 48,
                                        [-(-n // 48) for n in lengths],
                                        KV=KV, L=1, dtype=dtype)
        f32 = dtype == torch.float32
        first = _decode_check(cuda_device, q, kp, vp, table, lengths, lower,
                              tol=1e-5 if f32 else 2e-2,
                              rtol=0.0 if f32 else 1e-2)
        again = _decode_check(cuda_device, q, kp, vp, table, lengths, lower,
                              tol=1e-5 if f32 else 2e-2,
                              rtol=0.0 if f32 else 1e-2)
        assert torch.equal(first, again)
        ln, lo = (torch.tensor(x, dtype=torch.int32) for x in (lengths, lower))
        want = paged_attention_decode_layered(q, kp, vp, 0, table, ln,
                                              lower=lo)
        short = paged_attention_decode_layered(q, kp, vp, 0, table, ln,
                                               lower=lo + 16)
        _rows_within_rms(first, want, short, range(rows))


def _decode_masking_bad_pages(q, kp, vp, layer, table, lengths, lower,
                              softcap):
    """decode_reference's arithmetic (float32, exp only where visible)
    with the keys of a table entry outside [0, N) masked, as the kernels
    take them. Returns out in q's dtype."""
    B, H, hd = q.shape
    _, N, KV, ps, _ = kp.shape
    G, S = H // KV, table.shape[1] * ps
    ok = ((table >= 0) & (table < N)).repeat_interleave(ps, dim=1)
    idx = table.clamp(0, N - 1).long()
    k = kp[layer][idx].permute(0, 2, 1, 3, 4).reshape(B, KV, S, hd).float()
    v = vp[layer][idx].permute(0, 2, 1, 3, 4).reshape(B, KV, S, hd).float()
    s = torch.einsum("bkgh,bksh->bkgs", q.reshape(B, KV, G, hd).float(),
                     k) * hd ** -0.5
    s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S)[None]
    vis = ((pos >= lower[:, None]) & (pos < lengths[:, None]) & ok)
    vis = vis[:, None, None]
    s = torch.where(vis, s, torch.full_like(s, ops.NEG_INF))
    p = torch.where(vis, torch.exp(s - s.amax(-1, keepdim=True)),
                    torch.zeros_like(s))
    out = torch.einsum("bkgs,bksh->bkgh", p, v) / p.sum(-1).clamp(
        min=1e-9)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,rtol", DTYPE_TOLS)
def test_cuda_generic_decode_masks_pages_outside_the_pool(cuda_device, dtype,
                                                          tol, rtol):
    """Table entries outside [0, N) (one past the pool, one negative) on
    the generic kernel: their keys contribute nothing and are not read;
    held to the plain version with those keys masked, which is
    decode_reference's where every page is in the pool (row 0)."""
    d = cuda_device
    q, kp, vp, table = _decode_pool(12, 80, 3, [9, 9], KV=1, dtype=dtype)
    N = kp.shape[1]
    table[1, 1], table[1, 4] = N + 3, -2
    ln = torch.tensor([26, 25], dtype=torch.int32)
    lo = torch.tensor([0, 2], dtype=torch.int32)
    got = paged_attention_decode_layered(
        q.to(d), kp.to(d), vp.to(d), 0, table.to(d), ln.to(d), lower=lo.to(d),
        softcap=25.0).cpu()
    want = _decode_masking_bad_pages(q, kp, vp, 0, table, ln, lo, 25.0)
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=tol)
    np.testing.assert_allclose(
        _np(want[:1]), _np(paged_attention_decode_layered(
            q[:1], kp, vp, 0, table[:1], ln[:1], lower=lo[:1],
            softcap=25.0)), rtol=rtol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,KV,ps", [(12, 8, 64), (71, 1, 8)])
def test_cuda_generic_decode_graph_replay_equals_eager(cuda_device, G, KV,
                                                       ps, dtype):
    """A captured generic cluster launch, replayed, gives the eager call's
    output and stats bit for bit (layered with stats, and the window
    form), at Mistral-Large's heads and at 71 on one kv head."""
    lengths = [40, ps * 11 - 3, 0, 86]
    q, kp, vp, narrow = _decode_pool(G, 128, ps, [1, 11, 0, -(-86 // ps)],
                                     KV=KV, L=1, dtype=dtype)
    d = cuda_device
    B = len(lengths)
    table = torch.zeros((B, 64), dtype=torch.int32)
    table[:, :narrow.shape[1]] = narrow
    q, kp, vp, table = (t.to(d) for t in (q, kp, vp, table))
    ln = torch.tensor(lengths, dtype=torch.int32, device=d)
    g = torch.Generator().manual_seed(3)
    wk = torch.randn(B, 4, KV, 128, generator=g).to(dtype).to(d)
    wv = torch.randn(B, 4, KV, 128, generator=g).to(dtype).to(d)
    start = torch.tensor([40, ps * 11 - 3, -1, 86], dtype=torch.int32,
                         device=d)
    qp = (start.clamp(min=0) + 3).to(torch.int32)

    def calls():
        return (*paged_attention_decode_layered(q, kp, vp, 0, table, ln,
                                                return_stats=True),
                paged_attention_decode_window(q, kp, vp, 0, table, start, qp,
                                              wk, wv, 4))

    ops.reset_launch_counts()
    eager = calls()
    assert ops.DECODE_ROUTE_LAUNCHES == _counts(ops.DECODE_ROUTES, generic=2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = calls()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_generic_decode_calls_in_flight_on_two_streams(cuda_device,
                                                            dtype):
    """Splitting generic calls in flight on two streams at once, each
    stream with its own queries, at Mistral-Large's heads on page 48:
    every call folds its own splits (no state is shared between calls)."""
    lengths = [3000, 2600, 3900, 700]
    d = cuda_device
    q, kp, vp, table = _decode_pool(12, 128, 48,
                                    [-(-n // 48) for n in lengths], KV=8,
                                    L=1, dtype=dtype)
    q2 = torch.flip(q, dims=[0]).contiguous()
    ln = torch.tensor(lengths, dtype=torch.int32)
    wants = [paged_attention_decode_layered(x, kp, vp, 0, table, ln)
             for x in (q, q2)]
    kd, vd, td, lnd = (t.to(d) for t in (kp, vp, table, ln))
    qs = [q.to(d), q2.to(d)]
    paged_attention_decode_layered(qs[0], kd, vd, 0, td, lnd)  # plan
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):
        for s, x, out in zip(streams, qs, outs):
            with torch.cuda.stream(s):
                out.append(paged_attention_decode_layered(x, kd, vd, 0, td,
                                                          lnd))
    torch.cuda.synchronize()
    for want, out in zip(wants, outs):
        limit = 0.1 * float(want.float().pow(2).mean().sqrt())
        for got in out:
            np.testing.assert_allclose(_np(got.cpu()), _np(want), rtol=0,
                                       atol=limit)


@pytest.mark.cuda
def test_cuda_generic_decode_plan_matches_the_kernel(cuda_device):
    """The generic decode kernel's shared memory
    (dyn_paged_decode_generic_smem, its dg_smem) equals the wrapper's
    mirror (decode_generic_plan) at every head_dim it takes in every
    dtype, and -1 outside; the card holds at least one cluster of every
    size the plan picks from; the C entry takes route 0 in every dtype
    exactly at prefill_generic_shape, with any group and page size (B =
    0: it checks its arguments and launches nothing), and refuses a
    cluster past DECODE_BF16_MAX_SPLITS and the other dtype codes."""
    import ctypes

    lib = ops._lib()
    stream = torch.cuda.current_stream().cuda_stream
    scratch = torch.zeros(16, device=cuda_device).data_ptr()
    n = ctypes.c_int(0)
    S = ops.DECODE_BF16_MAX_SPLITS
    for dtype, code in ops._DTYPES.items():
        for hd in range(1, 700):
            inside = ops.prefill_generic_shape(dtype, hd)
            smem = lib.dyn_paged_decode_generic_smem(code, hd)
            assert smem == (ops.decode_generic_plan(4, 8, hd, dtype).smem
                            if inside else -1), (dtype, hd)
            for ps, G in ((1, 1), (8, 71), (256, 12)):
                for splits in (1, S, S + 1):
                    err = lib.dyn_paged_attention_decode(
                        0, code, *[scratch] * 3, 0, *[scratch] * 6, 0,
                        2 * G, 2, 8, ps, hd, 4, splits, 1.0, 0.0, stream)
                    assert (err == 0) == (inside and splits <= S), (
                        dtype, hd, ps, G, splits)
        for hd in (7, 16, 96, 128, 256, 320, 512):
            if not ops.prefill_generic_shape(dtype, hd):
                continue
            for s in ops.DECODE_CLUSTER_SIZES:
                n.value = 0
                assert lib.dyn_paged_decode_clusters(
                    0, code, 24, 2, 256, hd, s, ctypes.byref(n)) == 0
                assert n.value >= 1, (dtype, hd, s)
    for code in (-1, 3):
        assert lib.dyn_paged_attention_decode(
            0, code, *[scratch] * 3, 0, *[scratch] * 6, 0, 8, 2, 8, 8, 64,
            4, 1, 1.0, 0.0, stream) != 0


# head_dim above 256 (the wide form: value-column tiles), in every dtype,
# up to each dtype's bound
WIDE_HEAD_DIMS = [(dt, hd) for dt in (torch.float32, torch.bfloat16,
                                      torch.float16)
                  for hd in (264, 320, 512, ops.GENERIC_MAX_HEAD_DIM[dt])]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", WIDE_HEAD_DIMS)
def test_cuda_decode_above_head_dim_256_raises(cuda_device, dtype, hd):
    """Head_dim above 256 runs the generic kernel's wide form, in every
    dtype: both wrappers against their plain versions (stats, softcap,
    a lower bound, an empty row; every window step), 12 heads on one kv
    head at page 16; the next head_dim past the dtype's shared-memory
    bound raises ValueError naming it, and launches nothing."""
    d, f32 = cuda_device, dtype == torch.float32
    tol, rtol = (1e-5, 0.0) if f32 else (2e-2, 1e-2)
    q, kp, vp, table = _decode_pool(12, hd, 16, [3, 0, 2], KV=1,
                                    dtype=dtype)
    ops.reset_launch_counts()
    got = _decode_check(d, q, kp, vp, table, [40, 0, 20], [0, 0, 17],
                        softcap=30.0, tol=tol, rtol=rtol)
    assert (got[1] == 0).all()
    g = torch.Generator().manual_seed(hd)
    wk = torch.randn(3, 4, 1, hd, generator=g).to(dtype)
    wv = torch.randn(3, 4, 1, hd, generator=g).to(dtype)
    start = torch.tensor([40, -1, 20], dtype=torch.int32)
    for n_win in range(1, 5):
        qp = (start.clamp(min=0) + n_win - 1).to(torch.int32)
        args = (q, kp, vp, 1, table, start, qp, wk, wv, n_win)
        want = window_reference(*args, hd ** -0.5)
        got = paged_attention_decode_window(
            *(a.to(d) if torch.is_tensor(a) else a for a in args)).cpu()
        np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=tol)
    assert ops.DECODE_ROUTE_LAUNCHES == _counts(ops.DECODE_ROUTES, generic=6)
    big = ops.GENERIC_MAX_HEAD_DIM[dtype] + 1
    pool = torch.zeros(1, 4, 1, 16, big, dtype=dtype, device=d)
    qb = torch.zeros(1, 12, big, dtype=dtype, device=d)
    one = torch.ones(1, dtype=torch.int32, device=d)
    w = torch.zeros(1, 4, 1, big, dtype=dtype, device=d)
    tb = torch.ones(1, 2, dtype=torch.int32, device=d)
    match = (f"{dtype} generic decode kernel takes head_dim up to "
             f"{big - 1} .*got head_dim {big}, page_size 16, group 12")
    with pytest.raises(ValueError, match=match):
        paged_attention_decode_layered(qb, pool, pool, 0, tb, one)
    with pytest.raises(ValueError, match=match):
        paged_attention_decode_window(qb, pool, pool, 0, tb, one, one, w, w,
                                      1)
    assert sum(ops.DECODE_ROUTE_LAUNCHES.values()) == 6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,rtol", DTYPE_TOLS)
@pytest.mark.parametrize("hd,ps,G", [(96, 64, 4), (32, 4, 2)])
def test_cuda_prefill_other_shapes_run_the_generic_kernel(cuda_device, hd,
                                                          ps, G, dtype, tol,
                                                          rtol):
    """Prefill outside the fast sets (a head_dim of 96; page 4,
    chip_smoke.py's check shape) runs on the generic kernel
    (paged_prefill_generic_kernel) in every dtype, chosen by shape: a
    chunk continuing at position 40 and a row with padding queries, then
    the same with sliding windows and the softcap."""
    d, g = cuda_device, torch.Generator().manual_seed(hd + ps)
    KV, T = 2, 48
    pos = torch.full((2, T), -1, dtype=torch.int32)
    pos[0] = torch.arange(40, 40 + T)
    pos[1, :21] = torch.arange(21)
    used = -(-(40 + T) // ps)
    N = 2 * used + 4
    kp = torch.randn(N, KV, ps, hd, generator=g).to(dtype)
    vp = torch.randn(N, KV, ps, hd, generator=g).to(dtype)
    q = torch.randn(2, T, KV * G, hd, generator=g).to(dtype)
    table = torch.zeros((2, used + 1), dtype=torch.int32)
    for b in range(2):
        table[b, :used] = torch.randperm(N - 1, generator=g)[:used] + 1
    ops.reset_launch_counts()
    for win, softcap in ((None, None),
                         (torch.tensor([ps + 7, 9], dtype=torch.int32),
                          30.0)):
        want = paged_attention_prefill(q, kp, vp, table, pos,
                                       softcap=softcap, eff_win=win)
        got = paged_attention_prefill(
            q.to(d), kp.to(d), vp.to(d), table.to(d), pos.to(d),
            softcap=softcap, eff_win=None if win is None else win.to(d))
        torch.cuda.synchronize()
        got = got.cpu()
        np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=tol)
        assert (got[1, 21:] == 0).all()
    assert ops.PREFILL_ROUTE_LAUNCHES == _counts(ops.PREFILL_ROUTES,
                                                 generic=2)


def _prefill_masking_bad_pages(q, kp, vp, table, pos, softcap):
    """prefill_reference's arithmetic (float32, exp only where visible)
    with the keys of a table entry outside [0, N) masked, as the kernels
    take them; a query that sees no key gives zeros."""
    B, T, H, hd = q.shape
    N, KV, ps, _ = kp.shape
    G, S = H // KV, table.shape[1] * ps
    ok = ((table >= 0) & (table < N)).repeat_interleave(ps, dim=1)
    idx = table.clamp(0, N - 1).long()
    k = kp[idx].permute(0, 1, 3, 2, 4).reshape(B, S, KV, hd).float()
    v = vp[idx].permute(0, 1, 3, 2, 4).reshape(B, S, KV, hd).float()
    s = torch.einsum("btkgh,bskh->bkgts", q.reshape(B, T, KV, G, hd).float(),
                     k) * hd ** -0.5
    s = softcap * torch.tanh(s / softcap)
    qp = pos.long()[:, :, None]
    vis = ((torch.arange(S)[None, None] <= qp) & ok[:, None])[:, None, None]
    s = torch.where(vis, s, torch.full_like(s, ops.NEG_INF))
    p = torch.where(vis, torch.exp(s - s.amax(-1, keepdim=True)),
                    torch.zeros_like(s))
    out = torch.einsum("bkgts,bskh->btkgh", p, v) / p.sum(-1).clamp(
        min=1e-9).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, T, H, hd).to(q.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,rtol", DTYPE_TOLS)
@pytest.mark.parametrize("hd,ps,G,KV", [(16, 1, 3, 2), (8, 3, 71, 1),
                                        (80, 48, 130, 1), (256, 5, 2, 2),
                                        (7, 2, 4, 1), (30, 9, 1, 3),
                                        (20, 16, 4, 2), (320, 16, 4, 2),
                                        (512, 7, 2, 1)])
def test_cuda_generic_prefill_odd_shapes(cuda_device, hd, ps, G, KV, dtype,
                                         tol, rtol):
    """The generic kernel where no other route reaches: page sizes of 1,
    2, 3, 5, 7 and 9 (key blocks over many pages), groups of 71 and 130
    (two and three head tiles), head_dim 256, head_dim 7, 20 and 30 (4-
    and 8-byte copies, and 2-byte elements in 16 bits), head_dim 320 and
    512 (the wide form's column tiles); row 1's first two table entries
    past the pool and negative, whose keys are masked and never read.
    Held in its dtype's tolerance to the plain version with those keys
    masked (:func:`_prefill_masking_bad_pages`), which is
    prefill_reference's where every page is in the pool (row 0)."""
    d, g = cuda_device, torch.Generator().manual_seed(hd * ps + G)
    T, start = 24, 13
    used = -(-(start + T) // ps)
    N = used + 5
    kp = torch.randn(N, KV, ps, hd, generator=g).to(dtype)
    vp = torch.randn(N, KV, ps, hd, generator=g).to(dtype)
    q = torch.randn(2, T, KV * G, hd, generator=g).to(dtype)
    table = torch.zeros((2, used + 1), dtype=torch.int32)
    for b in range(2):
        table[b, :used] = torch.randperm(N - 1, generator=g)[:used] + 1
    pos = torch.stack([torch.arange(start, start + T),
                       torch.arange(T)]).to(torch.int32)
    pos[1, T - 5:] = -1
    table[1, 0], table[1, 1] = N + 3, -2
    ops.reset_launch_counts()
    got = paged_attention_prefill(q.to(d), kp.to(d), vp.to(d),
                                  table.to(d), pos.to(d),
                                  softcap=25.0).cpu()
    torch.cuda.synchronize()
    want = _prefill_masking_bad_pages(q, kp, vp, table, pos, 25.0)
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=tol)
    np.testing.assert_allclose(
        _np(want[:1]), _np(paged_attention_prefill(
            q[:1], kp, vp, table[:1], pos[:1], softcap=25.0)),
        rtol=rtol, atol=tol)
    assert (got[1, T - 5:] == 0).all()
    assert ops.PREFILL_ROUTE_LAUNCHES == _counts(ops.PREFILL_ROUTES,
                                                 generic=1)


# the verify forward of self-speculative decoding: a [B, K + 1] chunk (K
# = 4 drafted tokens) that starts anywhere in a page, on every prefill
# route: (dtype, head_dim, page size, route)
VERIFY_SHAPES = [(torch.bfloat16, 128, 64, "bf16"),
                 (torch.float16, 128, 64, "f16"),
                 (torch.float32, 128, 16, "f32"),
                 (torch.float32, 96, 64, "generic"),
                 (torch.bfloat16, 96, 8, "generic")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,ps,route", VERIFY_SHAPES)
def test_cuda_prefill_verify_chunk_starts_mid_page(cuda_device, dtype, hd,
                                                   ps, route):
    """A T = 5 chunk at the 8B's heads (32 on 8 kv heads) whose rows start
    mid-page, on the page's last slot, on a page boundary and at 1, with
    a padding row, against the plain version in its dtype's tolerance,
    one launch on the shape's route."""
    d, g = cuda_device, torch.Generator().manual_seed(hd + ps)
    tol, rtol = (1e-5, 0.0) if dtype == torch.float32 else (2e-2, 1e-2)
    T, KV, G = 5, 8, 4
    starts = [ps // 2 + 3, ps - 1, 2 * ps, 1, -1]
    P = 4
    pos = torch.stack([torch.arange(s, s + T) if s >= 0
                       else torch.full((T,), -1) for s in starts]).int()
    N = len(starts) * P + 1
    kp = torch.randn(N, KV, ps, hd, generator=g).to(dtype)
    vp = torch.randn(N, KV, ps, hd, generator=g).to(dtype)
    q = torch.randn(len(starts), T, KV * G, hd, generator=g).to(dtype)
    table = (torch.randperm(N - 1, generator=g)[:len(starts) * P] + 1
             ).view(len(starts), P).int()
    ops.reset_launch_counts()
    want = paged_attention_prefill(q, kp, vp, table, pos)
    got = paged_attention_prefill(q.to(d), kp.to(d), vp.to(d), table.to(d),
                                  pos.to(d)).cpu()
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=tol)
    assert (got[-1] == 0).all()
    assert ops.PREFILL_ROUTE_LAUNCHES == _counts(ops.PREFILL_ROUTES,
                                                 **{route: 1})


# ------------------------------------------------------ the float32 routes
# the float32 kernels' set (ops.F32_*), every head_dim, at pages and groups
# that take each code path: page 8 is one decode stage and one prefill
# stage, G = 3 leaves idle lanes and padding rows in a prefill block
F32_CASES = [(hd, ps, G) for hd in ops.F32_HEAD_DIMS
             for ps in (8, 16, 64, 128) for G in (1, 3, 4, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("hd,ps,G", F32_CASES)
def test_cuda_f32_decode_kernel_matches_plain(cuda_device, hd, ps, G):
    """paged_decode_f32_kernel against its plain version at atol 1e-5:
    the stats form with softcap and ``lower`` on rows of no page, of an
    empty view (lower = length: m = NEG_INF, l = 0), of 3, 7 and 13 pages,
    and of 5 pages whose last page id lies outside the pool (its keys
    skipped: held to the same row without that page); then the window
    form at every step of K = 4 with a sliding window and a padding row.
    Every call on route 2."""
    KV, P, d = 2, 16, cuda_device
    pages = [0, 1, 3, 7, 13, 5]
    lengths = [0, 1, 3 * ps - 5, 7 * ps - 1, 13 * ps - 2, 5 * ps - 3]
    lo = torch.tensor([0, 1, 0, ps + 3, 2 * ps, 0], dtype=torch.int32)
    q, kp, vp, narrow = _decode_pool(G, hd, ps, pages, KV=KV, L=2,
                                     seed=hd + ps + G, dtype=torch.float32)
    B, N = len(pages), kp.shape[1]
    table = torch.zeros((B, P), dtype=torch.int32)
    table[:, :narrow.shape[1]] = narrow
    table[5, 4] = N + 7
    ln = torch.tensor(lengths, dtype=torch.int32)
    t_ref, ln_ref = table.clone(), ln.clone()
    t_ref[5, 4], ln_ref[5] = 0, 4 * ps
    scale = hd ** -0.5
    ops.reset_launch_counts()
    for layer in range(2):
        want = ops.decode_reference(q, kp, vp, layer, t_ref, ln_ref, lo,
                                    scale, 30.0)
        got = paged_attention_decode_layered(
            q.to(d), kp.to(d), vp.to(d), layer, table.to(d), ln.to(d),
            return_stats=True, softcap=30.0, lower=lo.to(d))
        torch.cuda.synchronize()
        got = [t.cpu() for t in got]
        np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(got[2]), _np(want[2]), rtol=1e-5,
                                   atol=1e-5)
        for r in (0, 1):
            assert (got[0][r] == 0).all() and (got[2][r] == 0).all()
            assert (got[1][r] == ops.NEG_INF).all()

    Kw = 4
    g = torch.Generator().manual_seed(ps)
    wk = torch.randn(B, Kw, KV, hd, generator=g)
    wv = torch.randn(B, Kw, KV, hd, generator=g)
    start = torch.tensor([-1, 0] + lengths[2:5] + [4 * ps],
                         dtype=torch.int32)
    eff = torch.full((B,), 3 * ps // 2, dtype=torch.int32)
    for n_win in range(1, Kw + 1):
        qp = (start.clamp(min=0) + n_win - 1).to(torch.int32)
        args = (q, kp, vp, 1, t_ref, start, qp, wk, wv, n_win)
        want = window_reference(*args, scale, None, eff)
        got = paged_attention_decode_window(
            *(a.to(d) if torch.is_tensor(a) else a for a in args),
            eff_win=eff.to(d)).cpu()
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)
        assert (got[0] == 0).all()
    assert ops.DECODE_ROUTE_LAUNCHES == _counts(ops.DECODE_ROUTES,
                                                f32=2 + Kw)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,ps,G", F32_CASES)
def test_cuda_f32_prefill_kernel_matches_plain(cuda_device, hd, ps, G):
    """paged_prefill_f32_kernel (3xTF32) against its plain version at atol
    1e-5: a chunk continuing at position 40, a row with padding queries
    at its end, a row of padding only, and a page id outside the pool
    past the chunk's pages (never read); then a second chunk with
    sliding windows and the softcap. Every call on route 2."""
    d, g = cuda_device, torch.Generator().manual_seed(hd * ps + G)
    KV, T = 2, 80
    pos = torch.full((3, T), -1, dtype=torch.int32)
    pos[0] = torch.arange(40, 40 + T)
    pos[1, :33] = torch.arange(33)
    used = -(-(40 + T) // ps)
    N, P = 2 * used + 4, used + 2
    kp = torch.randn(N, KV, ps, hd, generator=g)
    vp = torch.randn(N, KV, ps, hd, generator=g)
    q = torch.randn(3, T, KV * G, hd, generator=g)
    table = torch.zeros((3, P), dtype=torch.int32)
    for b in range(3):
        table[b, :used] = torch.randperm(N - 1, generator=g)[:used] + 1
    t_dev = table.clone()
    t_dev[0, used + 1] = N + 5
    ops.reset_launch_counts()
    for win, softcap in ((None, None),
                         (torch.tensor([ps + 7, 9, 1], dtype=torch.int32),
                          30.0)):
        want = paged_attention_prefill(q, kp, vp, table, pos,
                                       softcap=softcap, eff_win=win)
        got = paged_attention_prefill(
            q.to(d), kp.to(d), vp.to(d), t_dev.to(d), pos.to(d),
            softcap=softcap, eff_win=None if win is None else win.to(d))
        torch.cuda.synchronize()
        got = got.cpu()
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)
        assert (got[1, 33:] == 0).all() and (got[2] == 0).all()
    assert ops.PREFILL_ROUTE_LAUNCHES == _counts(ops.PREFILL_ROUTES, f32=2)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,ps,G", [(128, 64, 4), (64, 64, 4)])
def test_cuda_f32_prefill_first_chunk_at_served_heads(cuda_device, hd, ps,
                                                      G):
    """A first 512-token chunk at the 8B's and the 1b's heads (8 kv
    heads), as phase 5 of chip_smoke.py times it: every tile of 64 rows
    walks up to the whole chunk's keys."""
    d, g = cuda_device, torch.Generator().manual_seed(hd)
    KV, T = 8, 512
    N = T // ps + 2
    kp = torch.randn(N, KV, ps, hd, generator=g)
    vp = torch.randn(N, KV, ps, hd, generator=g)
    q = torch.randn(1, T, KV * G, hd, generator=g)
    table = (torch.randperm(N - 1, generator=g)[:T // ps] + 1)[None].to(
        torch.int32)
    pos = torch.arange(T, dtype=torch.int32)[None]
    want = paged_attention_prefill(q, kp, vp, table, pos)
    got = paged_attention_prefill(q.to(d), kp.to(d), vp.to(d), table.to(d),
                                  pos.to(d)).cpu()
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_f32_shape_set_matches_the_kernels(cuda_device):
    """The wrapper's float32 set (ops.F32_*) is the set the C side takes
    on route 2 of both kernels: shapes inside get a cluster occupancy
    answer from the decode kernel (at least one cluster of every size
    the plan picks from) and are taken by the prefill entry, shapes
    outside are refused by both, and so is bfloat16. The shared memory
    the CPU tests hold to the card's limit (ops.decode_f32_smem,
    ops.prefill_f32_smem) is the kernels' own."""
    import ctypes

    lib, plib = ops._lib(), ops._prefill_lib()
    n = ctypes.c_int(0)
    stream = torch.cuda.current_stream().cuda_stream
    scratch = torch.zeros(16, device=cuda_device).data_ptr()
    for hd in (16, 24, 32, 64, 96, 128, 256, 512):
        for ps in (4, 8, 16, 48, 64, 128, 256):
            for G in (1, 3, 8, 9):
                inside = ops.decode_route(torch.float32, 2 * G, 2, ps,
                                          hd) == 2
                assert inside == (ops.prefill_route(torch.float32, 2 * G, 2,
                                                    ps, hd) == 2)
                err = lib.dyn_paged_decode_clusters(2, 0, 2 * G, 2, ps, hd,
                                                    1, ctypes.byref(n))
                assert (err == 0) == inside, (hd, ps, G)
                # B = 0: the entry checks its arguments, launches nothing
                err = plib.dyn_paged_attention_prefill(
                    2, 0, *[scratch] * 7, 0, 4, 2 * G, 2, 8, ps, hd, 4, 1.0,
                    0.0, stream)
                assert (err == 0) == inside, (hd, ps, G)
    for hd in ops.F32_HEAD_DIMS:
        for S in ops.DECODE_CLUSTER_SIZES:
            n.value = 0
            assert lib.dyn_paged_decode_clusters(2, 0, 32, 8, 64, hd, S,
                                                 ctypes.byref(n)) == 0
            assert n.value >= 1, (hd, S)
        assert lib.dyn_paged_decode_f32_smem(hd) == ops.decode_f32_smem(hd)
        for ps in ops.F32_PAGE_SIZES:
            assert plib.dyn_paged_prefill_f32_smem(hd, ps) == (
                ops.prefill_f32_smem(hd, ps)), (hd, ps)
    assert plib.dyn_paged_attention_prefill(
        2, 1, *[scratch] * 7, 0, 4, 8, 2, 8, 64, 128, 4, 1.0, 0.0,
        stream) != 0


@pytest.mark.cuda
def test_cuda_generic_prefill_plan_matches_the_kernel(cuda_device):
    """The generic kernel's shared memory (dyn_paged_prefill_generic_smem,
    its gn_smem) equals the wrapper's mirror (prefill_generic_plan) at
    every head_dim it takes in every dtype; the C entry takes route 0 in
    every dtype exactly at prefill_generic_shape (B = 0: it checks its
    arguments and launches nothing) and refuses the other dtype codes."""
    plib = ops._prefill_lib()
    stream = torch.cuda.current_stream().cuda_stream
    scratch = torch.zeros(16, device=cuda_device).data_ptr()
    for dtype, code in ops._DTYPES.items():
        for hd in range(1, 700):
            inside = ops.prefill_generic_shape(dtype, hd)
            if inside:
                assert plib.dyn_paged_prefill_generic_smem(code, hd) == (
                    ops.prefill_generic_plan(4, 8, hd, dtype).smem), (dtype,
                                                                     hd)
            for ps, G in ((1, 1), (8, 71), (48, 4)):
                err = plib.dyn_paged_attention_prefill(
                    0, code, *[scratch] * 7, 0, 4, 2 * G, 2, 8, ps, hd, 4,
                    1.0, 0.0, stream)
                assert (err == 0) == inside, (dtype, hd, ps, G)
    for code in (-1, 3):
        assert plib.dyn_paged_attention_prefill(
            0, code, *[scratch] * 7, 0, 4, 8, 2, 8, 8, 64, 4, 1.0, 0.0,
            stream) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", WIDE_HEAD_DIMS)
def test_cuda_prefill_above_head_dim_256_raises(cuda_device, dtype, hd):
    """Head_dim above 256 runs the generic prefill kernel's wide form,
    in every dtype: a 40-token chunk continuing at position 9 and a row
    with padding queries, with a sliding window and the softcap, against
    the plain version at 8B's 32 heads on 8 kv heads; the next head_dim
    past the dtype's shared-memory bound raises ValueError naming it,
    and launches nothing."""
    d, g = cuda_device, torch.Generator().manual_seed(hd)
    tol, rtol = (1e-5, 0.0) if dtype == torch.float32 else (2e-2, 1e-2)
    T, ps, KV, G = 40, 16, 8, 4
    pos = torch.full((2, T), -1, dtype=torch.int32)
    pos[0] = torch.arange(9, 9 + T)
    pos[1, :13] = torch.arange(13)
    kp = torch.randn(9, KV, ps, hd, generator=g).to(dtype)
    vp = torch.randn(9, KV, ps, hd, generator=g).to(dtype)
    q = torch.randn(2, T, KV * G, hd, generator=g).to(dtype)
    table = torch.tensor([[3, 1, 7, 5], [2, 8, 0, 0]], dtype=torch.int32)
    win = torch.tensor([30, ops.NO_WINDOW], dtype=torch.int32)
    ops.reset_launch_counts()
    want = paged_attention_prefill(q, kp, vp, table, pos, softcap=30.0,
                                   eff_win=win)
    got = paged_attention_prefill(q.to(d), kp.to(d), vp.to(d), table.to(d),
                                  pos.to(d), softcap=30.0,
                                  eff_win=win.to(d)).cpu()
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=tol)
    assert (got[1, 13:] == 0).all()
    assert ops.PREFILL_ROUTE_LAUNCHES == _counts(ops.PREFILL_ROUTES,
                                                 generic=1)
    big = ops.GENERIC_MAX_HEAD_DIM[dtype] + 1
    pool = torch.zeros(4, 1, 16, big, dtype=dtype, device=d)
    with pytest.raises(ValueError, match=f"{dtype} generic prefill kernel "
                       f"takes head_dim up to {big - 1} .*got head_dim "
                       f"{big}, page_size 16, group 4"):
        paged_attention_prefill(
            torch.zeros(1, 4, 4, big, dtype=dtype, device=d), pool, pool,
            torch.ones(1, 2, dtype=torch.int32, device=d),
            torch.arange(4, dtype=torch.int32, device=d)[None])
    assert sum(ops.PREFILL_ROUTE_LAUNCHES.values()) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["stats", "window"])
def test_cuda_f32_decode_repeats_bitwise_under_contention(cuda_device,
                                                          form):
    """The float32 decode kernel's result does not depend on when its
    blocks run: 200 calls on the inputs of
    test_cuda_decode_kernel_matches_plain[5-float32] (8B heads, rows of
    0 to 384 positions, clusters of splits), with a side stream's matrix
    products holding SMs between them, are bitwise equal and within atol
    1e-5 of the plain version, computed on the card. A race in the rings,
    the warps' merge or the cluster fold would show as calls that
    differ."""
    d = cuda_device
    g = torch.Generator().manual_seed(0)
    L, N, KV, ps, hd, H, P, B = 1, 40, 8, 64, 128, 32, 6, 5
    kp = torch.randn(L, N, KV, ps, hd, generator=g).to(d)
    vp = torch.randn(L, N, KV, ps, hd, generator=g).to(d)
    q = torch.randn(B, H, hd, generator=g).to(d)
    table = torch.randint(1, N, (B, P), generator=g,
                          dtype=torch.int32).to(d)
    lengths = torch.tensor([0, 1, 64, 300, 384], dtype=torch.int32,
                           device=d)
    lower = torch.tensor([0, 0, 10, 200, 0], dtype=torch.int32, device=d)
    Kw = 4
    wk = torch.randn(B, Kw, KV, hd, generator=g).to(d)
    wv = torch.randn(B, Kw, KV, hd, generator=g).to(d)
    qp = (lengths + Kw - 1).to(torch.int32)
    if form == "stats":
        run = lambda: paged_attention_decode_layered(  # noqa: E731
            q, kp, vp, 0, table, lengths, return_stats=True, softcap=30.0,
            lower=lower)
        want = ops.decode_reference(q, kp, vp, 0, table, lengths, lower,
                                    hd ** -0.5, 30.0)[0]
    else:
        run = lambda: (paged_attention_decode_window(  # noqa: E731
            q, kp, vp, 0, table, lengths, qp, wk, wv, Kw),)
        want = window_reference(q, kp, vp, 0, table, lengths, qp, wk, wv,
                                Kw, hd ** -0.5)
    a = torch.randn(2048, 2048, device=d)
    b = torch.empty_like(a)
    side = torch.cuda.Stream()
    ops.reset_launch_counts()
    outs = []
    for i in range(200):
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(i % 4):
                torch.mm(a, a, out=b)
        outs.append(torch.cat([t.reshape(-1) for t in run()]))
    torch.cuda.synchronize()
    assert ops.DECODE_ROUTE_LAUNCHES["f32"] == 200
    np.testing.assert_allclose(_np(outs[0][:want.numel()].cpu()),
                               _np(want.reshape(-1)), rtol=0, atol=1e-5)
    differ = [i for i, o in enumerate(outs) if not torch.equal(o, outs[0])]
    assert not differ, f"calls {differ[:10]} differ from the first"


@pytest.mark.cuda
def test_cuda_host_plain_decode_repeats_bitwise(cuda_device):
    """The card tests hold the kernels to their plain versions computed on
    the host's CPU, so the host's plain version must give one answer: 100
    calls a layer of the float32 plain decode on the inputs of
    test_cuda_decode_kernel_matches_plain[5-float32] are bitwise equal.
    A host that fails this fails the kernel tests at random, with the
    kernel right."""
    g = torch.Generator().manual_seed(0)
    L, N, KV, ps, hd, H, P, B = 2, 40, 8, 64, 128, 32, 6, 5
    kp = torch.randn(L, N, KV, ps, hd, generator=g)
    vp = torch.randn(L, N, KV, ps, hd, generator=g)
    q = torch.randn(B, H, hd, generator=g)
    table = torch.randint(1, N, (B, P), generator=g, dtype=torch.int32)
    lengths = torch.tensor([0, 1, 64, 300, 384], dtype=torch.int32)
    lower = torch.tensor([0, 0, 10, 200, 0], dtype=torch.int32)
    differ = []
    for layer in range(L):
        runs = [ops.decode_reference(q, kp, vp, layer, table, lengths, lower,
                                     hd ** -0.5, 30.0)[0] for _ in range(100)]
        for i, o in enumerate(runs[1:], 1):
            if not torch.equal(o, runs[0]):
                e = (o - runs[0]).abs().reshape(B, KV, -1).amax(-1)
                differ.append((layer, i, float(e.max()),
                               [(b, k) for b in range(B) for k in range(KV)
                                if e[b, k] > 0]))
    assert not differ, (f"{len(differ)} of 198 calls differ from their "
                        f"layer's first: {differ[:4]}")


@pytest.mark.cuda
def test_cuda_f32_decode_graph_replay_equals_eager(cuda_device):
    """The float32 decode kernel (one cluster launch, no scratch) captured
    in a CUDA graph replays bitwise its eager call."""
    d = cuda_device
    q, kp, vp, table = _decode_pool(4, 128, 64, [3, 7, 1, 0], KV=8, L=1,
                                    dtype=torch.float32)
    q, kp, vp, table = (t.to(d) for t in (q, kp, vp, table))
    g = torch.Generator().manual_seed(9)
    wk = torch.randn(4, 4, 8, 128, generator=g).to(d)
    wv = torch.randn(4, 4, 8, 128, generator=g).to(d)
    start = torch.tensor([3 * 64 - 2, 7 * 64 - 9, 5, -1], dtype=torch.int32,
                         device=d)
    qp = (start.clamp(min=0) + 3).to(torch.int32)
    run = lambda: paged_attention_decode_window(  # noqa: E731
        q, kp, vp, 0, table, start, qp, wk, wv, 4)
    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = run()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


# ------------------------------------------------ decode windows as graphs


def _window_case(dev, dtype):
    """A tiny model at a kernel-route width (head_dim 64, page 16), four
    rows prefilled to 37, 16 and 5 positions plus a padding row, and the
    inputs of one fused window: greedy rows, one sampled row, one stop
    id."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig.tiny(head_dim=64, dtype=(
        "bfloat16" if dtype == torch.bfloat16 else "float32"))
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    ps, N, B, P, T = 16, 40, 4, 8, 48
    kk, vv = llama.init_kv_cache(cfg, llama.KVCacheSpec(N, ps), device=dev)
    lens = [37, 16, 5, 0]
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(1, 500, (B, T), generator=g, dtype=torch.int32)
    positions = torch.full((B, T), -1, dtype=torch.int32)
    table = torch.zeros((B, P), dtype=torch.int32)
    slots = torch.full((B, T), llama.DROP_SLOT, dtype=torch.int32)
    for b, n in enumerate(lens):
        positions[b, :n] = torch.arange(n)
        table[b, :5] = torch.arange(1 + 5 * b, 6 + 5 * b)
        p = torch.arange(n)
        slots[b, :n] = table[b, p // ps] * ps + p % ps
    pre, _ = llama.make_step_fns(cfg)
    last = torch.tensor([max(n - 1, 0) for n in lens], dtype=torch.int32)
    pre(params, *(t.to(dev) for t in (tokens, positions)), kk, vv,
        *(t.to(dev) for t in (table, slots, last)))
    i32 = dict(dtype=torch.int32, device=dev)
    inputs = (
        torch.tensor([7, 8, 9, 0], **i32),
        torch.tensor([n if n else -1 for n in lens], **i32),
        torch.zeros(B, dtype=torch.bool, device=dev),
        torch.tensor([1, 1, 1, 0], **i32), torch.tensor([9, 9, 2, 1], **i32),
        table.to(dev), torch.tensor([0.0, 0.8, 0.0, 0.0], device=dev),
        torch.tensor([0, 8, 0, 0], **i32),
        torch.tensor([1.0, 0.9, 1.0, 1.0], device=dev),
        torch.tensor([0, 77, 0, 0], dtype=torch.int64, device=dev),
        torch.tensor([[-1, -1], [-1, -1], [11, -1], [-1, -1]], **i32))
    window = llama.make_decode_window_fn(cfg, max_top_k=16)
    return params, kk, vv, window, inputs


def _fill(bk, inputs):
    statics = bk.carry_in + (bk.table, bk.temperature, bk.top_k, bk.top_p,
                             bk.seeds, bk.eos)
    for dst, src in zip(statics, inputs):
        dst.copy_(src)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_graph_window_matches_eager(cuda_device, dtype):
    """One fused window by graph replay and one called eagerly from the
    same inputs and pools: tokens, emitted counts and carry identical;
    the committed K/V within the dtype's tolerance (and, as the same
    kernels run on the same inputs, expected bitwise equal)."""
    from dynamo_tpu_torch.engine.cuda_graphs import DecodeGraphs

    params, kk, vv, window, inputs = _window_case(cuda_device, dtype)
    ek, ev = kk.clone(), vv.clone()
    e_toks, e_n, e_carry, _, _ = window(params, *inputs[:5], ek, ev,
                                        *inputs[5:], k_steps=4)
    graphs = DecodeGraphs(window, params, kk, vv, k_steps=4, max_eos_ids=2)
    graphs.capture([(4, 8)])
    bk = graphs.buckets[(4, 8)]
    assert bk.graph is not None
    with graphs.stream_ctx():
        _fill(bk, inputs)
        graphs.launch(bk)
    torch.cuda.synchronize()
    assert torch.equal(bk.toks, e_toks) and torch.equal(bk.emitted, e_n)
    for a, b in zip(bk.carry, e_carry):
        assert torch.equal(a, b)
    assert e_n.tolist()[3] == 0 and e_n.tolist()[0] == 4
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for got, want in ((kk, ek), (vv, ev)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_graph_launch_on_an_unwarmed_stream_raises(cuda_device):
    """The graphs run on the stream they were warmed and captured on,
    where the caller stages their inputs and reads their outputs: a
    launch from any other stream fails loudly."""
    from dynamo_tpu_torch.engine.cuda_graphs import DecodeGraphs

    params, kk, vv, window, inputs = _window_case(cuda_device,
                                                  torch.bfloat16)
    graphs = DecodeGraphs(window, params, kk, vv, k_steps=4, max_eos_ids=2)
    graphs.capture([(4, 8)])
    bk = graphs.buckets[(4, 8)]
    with torch.cuda.stream(torch.cuda.Stream()):
        with pytest.raises(RuntimeError, match="never warmed"):
            graphs.launch(bk)
    with graphs.stream_ctx():
        graphs.launch(bk)  # its own stream: runs
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_graph_replay_counts_equal_eager_counts(cuda_device):
    """A replay adds the launch counts its capture recorded: the same as
    one eager call of the window, all on the bf16 decode route; the
    capture itself adds none."""
    from dynamo_tpu_torch.engine.cuda_graphs import DecodeGraphs

    params, kk, vv, window, inputs = _window_case(cuda_device,
                                                  torch.bfloat16)
    ops.reset_launch_counts()
    window(params, *inputs[:5], kk.clone(), vv.clone(), *inputs[5:],
           k_steps=4)
    eager = (dict(ops.LAUNCHES), dict(ops.DECODE_ROUTE_LAUNCHES))
    graphs = DecodeGraphs(window, params, kk, vv, k_steps=4, max_eos_ids=2)
    graphs.capture([(4, 8)])
    ops.reset_launch_counts()
    graphs.capture([(4, 8)])  # captured already: nothing happens
    assert sum(ops.LAUNCHES.values()) == 0
    bk = graphs.buckets[(4, 8)]
    with graphs.stream_ctx():
        _fill(bk, inputs)
        graphs.launch(bk)
        graphs.launch(bk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {k: 2 * n for k, n in eager[0].items()}
    assert ops.DECODE_ROUTE_LAUNCHES == {k: 2 * n for k, n in
                                         eager[1].items()}
    assert eager[1] == _counts(ops.DECODE_ROUTES, bf16_mma=8)


@pytest.mark.cuda
@pytest.mark.parametrize("topn,form,counts", [
    (3, 0, False), (0, 1, False), (0, 1, True), (3, 1, True)])
def test_cuda_graph_window_variants_match_eager(cuda_device, topn, form,
                                                counts):
    """The logprobs and penalised variants of the window by graph replay
    against the same window called eagerly on the same inputs, pools and
    penalty buffers: tokens, emitted counts, carry and logprobs aux
    identical; logit_bias +100 on token 5 forces row 0 at every step;
    the state rebuilt on the device from the rows' ids, read with the
    rows' penalties (``counts``) or left unread under neutral ones (a
    logit_bias-only batch)."""
    from dynamo_tpu_torch.engine.cuda_graphs import (PEN_FULL, DecodeGraphs,
                                                     PenaltyBuffers)
    from dynamo_tpu_torch.engine.sampling import fill_penalty_state

    params, kk, vv, window, inputs = _window_case(cuda_device,
                                                  torch.bfloat16)
    bufs = None
    if form:
        bufs = PenaltyBuffers.make(4, params["embed"].shape[0], cuda_device)
        f32 = dict(dtype=torch.float32, device=cuda_device)
        bufs.bias[0, 5] = 100.0
        if counts:
            bufs.rep.copy_(torch.tensor([1.0, 1.5, 1.2, 1.0], **f32))
            bufs.freq.copy_(torch.tensor([0.0, 0.5, 0.0, 0.0], **f32))
            bufs.pres.copy_(torch.tensor([0.0, 0.0, 0.7, 0.0], **f32))
        ids = torch.randint(0, 500, (4, 20), generator=torch.Generator(
            ).manual_seed(2), dtype=torch.int32).to(cuda_device)
        fill_penalty_state(bufs.counts, bufs.presence, ids,
                           torch.tensor([10, 5, 0, 20], device=cuda_device))
    assert form in (0, PEN_FULL)
    graphs = DecodeGraphs(window, params, kk, vv, k_steps=4, max_eos_ids=2,
                          logprobs_topn=topn, penalty_form=form,
                          penalty_buffers=bufs)
    graphs.capture([(4, 8)])
    bk = graphs.buckets[(4, 8)]
    ek, ev = kk.clone(), vv.clone()
    out = window(params, *inputs[:5], ek, ev, *inputs[5:], bk.pen,
                 k_steps=4, logprobs_topn=topn)
    with graphs.stream_ctx():
        _fill(bk, inputs)
        graphs.launch(bk)
    torch.cuda.synchronize()
    assert torch.equal(bk.toks, out[0]) and torch.equal(bk.emitted, out[1])
    for a, b in zip(bk.carry, out[-3]):
        assert torch.equal(a, b)
    if topn:
        assert len(bk.aux) == 3 and bk.aux[1].shape == (4, 4, topn)
        for a, b in zip(bk.aux, out[2]):
            assert torch.equal(a, b)
    if form:
        assert bk.toks[0].tolist() == [5] * 4
    assert torch.equal(kk, ek) and torch.equal(vv, ev)


# ------------------------------------------------ prefill chunks as graphs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_graph_prefill_matches_eager(cuda_device, dtype):
    """One prefill chunk and its first-token draw by graph replay and the
    same called eagerly from the same inputs and pools, at a kernel-route
    width (head_dim 64, page 16): a batch bucket of 4 rows of 32 with a
    third chunk, a short row, a sampled row and a padding row. Logits,
    drawn tokens and the whole pools bitwise equal; the replay adds the
    prefill kernel's launches of one eager chunk (one per layer), and the
    capture only those of its eager warm call."""
    from dynamo_tpu_torch.engine.cuda_graphs import PrefillGraphs, to_device
    from dynamo_tpu_torch.engine.sampling import sample_tokens
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig.tiny(head_dim=64, dtype=(
        "bfloat16" if dtype == torch.bfloat16 else "float32"))
    params = llama.init_params(cfg, torch.Generator(
        device=cuda_device).manual_seed(0))
    ps, N = 16, 40
    kk, vv = llama.init_kv_cache(cfg, llama.KVCacheSpec(N, ps),
                                 device=cuda_device)
    kk.normal_()
    vv.normal_()
    pre, _ = llama.make_step_fns(cfg)
    graphs = PrefillGraphs(pre, params, kk, vv, page_size=ps, num_pages=N,
                           max_top_k=16)
    ops.reset_launch_counts()
    graphs.capture([(4, 32, 8, True)])
    assert ops.LAUNCHES == {"paged_attention_decode": 0,
                            "paged_attention_prefill": cfg.num_layers}
    bk = graphs.buckets[(4, 32, 8, True)]
    assert bk.graph is not None
    img, f = bk.host_inputs()
    rng = np.random.RandomState(3)
    # (start, length, pages, temperature, top_k, seed)
    rows = [(32, 32, [1, 2, 3, 4], 0.0, 0, 0), (0, 20, [5, 6], 0.0, 0, 0),
            (0, 5, [7], 0.8, 8, 77)]
    for i, (start, n, pages, temp, top_k, seed) in enumerate(rows):
        pos = np.arange(start, start + n)
        pg = np.asarray(pages)
        f["tokens"][i, :n] = rng.randint(1, 500, n)
        f["positions"][i, :n] = pos
        f["table"][i, :len(pages)] = pages
        f["last_idx"][i] = n - 1
        f["slots"][i, :n] = pg[pos // ps] * ps + pos % ps
        npg = -(-n // ps)
        f["pslots"][i, :npg] = pg[start // ps:start // ps + npg]
        f["temperature"][i], f["top_k"][i], f["seeds"][i] = temp, top_k, seed
    k0, v0 = kk.clone(), vv.clone()
    with graphs.stream_ctx():
        d = {k: to_device(np.array(v), cuda_device) for k, v in f.items()}
        ops.reset_launch_counts()
        e_logits, _, _ = pre(params, d["tokens"], d["positions"], kk, vv,
                             d["table"], d["slots"], d["last_idx"],
                             d["pslots"])
        e_tok = sample_tokens(e_logits, d["temperature"], d["top_k"],
                              d["top_p"], d["seeds"], d["steps"],
                              max_top_k=16)
        eager = dict(ops.LAUNCHES)
        e_k, e_v = kk.clone(), vv.clone()
        kk.copy_(k0)
        vv.copy_(v0)
        ops.reset_launch_counts()
        graphs.run(bk, img)
    torch.cuda.synchronize()
    assert eager["paged_attention_prefill"] == cfg.num_layers
    assert ops.LAUNCHES == eager
    assert torch.equal(bk.logits, e_logits)
    assert torch.equal(bk.sampled, e_tok)
    assert torch.equal(kk, e_k) and torch.equal(vv, e_v)
    # the chunk wrote its rows' pages only
    changed = (e_k != k0).flatten(2).any(-1).any(0).nonzero()[:, 0]
    assert set(changed.tolist()) <= {1, 2, 3, 4, 5, 6, 7}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,rtol", DTYPE_TOLS)
@pytest.mark.parametrize("tp", [2, 4, 8])
def test_cuda_sharded_wrappers_at_one_ranks_heads(cuda_device, tp, dtype,
                                                  tol, rtol):
    """The tensor-parallel wrappers at the heads one rank of tp holds of
    the 8B widths (32/tp q heads, 8/tp kv heads, group 4): the decode
    kernel with stats, in the window form at every step, and the prefill
    kernel (a first chunk of 512, a second chunk with a sliding window),
    against their plain versions (the same wrappers on the CPU). At 8/tp
    kv heads the split plan gives a row up to one split per page; the
    bf16 and float16 calls stay on the bf16 decode kernel's form of their
    type, and on the prefill kernel's."""
    from dynamo_tpu_torch.parallel.mesh import MeshSpec

    d = cuda_device
    mesh = MeshSpec(model=tp).view(tp - 1)
    lengths = [0, 1, 64, 300, 700, 1000]
    q, kp, vp, table = _decode_pool(4, 128, 64, [16] * len(lengths),
                                    KV=8 // tp, dtype=dtype, seed=tp)
    B, Kw = len(lengths), 4
    ln = torch.tensor(lengths, dtype=torch.int32)
    lo = torch.tensor([0, 0, 10, 200, 0, 900], dtype=torch.int32)
    cuda = [t.to(d) for t in (q, kp, vp, table, ln, lo)]
    ops.reset_launch_counts()
    want = ops.paged_attention_decode_sharded(
        q, kp, vp, 1, table, ln, mesh=mesh, kv_heads=8, softcap=30.0,
        lower=lo)
    got = ops.paged_attention_decode_sharded(
        *cuda[:3], 1, *cuda[3:5], mesh=mesh, kv_heads=8, softcap=30.0,
        lower=cuda[5])
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(got[0].cpu()), _np(want[0]), rtol=rtol,
                               atol=tol)
    for w, x in zip(want[1:], got[1:]):
        np.testing.assert_allclose(_np(x.cpu()), _np(w), rtol=1e-4,
                                   atol=1e-4)
    g = torch.Generator().manual_seed(tp)
    wk = torch.randn(B, Kw, 8 // tp, 128, generator=g).to(dtype)
    wv = torch.randn(B, Kw, 8 // tp, 128, generator=g).to(dtype)
    start = torch.tensor([n - 1 if n else -1 for n in lengths],
                         dtype=torch.int32)
    for n_win in range(1, Kw + 1):
        qp = (start.clamp(min=0) + n_win - 1).to(torch.int32)
        args = (q, kp, vp, 0, table, start, qp, wk, wv, n_win)
        want = ops.paged_attention_decode_window_sharded(
            *args, mesh=mesh, kv_heads=8)
        got = ops.paged_attention_decode_window_sharded(
            *(a.to(d) if torch.is_tensor(a) else a for a in args),
            mesh=mesh, kv_heads=8)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_np(got.cpu()), _np(want), rtol=rtol,
                                   atol=tol)
    assert ops.LAUNCHES == {"paged_attention_decode": 1 + Kw,
                            "paged_attention_prefill": 0}
    route = MMA_ROUTE.get(dtype, "f32")
    assert ops.DECODE_ROUTE_LAUNCHES == _counts(ops.DECODE_ROUTES,
                                                **{route: 1 + Kw})
    pos = torch.full((2, 512), -1, dtype=torch.int32)
    pos[0] = torch.arange(512)
    pos[1, :256] = torch.arange(512, 768)
    qf = torch.randn(2, 512, 32 // tp, 128, generator=g).to(dtype)
    win = torch.tensor([ops.NO_WINDOW, 300], dtype=torch.int32)
    args = (qf, kp[0], vp[0], table[:2].contiguous(), pos)
    want = ops.paged_attention_prefill_sharded(
        *args, mesh=mesh, kv_heads=8, softcap=20.0, eff_win=win)
    got = ops.paged_attention_prefill_sharded(
        *(a.to(d) for a in args), mesh=mesh, kv_heads=8, softcap=20.0,
        eff_win=win.to(d))
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(got.cpu()), _np(want), rtol=rtol,
                               atol=tol)
    assert ops.LAUNCHES["paged_attention_prefill"] == 1
    assert ops.PREFILL_ROUTE_LAUNCHES == _counts(
        ops.PREFILL_ROUTES, **{PF_ROUTE.get(dtype, "f32"): 1})


# ------------------------------------------------------- int8 GEMM


# the 8B model's projections (K, N): wq and wo, wk and wv, w_gate and
# w_up, w_down, lm_head; and one rank's at tp=2
INT8_SHAPES = {"wq_wo": (4096, 4096), "wk_wv": (4096, 1024),
               "gate_up": (4096, 14336), "down": (14336, 4096),
               "lm_head": (4096, 128256)}
INT8_TP2_SHAPES = {"wq": (4096, 2048), "wk_wv": (4096, 512),
                   "gate_up": (4096, 7168), "lm_head": (4096, 64128),
                   "wo": (2048, 4096), "down": (7168, 4096)}
# Llama-3.2-1B's projections, where the float32 forms are served
INT8_1B_SHAPES = {"1b wq_wo": (2048, 2048), "1b wk_wv": (2048, 512),
                  "1b gate_up": (2048, 8192), "1b down": (8192, 2048),
                  "1b lm_head": (2048, 128256)}
# every form: bfloat16, float16 and float32 x
FORMS = HALF + [torch.float32]


def _int8_case(dev, M, K, N, seed=0, dtype=torch.bfloat16):
    """x [M, K] in ``dtype`` and the int8 weights of a random [K, N]
    weight (quantize_int8 on the card): (x, q [N, K], s [N])."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=dev).to(dtype)
    w = torch.randn(K, N, generator=g, device=dev) / K ** 0.5
    qw = quantize_int8(w)
    return x, qw.q, qw.s.reshape(-1)


def _int8_excess(y, x, q, s) -> float:
    """The largest amount by which the kernel's output passes the stated
    tolerance (ops/int8_gemm.py int8_gemm_tolerance; <= 0 within it)."""
    ref, tol = int8_gemm_tolerance(x, q, s)
    return float(((y.float().reshape(ref.shape) - ref).abs() - tol).max())


def _int8_check(dev, M, K, N, seed=0, dtype=torch.bfloat16):
    x, q, s = _int8_case(dev, M, K, N, seed, dtype)
    int8_gemm.reset_launch_counts()
    y = int8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert y.dtype == dtype and tuple(y.shape) == (M, N)
    assert _int8_excess(y, x, q, s) <= 0
    route = int8_gemm.int8_gemm_plan(
        M, N, K, torch.cuda.get_device_properties(dev).multi_processor_count,
        dtype).route
    assert route in int8_gemm.INT8_GEMM_ROUTES
    # one launch, on the form of x's dtype (the float32 forms for float32)
    assert int8_gemm.INT8_GEMM_LAUNCHES == _counts(
        int8_gemm.INT8_GEMM_LAUNCHES, **{int8_gemm.launch_key(route, dtype): 1})
    return x, q, s, y


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("M", [1, 4, 16, 32, 48, 64, 512, 4096])
@pytest.mark.parametrize("shape", sorted(INT8_SHAPES))
def test_cuda_int8_gemm_matches_plain(cuda_device, shape, M, dtype):
    """The kernels at the served shapes, both tensor-core routes (bf16 and
    their float16 forms) and the rows about their crossover, within the
    stated tolerance of the float32 evaluation of their plain version."""
    _int8_check(cuda_device, M, *INT8_SHAPES[shape], dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 16, 24, 32, 48, 64, 512, 4096])
@pytest.mark.parametrize("shape", sorted(INT8_SHAPES) + sorted(INT8_1B_SHAPES))
def test_cuda_int8_gemm_f32_matches_plain(cuda_device, shape, M):
    """The float32 forms (2xTF32 small_m and wgmma) at every projection of
    the 1b and the 8B model, over their crossover and a chunk's rows,
    within the stated tolerance (2^-24 of the output plus 2^-16 of the
    sum of the terms' magnitudes)."""
    K, N = {**INT8_SHAPES, **INT8_1B_SHAPES}[shape]
    _int8_check(cuda_device, M, K, N, dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FORMS)
@pytest.mark.parametrize("M", [4, 512])
@pytest.mark.parametrize("shape", sorted(INT8_TP2_SHAPES))
def test_cuda_int8_gemm_at_tp2_shapes(cuda_device, shape, M, dtype):
    _int8_check(cuda_device, M, *INT8_TP2_SHAPES[shape], dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FORMS)
@pytest.mark.parametrize("M,K,N", [(3, 4096, 1000), (37, 4096, 130),
                                   (100, 4096, 4100), (300, 1040, 1000),
                                   (17, 16, 33), (129, 48, 7)])
def test_cuda_int8_gemm_ragged(cuda_device, M, K, N, dtype):
    """Ragged M and N (masked loads and stores), and K not a multiple of
    the 64-wide chunk."""
    _int8_check(cuda_device, M, K, N, seed=1, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("M,K,N", [(1, 64, 192), (7, 64, 64), (33, 128, 64),
                                   (300, 1040, 1000)])
def test_cuda_int8_gemm_simt_route(cuda_device, M, K, N, dtype):
    """The shapes the simt route took (the tiny preset's, served in
    float32) on the tensor-core routes' forms that replaced it: float32
    x on the float32 forms (2xTF32), float16 x on the float16 forms,
    within one rounding to x's dtype and the summation order."""
    _int8_check(cuda_device, M, K, N, seed=4, dtype=dtype)


@pytest.mark.cuda
def test_cuda_int8_f16_forms_hold_as_many_blocks_as_bf16(cuda_device):
    """The plans take the bf16 kernels' co-resident counts for the
    float16 forms: the CUDA driver's counts of the float16 forms are the
    same at every tile and cluster size; and a route the C entry does not
    know (the simt route's old number) is refused."""
    for tile in (1, 2) + int8_gemm.WG_TOKENS:
        for splits in range(1, int8_gemm.MAX_SPLITS + 1):
            bf = int8_gemm.resident_count(tile, splits, torch.bfloat16)
            assert bf > 0, (tile, splits)
            assert int8_gemm.resident_count(tile, splits,
                                            torch.float16) == bf
    x, q, s = _int8_case(cuda_device, 4, 64, 64, dtype=torch.float16)
    y = torch.empty(4, 64, dtype=torch.float16, device=cuda_device)
    for dtype in (0, 1, 2):
        assert int8_gemm._lib().dyn_int8_gemm(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), 4, 64,
            64, 2, 32, 1, 2, dtype,
            torch.cuda.current_stream().cuda_stream) != 0


@pytest.mark.cuda
def test_cuda_int8_f32_plan_uses_its_forms_resident_count(cuda_device):
    """The float32 plans take the float32 forms' own co-resident counts
    from the CUDA driver (its kernels hold other shared memory than the
    bf16 ones): positive at every float32 tile and cluster size, the
    counts resident_of hands the plan, and a float32 plan's grid within
    them; the float32 forms refuse a 256-token tile and more than 16 rows
    on small_m."""
    dev = cuda_device
    resident = int8_gemm.resident_of(dev, torch.float32)
    for tile in (1, 2) + int8_gemm.WG_TOKENS_F32:
        for splits in range(1, int8_gemm.MAX_SPLITS + 1):
            n = int8_gemm.resident_count(tile, splits, torch.float32)
            assert n > 0, (tile, splits)
            if tile > 2:
                assert resident(tile, splits) == n
    for M, K, N in ((4096, 2048, 2048), (512, 2048, 128256), (48, 8192, 2048)):
        plan = int8_gemm.device_plan(M, N, K, dev, torch.float32)
        assert plan.route == "wgmma"
        assert plan.grid // plan.splits <= int8_gemm.resident_count(
            plan.tile, plan.splits, torch.float32)
    x, q, s = _int8_case(dev, 17, 64, 64, dtype=torch.float32)
    for bad in (int8_gemm.Int8Plan("wgmma", 256, 1, 1),
                int8_gemm.Int8Plan("small_m", 2, 1, 1)):
        with pytest.raises(RuntimeError, match="launch failed"):
            int8_matmul(x, q, s, plan=bad)


@pytest.mark.cuda
@pytest.mark.parametrize("M,dtype", [(4, torch.bfloat16), (32, torch.bfloat16),
                                     (512, torch.bfloat16),
                                     (4, torch.float32), (16, torch.float32),
                                     (512, torch.float32), (4, torch.float16),
                                     (512, torch.float16)])
def test_cuda_int8_gemm_perturbed_scale_fails_the_check(cuda_device, M,
                                                        dtype):
    """The control, at every route: one scale 1 + 2^-5 off must show in
    the check."""
    x, q, s, y = _int8_check(cuda_device, M, 4096, 1024, dtype=dtype)
    bad = s.clone()
    bad[7] *= 1 + 2.0 ** -5
    assert _int8_excess(int8_matmul(x, q, bad), x, q, s) > 0


def _small_m_plan(dev, M, N, K, dtype=torch.bfloat16):
    """The small-M route's launch of a call on this card (the CUDA
    driver's cluster counts), whichever route the crossover names."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return int8_gemm.small_m_plan(M, N, K, sms,
                                  int8_gemm.resident_of(dev, dtype), dtype)


def _small_m_check(dev, M, K, N, seed=0, dtype=torch.bfloat16):
    x, q, s = _int8_case(dev, M, K, N, seed, dtype)
    int8_gemm.reset_launch_counts()
    y = int8_matmul(x, q, s, plan=_small_m_plan(dev, M, N, K, dtype))
    torch.cuda.synchronize()
    assert y.dtype == dtype and tuple(y.shape) == (M, N)
    assert _int8_excess(y, x, q, s) <= 0
    assert int8_gemm.INT8_GEMM_LAUNCHES == _counts(
        int8_gemm.INT8_GEMM_LAUNCHES,
        **{int8_gemm.launch_key("small_m", dtype): 1})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("M", [1, 2, 4, 8, 16, 24, 32])
@pytest.mark.parametrize("shape", sorted(INT8_SHAPES) + [
    f"tp2 {n}" for n in sorted(INT8_TP2_SHAPES)])
def test_cuda_int8_small_m_at_served_shapes(cuda_device, shape, M, dtype):
    """The small-M route (TMA ring, programmatic launch, K split over a
    cluster of up to 8 blocks) at every served shape, tp=1 and tp=2, at
    every row count it can take, forced where the crossover sends the
    call to the wgmma route."""
    K, N = (INT8_TP2_SHAPES[shape[4:]] if shape.startswith("tp2 ")
            else INT8_SHAPES[shape])
    _small_m_check(cuda_device, M, K, N, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("M", [1, 5, 17, 32])
@pytest.mark.parametrize("K,N", [(4096, 33), (4096, 130), (4096, 1000),
                                 (16, 1000), (48, 1000), (1040, 1000)])
def test_cuda_int8_small_m_ragged(cuda_device, M, K, N, dtype):
    """The small-M route on ragged N (a partial 64-channel tile, odd N)
    and K tails (less than one 128-wide stage; a stage past K's end),
    where TMA fills the boxes past the tensors with zeros."""
    _small_m_check(cuda_device, M, K, N, seed=6, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 2, 4, 8, 9, 12, 16])
@pytest.mark.parametrize("shape", sorted(INT8_1B_SHAPES) + sorted(INT8_SHAPES)
                         + [f"tp2 {n}" for n in sorted(INT8_TP2_SHAPES)])
def test_cuda_int8_small_m_f32_at_served_shapes(cuda_device, shape, M):
    """The small-M route's float32 form (2xTF32 mma.sync m16n8k8, the
    weights as A and the tokens as n8) at every row count it takes (one
    or two n8 tiles), forced where the crossover names wgmma."""
    K, N = ({**INT8_1B_SHAPES, **INT8_SHAPES}.get(shape)
            or INT8_TP2_SHAPES[shape[4:]])
    _small_m_check(cuda_device, M, K, N, dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 5, 16])
@pytest.mark.parametrize("K,N", [(4096, 33), (4096, 130), (16, 1000),
                                 (48, 1000), (1040, 1000), (64, 64)])
def test_cuda_int8_small_m_f32_ragged(cuda_device, M, K, N):
    """The float32 small-M form on ragged N and K tails (boxes of 32
    floats past K's end filled with zeros)."""
    _small_m_check(cuda_device, M, K, N, seed=6, dtype=torch.float32)


# (M, K, N, tokens a tile, K splits) of the float32 wgmma form's forced
# launches: every tile width at K splits of 1, 2 and 8 where a split keeps
# two 64-wide chunks (K = 48 has one chunk: splits 1 alone)
WGMMA_F32_LAUNCHES = [
    (M, K, N, tokens, splits)
    for M, K, N in ((5, 2048, 2048), (100, 8192, 2048), (300, 1040, 1000),
                    (17, 48, 33))
    for tokens in (16, 32, 64, 128) for splits in (1, 2, 8)
    if splits == 1 or -(-K // 64) >= 2 * splits]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,tokens,splits", WGMMA_F32_LAUNCHES)
def test_cuda_int8_wgmma_f32_every_tile(cuda_device, M, K, N, tokens,
                                        splits):
    """The float32 wgmma form at every tile width and K splits of 1, 2
    and 8 (forced), ragged M, N and K among them: within the tolerance,
    one launch under wgmma_f32."""
    dev = cuda_device
    x, q, s = _int8_case(dev, M, K, N, seed=11, dtype=torch.float32)
    tiles = -(-M // tokens) * -(-N // int8_gemm.WG_TILE_N)
    res = int8_gemm.resident_of(dev, torch.float32)(tokens, splits)
    plan = int8_gemm.Int8Plan("wgmma", tokens, splits,
                              min(tiles, res) * splits)
    int8_gemm.reset_launch_counts()
    y = int8_matmul(x, q, s, plan=plan)
    torch.cuda.synchronize()
    assert _int8_excess(y, x, q, s) <= 0
    assert int8_gemm.INT8_GEMM_LAUNCHES == _counts(
        int8_gemm.INT8_GEMM_LAUNCHES, wgmma_f32=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FORMS)
@pytest.mark.parametrize("M,N", [(4, 1024), (64, 14336), (512, 4096),
                                 (512, 1024), (48, 4096), (4, 512),
                                 (32, 512)])
def test_cuda_int8_gemm_replay_equals_eager(cuda_device, M, N, dtype):
    """Deterministic: two eager calls and a captured graph's replay give
    the same bits (the K splits fold in a fixed order; 512 x 1024 and
    48 x 4096 split K over the wgmma route's clusters, 4 x 512 and 32 x
    512 over the small-M route's deepest, eight blocks; the small-M
    launch is programmatic in the graph too)."""
    x, q, s = _int8_case(cuda_device, M, 4096, N, seed=2, dtype=dtype)
    eager = int8_matmul(x, q, s)
    assert torch.equal(int8_matmul(x, q, s), eager)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = int8_matmul(x, q, s)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


def _graph(fn, stream):
    """A CUDA graph of ``fn`` captured on ``stream`` after one warm-up
    call there."""
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    out = {}
    with torch.cuda.graph(graph, stream=stream):
        out["y"] = fn()
    return graph, out


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(4, 4096, 4096), (4, 4096, 1024),
                                   (32, 4096, 1024), (16, 4096, 512)])
def test_cuda_int8_small_m_reads_x_after_the_kernel_that_writes_it(
        cuda_device, M, K, N):
    """The race programmatic launch opens: in one graph a kernel writes x
    (``torch.add(x_src, 0, out=x)``) and the small-M launch, which may
    start before that kernel ends, reads it. Over 20 replays with a new
    x each, every output is within the tolerance of the plain version on
    that x: the kernel touches x only after griddepcontrol.wait."""
    dev = cuda_device
    _, q, s = _int8_case(dev, M, K, N, seed=7)
    assert int8_gemm.device_plan(M, N, K, dev).route == "small_m"
    x_src = torch.zeros(M, K, dtype=torch.bfloat16, device=dev)
    x = torch.empty_like(x_src)

    def step():
        torch.add(x_src, 0, out=x)
        return int8_matmul(x, q, s)

    graph, out = _graph(step, torch.cuda.Stream())
    g = torch.Generator(device=dev).manual_seed(8)
    for _ in range(20):
        x_src.copy_(torch.randn(M, K, generator=g, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        assert _int8_excess(out["y"], x_src, q, s) <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(4, 4096, 4096), (16, 4096, 1024)])
def test_cuda_int8_small_m_writes_y_after_the_kernel_that_reads_it(
        cuda_device, M, K, N):
    """The other side of the race: y's storage is memory the caching
    allocator has just freed from a tensor that the kernel before it
    (in the same graph) reads. That kernel's output must hold what it
    read, 20 replays over, and y the product: the small-M kernel writes
    y only after griddepcontrol.wait."""
    dev = cuda_device
    x, q, s = _int8_case(dev, M, K, N, seed=9)
    src = torch.zeros(M, N, dtype=torch.bfloat16, device=dev)
    z = torch.empty_like(src)
    ptrs = {}

    def step():
        tmp = src.clone()
        torch.add(tmp, 0, out=z)
        ptrs["tmp"] = tmp.data_ptr()
        del tmp
        y = int8_matmul(x, q, s)
        ptrs["y"] = y.data_ptr()
        return y

    graph, out = _graph(step, torch.cuda.Stream())
    assert ptrs["y"] == ptrs["tmp"], "y did not reuse the freed storage"
    g = torch.Generator(device=dev).manual_seed(10)
    for _ in range(20):
        src.copy_(torch.randn(M, N, generator=g, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(z, src)
        assert _int8_excess(out["y"], x, q, s) <= 0


@pytest.mark.cuda
def test_cuda_int8_gemm_refuses_what_it_does_not_take(cuda_device):
    d = cuda_device
    q = torch.zeros(8, 4100, dtype=torch.int8, device=d)
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_matmul(torch.zeros(2, 4100, dtype=torch.bfloat16, device=d), q,
                    torch.ones(8, device=d))
    # float32 x is served (the float32 forms), float64 refused
    x, q, s = _int8_case(d, 2, 64, 8, seed=5, dtype=torch.float32)
    assert _int8_excess(int8_matmul(x, q, s), x, q, s) <= 0
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        int8_matmul(torch.zeros(2, 64, dtype=torch.float64, device=d), q, s)
    with pytest.raises(ValueError, match="contiguous"):
        int8_matmul(torch.zeros(2, 128, dtype=torch.bfloat16,
                                device=d)[:, ::2], q, s)
    with pytest.raises(ValueError, match="mixed"):
        int8_matmul(torch.zeros(2, 64, dtype=torch.bfloat16, device=d),
                    q.cpu(), s)
    # the small-M kernel takes at most 32 rows (two m16 tiles)
    x, q, s = _int8_case(d, 33, 64, 8, seed=5)
    with pytest.raises(RuntimeError, match="launch failed"):
        int8_matmul(x, q, s, plan=int8_gemm.Int8Plan("small_m", 4, 1, 1))


@pytest.mark.cuda
def test_cuda_quant_int8_rmatmul_reaches_the_kernel(cuda_device):
    """``x @ QuantInt8`` on the card (torch's __matmul__ defers to
    __rmatmul__) launches the kernel over leading dimensions; the plain
    flag takes the plain version."""
    x, q, s = _int8_case(cuda_device, 6, 256, 96, seed=3)
    qw = QuantInt8(q, s.reshape(1, -1))
    int8_gemm.reset_launch_counts()
    y = x.reshape(2, 3, 256) @ qw
    assert tuple(y.shape) == (2, 3, 96)
    assert int8_gemm.INT8_GEMM_LAUNCHES["small_m"] == 1
    plain = x @ qw.as_plain()
    assert int8_gemm.INT8_GEMM_LAUNCHES["small_m"] == 1
    assert torch.equal(plain, int8_matmul_plain(x, q, s))
    assert _int8_excess(y, x, q, s) <= 0


@pytest.mark.cuda
def test_cuda_tiny_int8_engine_matches_its_plain_path(cuda_device):
    """The launcher's default model (the float32 tiny preset) served in
    int8 on the card: its greedy tokens equal those of the same int8
    weights multiplied through the plain version (``QuantInt8.as_plain``),
    and its products went through the float32 forms alone."""
    import asyncio

    from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                       StopConditions)
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.runtime.engine import Context

    ecfg = dict(page_size=8, num_pages=64, max_batch=4, prefill_chunk=16,
                prefill_buckets=(16,), batch_buckets=(1, 2, 4),
                page_buckets=(8,), decode_steps=4)
    prompts = [list(range(1, 6)), list(range(30, 70)), [7, 7, 7]]
    max_tokens = [9, 12, 5]

    def run(engine):
        async def one(p, n):
            req = PreprocessedRequest(token_ids=list(p),
                                      stop=StopConditions(max_tokens=n))
            toks = []
            async for out in engine.generate(req, Context()):
                toks += out.token_ids
            return toks

        async def all_():
            try:
                return await asyncio.gather(*[
                    one(p, n) for p, n in zip(prompts, max_tokens)])
            finally:
                await engine.stop()
        return asyncio.run(all_())

    engine = TorchEngine(ModelConfig.tiny(), EngineConfig(**ecfg), seed=0,
                         device="cuda", quant="int8")
    plain_params = {k: v.as_plain() if isinstance(v, QuantInt8) else v
                    for k, v in engine.params.items()}
    plain = TorchEngine(ModelConfig.tiny(), EngineConfig(**ecfg),
                        params=plain_params, device="cuda")
    int8_gemm.reset_launch_counts()
    got = run(engine)
    f32 = {k: n for k, n in int8_gemm.INT8_GEMM_LAUNCHES.items()
           if k.endswith("_f32")}
    assert f32["small_m_f32"] > 0
    assert sum(int8_gemm.INT8_GEMM_LAUNCHES.values()) == sum(f32.values())
    launches = dict(int8_gemm.INT8_GEMM_LAUNCHES)
    want = run(plain)
    assert int8_gemm.INT8_GEMM_LAUNCHES == launches
    assert got == want
    assert [len(t) for t in got] == max_tokens
