"""The CUDA kernels of the port against their plain PyTorch versions.

These run only where there is an NVIDIA GPU (``cuda`` marker; they skip
elsewhere, deciding inside the fixture): the kernels have no CPU mode.
The file imports nothing of JAX, so it runs on a machine without it:

    python -m pytest -m cuda tests/test_torch_kernels.py

Tolerances: atol 1e-5 in float32 (same math, another summation order);
atol 2e-2 + rtol 1e-2 in bfloat16 (one or two bf16 roundings of the
output at any magnitude; the bf16 prefill kernel also rounds the
probabilities to bf16 before P V)."""

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.ops.paged_attention import (
    paged_attention_decode_layered, paged_attention_prefill)


def _np(x):
    return x.float().cpu().numpy()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,rtol", [(torch.float32, 1e-5, 0.0),
                                            (torch.bfloat16, 2e-2, 1e-2)])
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
@pytest.mark.parametrize("dtype,tol,rtol", [(torch.float32, 1e-5, 0.0),
                                            (torch.bfloat16, 2e-2, 1e-2)])
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
@pytest.mark.parametrize("dtype,tol,rtol", [(torch.float32, 1e-5, 0.0),
                                            (torch.bfloat16, 2e-2, 1e-2)])
@pytest.mark.parametrize("window", [None, 50])
def test_cuda_decode_window_matches_plain(cuda_device, dtype, tol, rtol,
                                          window):
    """The fused-window form: pool pages + the in-flight buffer, folded by
    the decode kernel's combine step."""
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
                  seed=3):
    """The bf16 prefill kernel and its plain version on one input: q and
    the pool from a seed, each row's pages distinct and shuffled."""
    g = torch.Generator().manual_seed(seed)
    B, T = pos.shape
    used = -(-(int(pos.max()) + 1) // ps)
    N, P = 2 * used + 4, used + 2  # trailing table entries stay 0
    kp = torch.randn(N, KV, ps, hd, generator=g).to(torch.bfloat16)
    vp = torch.randn(N, KV, ps, hd, generator=g).to(torch.bfloat16)
    q = torch.randn(B, T, KV * G, hd, generator=g).to(torch.bfloat16)
    table = torch.zeros((B, P), dtype=torch.int32)
    for b in range(B):
        table[b, :used] = torch.randperm(N - 1, generator=g)[:used] + 1
    want = paged_attention_prefill(q, kp, vp, table, pos, softcap=softcap,
                                   eff_win=win)
    got = paged_attention_prefill(
        *(t.to(dev) for t in (q, kp, vp, table, pos)), softcap=softcap,
        eff_win=None if win is None else win.to(dev))
    torch.cuda.synchronize()
    return got.cpu(), want


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 7, 8])
def test_cuda_bf16_prefill_kernel_matches_plain(cuda_device, G, hd, ps):
    """Groups that do and do not divide the 64 rows of a block (G = 7:
    9 queries, one padding row): a chunk continuing at position 40, a
    row with padding queries at its end, and a row of padding only."""
    T = 80
    pos = torch.full((3, T), -1, dtype=torch.int32)
    pos[0] = torch.arange(40, 40 + T)
    pos[1, :33] = torch.arange(33)
    got, want = _prefill_case(cuda_device, G, hd, ps, pos)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=2e-2)
    assert (got[1, 33:] == 0).all() and (got[2] == 0).all()


@pytest.mark.cuda
def test_cuda_bf16_prefill_deep_chunk(cuda_device):
    """The fourth 512-token chunk of a 2048-token prompt at the 8B widths:
    every block walks 25 to 32 pages."""
    pos = torch.arange(1536, 2048, dtype=torch.int32)[None]
    got, want = _prefill_case(cuda_device, 4, 128, 64, pos, KV=8)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [16, 128])
def test_cuda_bf16_prefill_window_and_softcap(cuda_device, ps):
    """Sliding windows of 100 and 7 keys with the Gemma-2 softcap: key
    blocks wholly below a block's window are skipped."""
    T = 96
    pos = torch.stack([torch.arange(200, 200 + T),
                       torch.arange(300, 300 + T)]).to(torch.int32)
    pos[1, 70:] = -1
    win = torch.tensor([100, 7], dtype=torch.int32)
    got, want = _prefill_case(cuda_device, 4, 128, ps, pos, win=win,
                              softcap=30.0)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=2e-2)
    assert (got[1, 70:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("hd,ps,G", [(32, 64, 4), (96, 64, 4), (128, 8, 4),
                                     (128, 48, 4), (128, 64, 16)])
def test_cuda_bf16_prefill_refuses_shapes_it_is_not_built_for(
        cuda_device, hd, ps, G):
    """The bf16 prefill kernel is built for head_dim 64/128/256, pages of
    16/32/64/128 and groups up to 8; anything else raises, naming the
    shape (there is no second bf16 path to fall back on)."""
    d, bf = cuda_device, torch.bfloat16
    pool = torch.zeros(4, 1, ps, hd, dtype=bf, device=d)
    with pytest.raises(ValueError, match="bfloat16 prefill kernel takes"):
        paged_attention_prefill(
            torch.zeros(1, 4, G, hd, dtype=bf, device=d), pool, pool,
            torch.ones(1, 2, dtype=torch.int32, device=d),
            torch.arange(4, dtype=torch.int32, device=d)[None])
