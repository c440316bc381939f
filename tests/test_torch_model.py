"""The port's dense Llama (models/llama.py) against the JAX package's, on
the CPU at ModelConfig.tiny() in float32: the same params (JAX init,
bridged through numpy) and the same inputs go through both sides.
Tolerance atol 1e-4 on logits (float32 end to end; the two frameworks
sum in different orders); decode-window tokens must be identical. The
page scatters and the fused decode window read no tensor value on the
host (no sync, so the window can be captured in a CUDA graph)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from torch_sync_guard import NoHostReads

PAGE = 8
ATOL = 1e-4


def _cfgs(**kw):
    return JaxModelConfig.tiny(**kw), ModelConfig.tiny(**kw)


def _setup(num_pages=32, seed=0, **kw):
    jcfg, tcfg = _cfgs(**kw)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 jparams.items()}, tcfg, device="cpu")
    spec_j = jl.KVCacheSpec(num_pages, PAGE)
    spec_t = tl.KVCacheSpec(num_pages, PAGE)
    jk, jv = jl.init_kv_cache(jcfg, spec_j)
    tk, tv = tl.init_kv_cache(tcfg, spec_t, device="cpu")
    return jcfg, tcfg, jparams, tparams, (jk, jv), (tk, tv)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _prefill_inputs(B, T, P, starts, lens, pages):
    tokens = np.zeros((B, T), np.int32)
    positions = np.full((B, T), -1, np.int32)
    slots = np.full((B, T), jl.DROP_SLOT, np.int32)
    table = np.zeros((B, P), np.int32)
    last = np.zeros(B, np.int32)
    rng = np.random.RandomState(5)
    for b, (s, n, pg) in enumerate(zip(starts, lens, pages)):
        tokens[b, :n] = rng.randint(1, 500, n)
        positions[b, :n] = np.arange(s, s + n)
        table[b, :len(pg)] = pg
        pos = np.arange(s, s + n)
        slots[b, :n] = np.asarray(pg)[pos // PAGE] * PAGE + pos % PAGE
        last[b] = n - 1
    return tokens, positions, table, slots, last


def test_primitives_match_jax():
    jcfg, tcfg = _cfgs(rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                     "original_max_position_embeddings": 64})
    np.testing.assert_allclose(tl.rope_freqs(tcfg).numpy(),
                               np.asarray(jl.rope_freqs(jcfg)), rtol=1e-6)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 16).astype(np.float32)
    w = rng.randn(16).astype(np.float32)
    for unit in (False, True):
        np.testing.assert_allclose(
            tl.rms_norm(_t(x), _t(w), 1e-5, unit).numpy(),
            np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5,
                                   unit)), rtol=1e-5, atol=1e-6)
    h = rng.randn(2, 5, 4, 16).astype(np.float32)
    pos = rng.randint(0, 50, (2, 5)).astype(np.int32)
    inv = jl.rope_freqs(jcfg)
    np.testing.assert_allclose(
        tl.apply_rope(_t(h), _t(pos), tl.rope_freqs(tcfg)).numpy(),
        np.asarray(jl.apply_rope(jnp.asarray(h), jnp.asarray(pos), inv)),
        rtol=1e-5, atol=1e-5)


def test_scatter_pages_match_jax_and_drop_padding():
    rng = np.random.RandomState(1)
    pool = rng.randn(6, 2, 4, 8).astype(np.float32)
    new = rng.randn(2, 4, 2, 8).astype(np.float32)
    flat = np.array([[5, 6, 7, jl.DROP_SLOT], [9, jl.DROP_SLOT, 0, 23]],
                    np.int32)
    want = jl._scatter_pages(jnp.asarray(pool), jnp.asarray(new),
                             jnp.asarray(flat))
    got = tl._scatter_pages(_t(pool.copy()), _t(new), _t(flat))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pslots = np.array([[3], [6]], np.int32)  # row 1: padding (>= N)
    want = jl._scatter_pages_paged(jnp.asarray(pool), jnp.asarray(new),
                                   jnp.asarray(pslots))
    got = tl._scatter_pages_paged(_t(pool.copy()), _t(new), _t(pslots))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("paged_commit", [False, True])
def test_prefill_then_decode_logits_match_jax(paged_commit):
    """Prefill (two rows, second chunk continuing a cached prefix, a
    padding row), then K=1 decode steps: logits and pools agree."""
    jcfg, tcfg, jp, tp, (jk, jv), (tk, tv) = _setup()
    j_pre, j_dec = jl.make_step_fns(jcfg)
    t_pre, t_dec = tl.make_step_fns(tcfg)
    B, T, P = 4, 16, 4
    pages = [[1, 2, 3], [4, 5], [6, 7, 8, 10], []]
    # chunk 1: rows 0,1 from position 0; row 2 from 0; row 3 padding
    tokens, positions, table, slots, last = _prefill_inputs(
        B, T, P, [0, 0, 0, 0], [16, 10, 16, 0], pages)
    pslots = np.full((B, T // PAGE), 32, np.int32)
    for b, pg in enumerate(pages[:3]):
        pslots[b, :len(pg[:2])] = pg[:2]
    args = [tokens, positions]
    jl_out, jk, jv = j_pre(jp, *map(jnp.asarray, args), jk, jv,
                           jnp.asarray(table), jnp.asarray(slots),
                           jnp.asarray(last),
                           jnp.asarray(pslots) if paged_commit else None)
    tl_out, tk, tv = t_pre(tp, *map(_t, args), tk, tv, _t(table), _t(slots),
                           _t(last), _t(pslots) if paged_commit else None)
    np.testing.assert_allclose(tl_out.numpy()[:3], np.asarray(jl_out)[:3],
                               atol=ATOL, rtol=0)
    # chunk 2 continues row 2 at position 16 (prefix in the pool)
    tokens2, positions2, table2, slots2, last2 = _prefill_inputs(
        1, 8, P, [16], [8], [pages[2]])
    jl2, jk, jv = j_pre(jp, jnp.asarray(tokens2), jnp.asarray(positions2),
                        jk, jv, jnp.asarray(table2), jnp.asarray(slots2),
                        jnp.asarray(last2))
    tl2, tk, tv = t_pre(tp, _t(tokens2), _t(positions2), tk, tv, _t(table2),
                        _t(slots2), _t(last2))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL,
                               rtol=0)
    # decode steps: rows at their next position, row 3 padding
    dpos = np.array([16, 10, 24, -1], np.int32)
    dtok = np.array([7, 8, 9, 0], np.int32)
    written = [s for s in np.concatenate([slots.ravel(), slots2.ravel()])
               if s != jl.DROP_SLOT]
    for step in range(3):
        dslots = np.array([
            (np.asarray(pg)[p // PAGE] * PAGE + p % PAGE) if p >= 0
            else jl.DROP_SLOT for pg, p in zip(pages, dpos)], np.int32)
        jd, jk, jv = j_dec(jp, jnp.asarray(dtok), jnp.asarray(dpos), jk, jv,
                           jnp.asarray(table), jnp.asarray(dslots))
        td, tk, tv = t_dec(tp, _t(dtok), _t(dpos), tk, tv, _t(table),
                           _t(dslots))
        np.testing.assert_allclose(td.numpy()[:3], np.asarray(jd)[:3],
                                   atol=ATOL, rtol=0)
        written += [s for s in dslots if s != jl.DROP_SLOT]
        dtok = np.asarray(jnp.argmax(jd, -1)).astype(np.int32)
        dpos = np.where(dpos >= 0, dpos + 1, -1).astype(np.int32)
    # pool slots that hold real positions (the page-granular commit also
    # writes padding positions' junk K/V, which no query ever reads and
    # which the two sides compute differently)
    written = np.asarray(written)
    for t_pool, j_pool in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(
            t_pool.numpy()[:, written // PAGE, :, written % PAGE],
            np.asarray(j_pool)[:, written // PAGE, :, written % PAGE],
            atol=1e-5)


def test_kernel_path_matches_plain_path_on_cpu():
    """use_kernels=False (gather paths) gives the same logits as the
    kernel wrappers' plain versions."""
    _, tcfg, _, tp, _, (tk, tv) = _setup()
    tk2, tv2 = tk.clone(), tv.clone()
    pre_k, dec_k = tl.make_step_fns(tcfg, use_kernels=True)
    pre_p, dec_p = tl.make_step_fns(tcfg, use_kernels=False)
    tokens, positions, table, slots, last = _prefill_inputs(
        2, 16, 4, [0, 0], [16, 9], [[1, 2, 3], [4, 5]])
    a = pre_k(tp, _t(tokens), _t(positions), tk, tv, _t(table), _t(slots),
              _t(last))[0]
    b = pre_p(tp, _t(tokens), _t(positions), tk2, tv2, _t(table), _t(slots),
              _t(last))[0]
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


def _window_run(mod, cfg, params, kv, table, tok, pos, rem, eos, K,
                backend):
    B = len(tok)
    arr = jnp.asarray if backend == "jax" else _t
    done = jnp.zeros(B, bool) if backend == "jax" else torch.zeros(
        B, dtype=torch.bool)
    steps = np.zeros(B, np.int32)
    temp = np.zeros(B, np.float32)
    topk = np.zeros(B, np.int32)
    topp = np.ones(B, np.float32)
    seeds = np.zeros(B, np.uint32)
    fn = mod.make_decode_window_fn(cfg, True, 64)
    if backend == "jax":
        # the window donates the pools: hand it copies
        out = fn(params, arr(tok), arr(pos), done, arr(steps), arr(rem),
                 jnp.array(kv[0]), jnp.array(kv[1]), arr(table), arr(temp),
                 arr(topk), arr(topp), arr(seeds), arr(eos), k_steps=K)
    else:
        # the window writes the pools in place: hand it copies
        out = fn(params, arr(tok), arr(pos), done, arr(steps), arr(rem),
                 kv[0].clone(), kv[1].clone(), arr(table), temp, topk, topp,
                 seeds, arr(eos), k_steps=K)
    toks, emitted, carry, k, v = out
    return (np.asarray(toks), np.asarray(emitted),
            [np.asarray(c) for c in carry], np.asarray(k), np.asarray(v))


def test_decode_window_tokens_match_jax_with_mid_window_eos():
    """Greedy fused window: identical tokens, emitted counts, carries and
    committed pools; one row's EOS is a token it samples mid-window (the
    row freezes on device), one row exhausts its budget, one is
    padding."""
    jcfg, tcfg, jp, tp, (jk, jv), (tk, tv) = _setup()
    j_pre, _ = jl.make_step_fns(jcfg)
    t_pre, _ = tl.make_step_fns(tcfg)
    B, T, P, K = 4, 16, 4, 6
    pages = [[1, 2, 3], [4, 5, 6], [7, 8, 9], []]
    tokens, positions, table, slots, last = _prefill_inputs(
        B, T, P, [0, 0, 0, 0], [12, 16, 7, 0], pages)
    jl_out, jk, jv = j_pre(jp, jnp.asarray(tokens), jnp.asarray(positions),
                           jk, jv, jnp.asarray(table), jnp.asarray(slots),
                           jnp.asarray(last))
    _, tk, tv = t_pre(tp, _t(tokens), _t(positions), tk, tv, _t(table),
                      _t(slots), _t(last))
    tok = np.asarray(jnp.argmax(jl_out, -1)).astype(np.int32)
    tok[3] = 0
    pos = np.array([12, 16, 7, -1], np.int32)
    rem = np.array([50, 3, 50, 1], np.int32)
    eos = np.full((B, 2), -1, np.int32)
    # make row 0's first new greedy token after step 0 its EOS
    probe = _window_run(jl, jcfg, jp, (jk, jv), table, tok, pos, rem, eos,
                        K, "jax")[0][0]
    stop_at = next(j for j in range(1, K) if probe[j] not in probe[:j])
    eos[0, 0] = probe[stop_at]
    want = _window_run(jl, jcfg, jp, (jk, jv), table, tok, pos, rem, eos, K,
                       "jax")
    got = _window_run(tl, tcfg, tp, (tk, tv), table, tok, pos, rem, eos, K,
                      "torch")
    np.testing.assert_array_equal(got[0][:3], want[0][:3])
    np.testing.assert_array_equal(got[1], want[1])
    assert want[1][0] == stop_at + 1 and want[1][1] == 3 and want[1][3] == 0
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g[:3], w[:3])
    np.testing.assert_allclose(got[3], want[3], atol=1e-5)
    np.testing.assert_allclose(got[4], want[4], atol=1e-5)


def _kept_scatter(pool, new, idx, paged):
    """The scatters as they were before the fixed-shape form: select the
    kept entries (a data-dependent shape), write only those."""
    pool = pool.clone()
    N, KV, ps, hd = pool.shape
    flat = idx.reshape(-1).long()
    if paged:
        B, T = new.shape[:2]
        rows = new.reshape(B, T // ps, ps, KV, hd).permute(
            0, 1, 3, 2, 4).reshape(-1, KV, ps, hd)
        keep = torch.nonzero((flat >= 0) & (flat < N)).flatten()
        pool[flat[keep]] = rows[keep].to(pool.dtype)
    else:
        rows = new.reshape(-1, KV, hd)
        keep = torch.nonzero((flat >= 0) & (flat < N * ps)).flatten()
        k = flat[keep]
        pool[k // ps, :, k % ps] = rows[keep].to(pool.dtype)
    return pool


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["mixed", "all_dropped", "one_kept"])
def test_fixed_shape_scatters_equal_kept_scatters(case, dtype):
    """The fixed-shape scatters (_drop_plan) write exactly what the old
    kept-index scatters wrote, bit for bit, on pools with DROP_SLOT rows,
    negative slots and page ids past the pool; page 0 (never handed out
    by the engine) keeps every byte, also when nothing is kept."""
    rng = np.random.RandomState(6)
    N, KV, ps, hd, B, T = 7, 2, 4, 8, 3, 8
    pool = torch.from_numpy(rng.randn(N, KV, ps, hd).astype(np.float32)).to(
        dtype)
    new = torch.from_numpy(rng.randn(B, T, KV, hd).astype(np.float32))
    flat = torch.from_numpy(rng.randint(ps, N * ps, (B, T)).astype(np.int32))
    flat = torch.where(torch.from_numpy(rng.rand(B, T) < 0.4),
                       tl.DROP_SLOT, flat)
    flat[0, 1] = -3
    pslots = torch.tensor([[2, N], [N + 5, 4], [-1, 6]], dtype=torch.int32)
    if case == "all_dropped":
        flat = torch.full_like(flat, tl.DROP_SLOT)
        pslots = torch.full_like(pslots, N)
    elif case == "one_kept":
        keep = flat[1, 3]
        flat = torch.full_like(flat, tl.DROP_SLOT)
        flat[1, 3] = keep if keep < N * ps else ps
        pslots = torch.full_like(pslots, N)
        pslots[2, 1] = 3
    # flat slots are unique (a real commit never writes a slot twice)
    seen = set()
    for b in range(B):
        for t in range(T):
            v = int(flat[b, t])
            if 0 <= v < N * ps:
                while v in seen:
                    v = ps + (v + 1) % (N * ps - ps)
                seen.add(v)
                flat[b, t] = v
    for paged, idx in ((False, flat), (True, pslots)):
        want = _kept_scatter(pool, new, idx, paged)
        fn = tl._scatter_pages_paged if paged else tl._scatter_pages
        with NoHostReads():
            got = fn(pool.clone(), new, idx)
        assert torch.equal(got, want), (case, paged)
        assert torch.equal(got[0], pool[0])
        if case == "all_dropped":
            assert torch.equal(got, pool)


def test_decode_window_reads_no_host_value():
    """The fused window, sampled rows included, runs under a mode that
    fails any host read of a tensor value, and gives the same tokens,
    carry and pools as without it."""
    _, tcfg, _, tp, _, (tk, tv) = _setup()
    t_pre, _ = tl.make_step_fns(tcfg)
    B, T, P, K = 3, 16, 4, 4
    pages = [[1, 2, 3], [4, 5, 6], []]
    tokens, positions, table, slots, last = _prefill_inputs(
        B, T, P, [0, 0, 0], [12, 16, 0], pages)
    _, tk, tv = t_pre(tp, _t(tokens), _t(positions), tk, tv, _t(table),
                      _t(slots), _t(last))
    fn = tl.make_decode_window_fn(tcfg, True, 64)
    args = dict(
        tokens=_t(np.array([3, 4, 0], np.int32)),
        positions=_t(np.array([12, 16, -1], np.int32)),
        done=torch.zeros(B, dtype=torch.bool),
        steps=_t(np.array([1, 1, 0], np.int32)),
        remaining=_t(np.array([9, 2, 1], np.int32)), page_table=_t(table),
        temperature=_t(np.array([0.0, 0.8, 0.0], np.float32)),
        top_k=_t(np.array([0, 10, 0], np.int32)),
        top_p=_t(np.array([1.0, 0.9, 1.0], np.float32)),
        seeds=_t(np.array([0, 77, 0], np.int64)),
        eos_table=_t(np.full((B, 2), -1, np.int32)))
    outs = []
    for guard in (False, True):
        k, v = tk.clone(), tv.clone()
        if guard:
            with NoHostReads():
                out = fn(tp, kv_k=k, kv_v=v, k_steps=K, **args)
        else:
            out = fn(tp, kv_k=k, kv_v=v, k_steps=K, **args)
        outs.append(out)
    (ta, ea, ca, ka, va), (tb, eb, cb, kb, vb) = outs
    assert torch.equal(ta, tb) and torch.equal(ea, eb)
    assert all(torch.equal(x, y) for x, y in zip(ca, cb))
    assert torch.equal(ka, kb) and torch.equal(va, vb)
    assert ea.tolist() == [4, 2, 0]


def test_moe_and_mla_families_draw_and_run():
    """MoE passes the check and draws its params: the router and the
    expert stacks. MLA (ported since) is models/mla.py's, which the
    registry gives for it: it draws its params and runs a prefill step to
    finite logits, while models/llama.py's entry points keep refusing
    it."""
    from dynamo_tpu_torch.models import mla as tm
    from dynamo_tpu_torch.models.registry import get_model_module

    _, tcfg = _cfgs(num_experts=4)
    tl.check_supported(tcfg)
    p = tl.init_params(tcfg, torch.Generator().manual_seed(0))
    assert tuple(p["w_gate"].shape) == (2, 4, 64, 128)
    assert tuple(p["w_router"].shape) == (2, 64, 4)
    _, tcfg = _cfgs(kv_lora_rank=16, num_kv_heads=4)
    with pytest.raises(NotImplementedError):
        tl.make_step_fns(tcfg)[0](None, torch.zeros(1, 1, dtype=torch.int32),
                                  None, None, None, None, None, None)
    mod = get_model_module(tcfg)
    assert mod is tm
    p = mod.init_params(tcfg, torch.Generator().manual_seed(0))
    assert tuple(p["w_dkv"].shape) == (2, 64, 16 + 64)
    kc, kr = mod.init_kv_cache(tcfg, tl.KVCacheSpec(4, 8), device="cpu")
    i32 = dict(dtype=torch.int32)
    logits, kc, kr = mod.make_step_fns(tcfg)[0](
        p, torch.tensor([[5, 6, 7]], **i32), torch.arange(3, **i32)[None],
        kc, kr, torch.tensor([[1]], **i32), torch.tensor([[8, 9, 10]], **i32),
        torch.tensor([2], **i32))
    assert logits.shape == (1, tcfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and kc[:, 1, 0, :3].any()
