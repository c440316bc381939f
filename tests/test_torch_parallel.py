"""Tensor-parallel serving in the port (``dynamo_tpu_torch/parallel/``,
the sharded attention wrappers, the model's collectives, the engine's
followers and the launcher's rank flags) against the JAX package, on the
CPU: Megatron shards equal the JAX ``NamedSharding`` shards exactly; the
sharded wrappers, run rank by rank over a (data=2, model=2) split and
joined, equal the JAX ``shard_map`` wrappers on a 2x2 mesh in interpret
mode (atol 1e-5, float32); two gloo processes at model=2 give the JAX
model's logits and the port's tp=1 logits (atol 1e-5) and greedy tokens
identical to ``JaxEngine``'s. Uneven splits raise.

Spawned ranks import no JAX, meet through a FileStore under the test's
tmp_path (the launcher test: a TCP port on 127.0.0.1), have a hard
timeout and are killed at the end whatever happens."""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time
import urllib.request

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
from dynamo_tpu.ops import paged_attention as jops
from dynamo_tpu.parallel import mesh as jmesh
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.bridge import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops import paged_attention as tops
from dynamo_tpu_torch.parallel.mesh import (MeshSpec, kv_cache_pspec,
                                            local_heads, shard,
                                            shard_kv_cache, shard_params)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
PAGE = 8
# the engine's bucket grid (tests/test_torch_engine.py's)
ECFG = dict(page_size=8, num_pages=64, max_batch=4, prefill_chunk=16,
            prefill_buckets=(16,), batch_buckets=(1, 2, 4), page_buckets=(8,),
            decode_steps=4)
PROMPTS = [list(range(1, 6)), list(range(30, 70)), list(range(100, 117)),
           [7, 7, 7]]
MAX_TOKENS = [9, 12, 10, 5]


def _jax_params(seed=0, **kw):
    jcfg, tcfg = JaxModelConfig.tiny(**kw), ModelConfig.tiny(**kw)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


def _jax_mesh(data, model):
    return jmesh.MeshSpec(data=data, model=model).build()


def _device_shard(arr, device):
    (s,) = [s for s in arr.addressable_shards if s.device == device]
    return np.asarray(s.data)


# ------------------------------------------------------------ (a) shards


@pytest.mark.parametrize("kw", [{}, {"attn_bias": True,
                                     "tie_word_embeddings": True},
                                {"model_type": "mixtral", "num_experts": 4}])
def test_shards_equal_jax_named_shardings(kw):
    """Every param's shard, the bridge's per-rank upload and the pool's
    shard equal the JAX shard on the same device of a model=2 mesh,
    exactly."""
    jcfg, tcfg, jp, np_params = _jax_params(**kw)
    mesh = _jax_mesh(1, 2)
    sharded = jmesh.shard_params(jp, jcfg, mesh)
    rng = np.random.RandomState(0)
    spec = jl.KVCacheSpec(16, PAGE)
    pools = [rng.randn(*spec.shape(jcfg)).astype(np.float32)
             for _ in range(2)]
    jk, jv = jmesh.shard_kv_cache(jnp.asarray(pools[0]),
                                  jnp.asarray(pools[1]), jcfg, mesh)
    devices = mesh.devices.reshape(-1)
    assert set(np_params) == set(sharded)
    for m in range(2):
        view = MeshSpec(model=2).view(m)
        mine = shard_params(np_params, tcfg, view)
        bridged = params_from_numpy(np_params, tcfg, device="cpu", rank=m,
                                    size=2)
        for k in np_params:
            want = _device_shard(sharded[k], devices[m])
            np.testing.assert_array_equal(mine[k], want, err_msg=k)
            np.testing.assert_array_equal(bridged[k].numpy(), want,
                                          err_msg=k)
        tk, tv = shard_kv_cache(torch.from_numpy(pools[0]),
                                torch.from_numpy(pools[1]), tcfg, view)
        assert tk.is_contiguous()
        np.testing.assert_array_equal(tk.numpy(),
                                      _device_shard(jk, devices[m]))
        np.testing.assert_array_equal(tv.numpy(),
                                      _device_shard(jv, devices[m]))


# -------------------------------------------------- (b) sharded wrappers


def _blocks(mesh_spec, B, H, fn):
    """Run ``fn(view, heads)`` for every rank and join the blocks: rows
    over data, heads (axis 1 of the result) over model."""
    rows = []
    for d in range(mesh_spec.data):
        cols = []
        for m in range(mesh_spec.model):
            view = mesh_spec.view(d * mesh_spec.model + m)
            hl = H // mesh_spec.model
            cols.append(fn(view, slice(m * hl, (m + 1) * hl)))
        rows.append(torch.cat(cols, dim=1))
    return torch.cat(rows, dim=0)


def _decode_operands(B=4, H=4, KV=2, hd=64, L=2, N=32, P=4, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, hd).astype(np.float32)
    kp = rng.randn(L, N, KV, PAGE, hd).astype(np.float32)
    vp = rng.randn(L, N, KV, PAGE, hd).astype(np.float32)
    table = np.stack([rng.permutation(np.arange(1, N))[:P]
                      for _ in range(B)]).astype(np.int32)
    return q, kp, vp, table


def test_sharded_decode_wrapper_matches_jax_on_2x2():
    """The layered form with stats (and without): ranks' blocks joined
    equal JAX's paged_attention_decode_sharded on a data=2 x model=2
    mesh (interpret mode), with softcap and a lower bound."""
    q, kp, vp, table = _decode_operands()
    B, H = q.shape[:2]
    lengths = np.array([0, 5, 19, 32], np.int32)
    lower = np.array([0, 2, 9, 0], np.int32)
    mesh = _jax_mesh(2, 2)
    spec = MeshSpec(data=2, model=2)
    for stats in (True, False):
        want = jops.paged_attention_decode_sharded(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), 1,
            jnp.asarray(table), jnp.asarray(lengths), mesh=mesh,
            interpret=True, return_stats=stats, softcap=20.0,
            lower=jnp.asarray(lower))
        want = want if stats else (want,)
        for i in range(len(want)):
            def rank(view, heads, i=i):
                kk, vv = shard_kv_cache(torch.from_numpy(kp),
                                        torch.from_numpy(vp),
                                        ModelConfig.tiny(), view)
                res = tops.paged_attention_decode_sharded(
                    torch.from_numpy(q[:, heads]).contiguous(), kk, vv, 1,
                    torch.from_numpy(table), torch.from_numpy(lengths),
                    mesh=view, kv_heads=2, return_stats=stats, softcap=20.0,
                    lower=torch.from_numpy(lower))
                return res[i] if stats else res
            got = _blocks(spec, B, H, rank)
            np.testing.assert_allclose(got.numpy(), np.asarray(want[i]),
                                       atol=ATOL, rtol=0)


@pytest.mark.parametrize("window", [None, 5])
def test_sharded_window_wrapper_matches_jax_pool_window_on_2x2(window):
    """The window form (the fused decode window's): ranks' blocks joined
    equal JAX's _pool_window_attention_pallas under a 2x2 mesh, which
    reaches paged_attention_decode_sharded and merges the in-flight
    buffer, at every step of a 3-step window. The padding row (start -1)
    is zeros on the port's side and discarded by the window on both, so
    it is not compared."""
    q, kp, vp, table = _decode_operands(seed=1)
    B, H, hd = q.shape
    K = 3
    rng = np.random.RandomState(2)
    wk = rng.randn(B, K, 2, hd).astype(np.float32)
    wv = rng.randn(B, K, 2, hd).astype(np.float32)
    start = np.array([3, -1, 17, 0], np.int32)
    live = start >= 0
    mesh = _jax_mesh(2, 2)
    spec = MeshSpec(data=2, model=2)
    scale = hd ** -0.5
    for i in range(K):
        q_pos = np.maximum(start, 0) + i
        want = jl._pool_window_attention_pallas(
            jnp.asarray(q[:, None]), jnp.asarray(kp), jnp.asarray(vp), 0,
            jnp.asarray(table), jnp.asarray(start), jnp.asarray(wk),
            jnp.asarray(wv), i, scale, interpret=True, mesh=mesh,
            softcap=30.0, window=window, is_sliding=window is not None,
            q_pos=jnp.asarray(q_pos))[:, 0]

        def rank(view, heads):
            m = view.model_rank
            kk, vv = shard_kv_cache(torch.from_numpy(kp),
                                    torch.from_numpy(vp), ModelConfig.tiny(),
                                    view)
            eff = (None if window is None else
                   torch.full((B,), window, dtype=torch.int32))
            return tops.paged_attention_decode_window_sharded(
                torch.from_numpy(q[:, heads]).contiguous(), kk, vv, 0,
                torch.from_numpy(table), torch.from_numpy(start),
                torch.from_numpy(q_pos.astype(np.int32)),
                torch.from_numpy(wk[:, :, m:m + 1]).contiguous(),
                torch.from_numpy(wv[:, :, m:m + 1]).contiguous(), i + 1,
                mesh=view, kv_heads=2, scale=scale, softcap=30.0,
                eff_win=eff)
        got = _blocks(spec, B, H, rank)
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(want)[live], atol=ATOL, rtol=0)
        assert not got[~torch.from_numpy(live)].any()


def test_sharded_prefill_wrapper_matches_jax_on_2x2():
    """Ranks' blocks of paged_attention_prefill_sharded joined equal
    JAX's on a 2x2 mesh: padding queries, a second chunk, a sliding
    window on one row, softcap."""
    rng = np.random.RandomState(3)
    B, T, H, KV, hd, N, P = 4, 8, 4, 2, 64, 32, 4
    q = rng.randn(B, T, H, hd).astype(np.float32)
    kp = rng.randn(N, KV, PAGE, hd).astype(np.float32)
    vp = rng.randn(N, KV, PAGE, hd).astype(np.float32)
    table = np.stack([rng.permutation(np.arange(1, N))[:P]
                      for _ in range(B)]).astype(np.int32)
    qpos = np.full((B, T), -1, np.int32)
    qpos[0] = np.arange(T)
    qpos[1, :5] = np.arange(5)
    qpos[2] = np.arange(16, 16 + T)
    qpos[3] = np.arange(8, 8 + T)
    eff = np.array([tops.NO_WINDOW, tops.NO_WINDOW, 6, tops.NO_WINDOW],
                   np.int32)
    want = jops.paged_attention_prefill_sharded(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(qpos), mesh=_jax_mesh(2, 2), interpret=True,
        softcap=25.0, eff_win=jnp.asarray(eff))

    def rank(view, heads):
        kk, vv = shard(torch.from_numpy(kp), (None, "model", None, None),
                       view), shard(torch.from_numpy(vp),
                                    (None, "model", None, None), view)
        out = tops.paged_attention_prefill_sharded(
            torch.from_numpy(q[:, :, heads]).contiguous(), kk, vv,
            torch.from_numpy(table), torch.from_numpy(qpos), mesh=view,
            kv_heads=KV, softcap=25.0, eff_win=torch.from_numpy(eff))
        return out.transpose(1, 2)   # heads on axis 1 for the join

    got = _blocks(MeshSpec(data=2, model=2), B, H, rank).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


# --------------------------------------------------- (f) uneven splits


def test_uneven_splits_raise():
    """KV % model != 0 and B % data != 0 raise in the wrappers (the JAX
    model would take XLA's gather there; the port never falls back), and
    in the sharding of the heads, the params and the pool."""
    q, kp, vp, table = _decode_operands(KV=2)
    lengths = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    two = MeshSpec(model=2).view(0)
    with pytest.raises(ValueError, match="kv heads do not split"):
        tops.paged_attention_decode_sharded(
            torch.from_numpy(q[:, :2]), torch.from_numpy(kp[:, :, :1]),
            torch.from_numpy(vp[:, :, :1]), 0, torch.from_numpy(table),
            lengths, mesh=two, kv_heads=3)
    with pytest.raises(ValueError, match="pool shard holds"):
        tops.paged_attention_decode_sharded(
            torch.from_numpy(q[:, :2]), torch.from_numpy(kp),
            torch.from_numpy(vp), 0, torch.from_numpy(table), lengths,
            mesh=two, kv_heads=2)
    rows = MeshSpec(data=2, model=1).view(1)
    with pytest.raises(ValueError, match="rows do not split"):
        tops.paged_attention_decode_sharded(
            torch.from_numpy(q[:3]), torch.from_numpy(kp),
            torch.from_numpy(vp), 0, torch.from_numpy(table[:3]),
            lengths[:3], mesh=rows, kv_heads=2)
    with pytest.raises(ValueError, match="rows do not split"):
        tops.paged_attention_prefill_sharded(
            torch.zeros(3, 2, 4, 64), torch.from_numpy(kp[0]),
            torch.from_numpy(vp[0]), torch.from_numpy(table[:3]),
            torch.zeros(3, 2, dtype=torch.int32), mesh=rows, kv_heads=2)
    with pytest.raises(ValueError, match="kv heads do not split"):
        tops.paged_attention_decode_window_sharded(
            torch.from_numpy(q[:, :2]), torch.from_numpy(kp),
            torch.from_numpy(vp), 0, torch.from_numpy(table),
            lengths, lengths, torch.zeros(4, 2, 2, 64),
            torch.zeros(4, 2, 2, 64), 1, mesh=MeshSpec(model=4).view(0),
            kv_heads=2)
    cfg = ModelConfig.tiny(num_heads=6, num_kv_heads=3)
    with pytest.raises(ValueError, match="do not split"):
        local_heads(cfg, two)
    with pytest.raises(ValueError, match="does not split"):
        shard(torch.zeros(2, 4, 3, 8, 16), kv_cache_pspec(cfg), two)
    with pytest.raises(NotImplementedError):
        MeshSpec(data=2, model=2).build("cpu")


# --------------------------------------------------- spawned gloo ranks


WORKER = textwrap.dedent('''
    import asyncio, json, os, sys
    import numpy as np
    import torch

    from dynamo_tpu_torch.parallel.mesh import (MeshSpec, initialize_multihost,
                                                leave_process_groups)

    mode, rank, size, store, data = sys.argv[1:6]
    rank, size = int(rank), int(size)
    initialize_multihost("file://" + store, size, rank)
    mesh = MeshSpec(model=size).build("cpu")
    out = {"rank": rank, "shape": mesh.shape, "device": str(mesh.device)}

    if mode == "init":
        x = torch.full((3,), float(rank + 1))
        mesh.all_reduce(x)
        out["sum"] = x.tolist()
        out["gathered"] = mesh.gather_last(
            torch.full((2, 1), float(rank))).tolist()

    elif mode in ("model", "engine"):
        from dynamo_tpu_torch.models import llama as tl
        from dynamo_tpu_torch.models.bridge import params_from_numpy
        from dynamo_tpu_torch.models.config import ModelConfig
        overrides = os.path.join(data, "cfg.json")
        cfg = ModelConfig.tiny(**(json.load(open(overrides))
                                  if os.path.exists(overrides) else {}))
        npz = np.load(os.path.join(data, "params.npz"))
        params = params_from_numpy({k: npz[k] for k in npz.files}, cfg,
                                   device="cpu", rank=rank, size=size)

    if mode == "model":
        from dynamo_tpu_torch.engine import sampling
        x = np.load(os.path.join(data, "inputs.npz"))
        t = {k: torch.from_numpy(x[k]) for k in x.files}
        kk, vv = tl.init_kv_cache(cfg, tl.KVCacheSpec(32, 8), device="cpu",
                                  mesh=mesh)
        pre, _ = tl.make_step_fns(cfg, mesh=mesh)
        logits, kk, vv = pre(params, t["tokens"], t["positions"], kk, vv,
                             t["table"], t["slots"], t["last"])
        steps = []
        real = sampling.sample_tokens
        def record(lg, *a, **kw):
            steps.append(lg.clone())
            return real(lg, *a, **kw)
        sampling.sample_tokens = record
        win = tl.make_decode_window_fn(cfg, mesh=mesh)
        sampling.sample_tokens = real
        B = t["tok"].shape[0]
        toks, emitted, carry, kk, vv = win(
            params, t["tok"], t["pos"], torch.zeros(B, dtype=torch.bool),
            torch.zeros(B, dtype=torch.int32), t["rem"], kk, vv, t["table"],
            np.zeros(B, np.float32), np.zeros(B, np.int32),
            np.ones(B, np.float32), np.zeros(B, np.uint32), t["eos"],
            k_steps=int(x["K"]))
        np.savez(os.path.join(data, f"out{rank}.npz"),
                 prefill=logits.numpy(), steps=torch.stack(steps).numpy(),
                 toks=toks.numpy(), emitted=emitted.numpy(),
                 kk=kk.numpy(), vv=vv.numpy(),
                 **{f"carry{i}": c.numpy() for i, c in enumerate(carry)})

    if mode == "engine":
        from dynamo_tpu_torch.engine.torch_engine import (EngineConfig,
                                                          TorchEngine)
        from dynamo_tpu_torch.llm.protocols.common import (
            PreprocessedRequest, StopConditions)
        from dynamo_tpu_torch.runtime.engine import Context
        spec = json.load(open(os.path.join(data, "engine.json")))
        engine = TorchEngine(cfg, EngineConfig(**spec["ecfg"]),
                             params=params, mesh=mesh)
        engine.warmup()
        # two buckets missing after warmup on every rank: serving must
        # capture them on every rank, in step
        engine.graphs.buckets.pop((4, 8))
        engine.prefill_graphs.buckets.pop((1, 16, 8, True))

        async def run():
            async def one(p, n, delay):
                await asyncio.sleep(delay)
                req = PreprocessedRequest(token_ids=list(p),
                                          stop=StopConditions(max_tokens=n))
                toks = []
                async for o in engine.generate(req, Context()):
                    toks += o.token_ids
                return toks
            try:
                return await asyncio.gather(*[
                    one(p, n, 0.01 * i) for i, (p, n) in
                    enumerate(zip(spec["prompts"], spec["max_tokens"]))])
            finally:
                await engine.stop()

        if rank == 0:
            out["tokens"] = asyncio.run(run())
        else:
            engine.follow()
        out["compiles"] = engine.fence.post_warmup_compiles
        out["dispatches"] = engine.batch_dispatches_total
        out["stats"] = {k: engine.stats()[k]
                        for k in ("mesh_shape", "mesh_devices")}
        np.savez(os.path.join(data, f"carry{rank}.npz"), **{
            f"{B}x{P}_{i}": c.numpy()
            for (B, P), bk in engine.graphs.buckets.items()
            for i, c in enumerate(bk.carry)})

    leave_process_groups(mesh)
    out["left"] = not torch.distributed.is_initialized()
    print("RESULT " + json.dumps(out), flush=True)
''')


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return env


def _spawn(tmp_path, mode, size=2, timeout=240):
    """Run ``size`` ranks of WORKER in ``mode``; their RESULT dicts."""
    script = tmp_path / "rank_worker.py"
    script.write_text(WORKER)
    store = tmp_path / f"store-{mode}"
    logs = [tmp_path / f"{mode}-rank{r}.log" for r in range(size)]
    procs = []
    try:
        for r in range(size):
            procs.append(subprocess.Popen(
                [sys.executable, str(script), mode, str(r), str(size),
                 str(store), str(tmp_path)], env=_env(), cwd=REPO,
                stdout=open(logs[r], "w"), stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    results = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        text = log.read_text()
        assert p.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
        line = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        results.append(json.loads(line[-1][7:]))
    return results


def test_initialize_multihost_two_processes(tmp_path):
    """Two processes join through initialize_multihost and build a
    model=2 mesh on the CPU: one rank each, gloo collectives over the
    model axis (the JAX multihost smoke, tests/test_tp_serving.py); then
    each leaves its groups (``leave_process_groups``: the device and
    control groups, then the default one) and exits 0 (``_spawn``
    asserts every rank's exit code)."""
    got = _spawn(tmp_path, "init")
    assert len(got) == 2
    for r, res in enumerate(got):
        assert res["rank"] == r and res["shape"] == "model=2"
        assert res["device"] == "cpu"
        assert res["sum"] == [3.0, 3.0, 3.0]
        assert res["gathered"] == [[0.0, 1.0], [0.0, 1.0]]
        assert res["left"]


def _model_inputs():
    B, T, P, K = 4, 16, 4, 3
    pages = [[1, 2, 3], [4, 5, 6], [7, 8, 9], []]
    starts, lens = [0, 0, 0, 0], [12, 16, 7, 0]
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
        last[b] = max(n - 1, 0)
    return dict(tokens=tokens, positions=positions, table=table,
                slots=slots, last=last, K=np.int64(K),
                pos=np.array([12, 16, 7, -1], np.int32),
                rem=np.array([50, 2, 50, 1], np.int32),
                eos=np.full((B, 2), -1, np.int32))


def test_two_ranks_match_jax_model_and_tp1(tmp_path):
    """Two gloo ranks at model=2: prefill logits equal the JAX model's and
    the port's tp=1; a 3-step greedy window's tokens, emitted counts and
    carry equal the JAX window's and tp=1's, its step logits tp=1's, and
    the ranks' pool shards joined tp=1's pools. Every rank ends with the
    same carry (each samples the same tokens from the gathered logits)."""
    _two_ranks_match(tmp_path, seed=4)


def test_two_ranks_of_a_moe_model_match_jax_model_and_tp1(tmp_path):
    """The same two-rank run on a tiny Mixtral (4 experts, top 2): each
    rank holds its cut of every expert's inner width and the router
    whole, runs the dense sum over experts (the cost model never takes
    the blocked dispatch under a mesh) and all-reduces it; logits, window
    tokens, carries and pools as at tp=1 and as the JAX model's."""
    _two_ranks_match(tmp_path, seed=5, model_type="mixtral", num_experts=4)


def _two_ranks_match(tmp_path, seed: int, **cfg_kw):
    jcfg, tcfg, jp, np_params = _jax_params(seed=seed, **cfg_kw)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg_kw))
    x = _model_inputs()
    j_pre, _ = jl.make_step_fns(jcfg)
    jk, jv = jl.init_kv_cache(jcfg, jl.KVCacheSpec(32, PAGE))
    j_logits, jk, jv = j_pre(jp, *(jnp.asarray(x[k]) for k in (
        "tokens", "positions")), jk, jv, *(jnp.asarray(x[k]) for k in (
            "table", "slots", "last")))
    tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)
    tok[3] = 0
    x["tok"] = tok
    np.savez(tmp_path / "params.npz", **np_params)
    np.savez(tmp_path / "inputs.npz", **x)
    ranks = _spawn(tmp_path, "model")
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]

    # JAX window, greedy
    B, K = 4, int(x["K"])
    j_win = jl.make_decode_window_fn(jcfg, True, 64)
    j_toks, j_emit, j_carry, _, _ = j_win(
        jp, jnp.asarray(tok), jnp.asarray(x["pos"]), jnp.zeros(B, bool),
        jnp.zeros(B, jnp.int32), jnp.asarray(x["rem"]), jk, jv,
        jnp.asarray(x["table"]), jnp.zeros(B), jnp.zeros(B, jnp.int32),
        jnp.ones(B), jnp.zeros(B, jnp.uint32), jnp.asarray(x["eos"]),
        k_steps=K)
    # the port at tp=1, same weights and inputs
    from dynamo_tpu_torch.engine import sampling
    tp1 = params_from_numpy(np_params, tcfg, device="cpu")
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}
    kk, vv = tl.init_kv_cache(tcfg, tl.KVCacheSpec(32, PAGE), device="cpu")
    t_logits, kk, vv = tl.make_step_fns(tcfg)[0](
        tp1, t["tokens"], t["positions"], kk, vv, t["table"], t["slots"],
        t["last"])
    steps = []
    real = sampling.sample_tokens

    def record(lg, *a, **kw):
        steps.append(lg.clone())
        return real(lg, *a, **kw)

    sampling.sample_tokens = record
    try:
        t_win = tl.make_decode_window_fn(tcfg)
    finally:
        sampling.sample_tokens = real
    t_toks, t_emit, t_carry, kk, vv = t_win(
        tp1, t["tok"], t["pos"], torch.zeros(B, dtype=torch.bool),
        torch.zeros(B, dtype=torch.int32), t["rem"], kk, vv, t["table"],
        np.zeros(B, np.float32), np.zeros(B, np.int32),
        np.ones(B, np.float32), np.zeros(B, np.uint32), t["eos"], k_steps=K)

    assert [r["shape"] for r in ranks] == ["model=2", "model=2"]
    live = [0, 1, 2]
    for o in outs:
        np.testing.assert_allclose(o["prefill"][live],
                                   np.asarray(j_logits)[live], atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(o["prefill"], t_logits.numpy(),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(o["steps"], torch.stack(steps).numpy(),
                                   atol=ATOL, rtol=0)
        np.testing.assert_array_equal(o["toks"][live],
                                      np.asarray(j_toks)[live])
        np.testing.assert_array_equal(o["toks"], t_toks.numpy())
        np.testing.assert_array_equal(o["emitted"], np.asarray(j_emit))
        for i, c in enumerate(t_carry):
            np.testing.assert_array_equal(o[f"carry{i}"], c.numpy())
            np.testing.assert_array_equal(o[f"carry{i}"][live],
                                          np.asarray(j_carry[i])[live])
    for i in range(5):
        np.testing.assert_array_equal(outs[0][f"carry{i}"],
                                      outs[1][f"carry{i}"])
    for name, pool in (("kk", kk), ("vv", vv)):
        joined = np.concatenate([o[name] for o in outs], axis=2)
        np.testing.assert_allclose(joined, pool.numpy(), atol=ATOL, rtol=0)


async def _jax_generate(engine):
    async def one(p, n, delay):
        await asyncio.sleep(delay)
        req = JaxRequest(token_ids=list(p), stop=JaxStop(max_tokens=n))
        toks = []
        async for out in engine.generate(req, JaxContext()):
            toks += out.token_ids
        return toks

    try:
        return await asyncio.gather(*[
            one(p, n, 0.01 * i) for i, (p, n) in
            enumerate(zip(PROMPTS, MAX_TOKENS))])
    finally:
        await engine.stop()


def test_two_rank_engine_serves_jax_engine_tokens(tmp_path):
    """TorchEngine at model=2 over two gloo processes (rank 0 schedules,
    rank 1 follows) serves greedy tokens identical to JaxEngine on the
    same weights. Two buckets dropped after warmup are captured by both
    ranks when rank 0 announces them (the same post-warmup captures on
    every rank: the first request prefills alone, in the dropped 1-row
    bucket), both ranks made the same dispatches, and their decode
    buckets end with the same carries."""
    jcfg, tcfg, jp, np_params = _jax_params(seed=3)
    np.savez(tmp_path / "params.npz", **np_params)
    (tmp_path / "engine.json").write_text(json.dumps(
        {"ecfg": ECFG, "prompts": PROMPTS, "max_tokens": MAX_TOKENS}))
    ranks = _spawn(tmp_path, "engine")
    want = asyncio.run(_jax_generate(
        JaxEngine(jcfg, JaxEngineConfig(**ECFG), params=jp)))
    assert ranks[0]["tokens"] == want
    assert [len(t) for t in want] == MAX_TOKENS
    assert ranks[0]["compiles"] == ranks[1]["compiles"] >= 1
    assert ranks[0]["dispatches"] == ranks[1]["dispatches"] > 0
    assert all(r["stats"] == {"mesh_shape": "model=2", "mesh_devices": 2}
               for r in ranks)
    c0, c1 = (np.load(tmp_path / f"carry{r}.npz") for r in range(2))
    assert c0.files and sorted(c0.files) == sorted(c1.files)
    for k in c0.files:
        np.testing.assert_array_equal(c0[k], c1[k], err_msg=k)


# ----------------------------------------------------------- launcher


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _chat(port, timeout=60):
    body = json.dumps({"model": "tiny", "max_tokens": 8, "messages": [
        {"role": "user", "content": "hello there"}]}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_launcher_one_command_form_serves_tp1_text(tmp_path):
    """``--tensor-parallel-size 2`` without ``--coordinator`` starts rank 1
    itself; served over HTTP on the CPU, the tiny model's reply equals
    the tp=1 launcher's (same seed, so the same weights), and at SIGTERM
    both ranks print their serving summary and exit cleanly."""
    from dynamo_tpu_torch.run import build_engine, parse_args, serve_http

    port = _free_port()
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.run", "in=http",
           "out=torch", "--model", "tiny", "--device", "cpu",
           "--tensor-parallel-size", "2", "--http-host", "127.0.0.1",
           "--http-port", str(port)]
    log = tmp_path / "launcher.log"
    proc = subprocess.Popen(cmd, env=_env(), cwd=REPO, stdout=open(log, "w"),
                            stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        deadline = time.monotonic() + 180
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/health", timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            assert proc.poll() is None, log.read_text()[-4000:]
            assert time.monotonic() < deadline, log.read_text()[-4000:]
            time.sleep(0.5)
        got = _chat(port)
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    text = log.read_text()
    assert proc.returncode == 0, text[-4000:]
    summaries = sorted((json.loads(ln.split("serving summary ", 1)[1])
                        for ln in text.splitlines()
                        if "serving summary " in ln),
                       key=lambda s: s["rank"])
    assert [s["rank"] for s in summaries] == [0, 1], text[-4000:]
    assert all(s["mesh_shape"] == "model=2" for s in summaries)
    assert summaries[0]["batch_dispatches_total"] == \
        summaries[1]["batch_dispatches_total"] > 0
    assert [s["post_warmup_compiles_total"] for s in summaries] == [0, 0]

    async def tp1():
        engine, mdc, _ = build_engine(parse_args([
            "in=http", "out=torch", "--model", "tiny", "--device", "cpu"]))
        svc = await serve_http(engine, mdc, "127.0.0.1", 0)
        try:
            return await asyncio.to_thread(_chat, svc.port)
        finally:
            await svc.stop()
            await engine.stop()

    want = asyncio.run(tp1())
    assert got["choices"][0]["message"] == want["choices"][0]["message"]
    assert got["choices"][0]["message"]["content"]
    assert got["choices"][0]["finish_reason"] == \
        want["choices"][0]["finish_reason"] == "length"
