"""The port's sampler (engine/sampling.py) against the JAX package's.

Greedy rows must be token-identical to ``dynamo_tpu.engine.sampling
.sample_tokens``, ties included (first index of the maximum). Sampled
rows cannot match the JAX threefry stream bit for bit: they are checked
by seeded self-consistency and by their distribution. The sampler is one
branchless device program: it reads no tensor value on the host."""

import jax.numpy as jnp
import numpy as np
import torch

from dynamo_tpu.engine.sampling import sample_tokens as jax_sample
from dynamo_tpu_torch.engine.sampling import (SamplingBatch, gumbel_noise,
                                              sample_tokens)
from dynamo_tpu_torch.llm.protocols.common import SamplingOptions
from torch_sync_guard import NoHostReads


def _greedy_params(B):
    return (np.zeros(B, np.float32), np.zeros(B, np.int32),
            np.ones(B, np.float32), np.zeros(B, np.uint32))


def test_greedy_tie_break_matches_jax():
    rng = np.random.RandomState(0)
    B, V = 6, 300
    logits = rng.randn(B, V).astype(np.float32)
    # ties for the maximum at different places, incl. adjacent and far
    for b, idx in enumerate([(3, 4), (0, 299), (17, 100, 250), (5,),
                             (298, 299), (1, 2, 3)]):
        logits[b, list(idx)] = 10.0
    t, k, p, s = _greedy_params(B)
    want = np.asarray(jax_sample(jnp.asarray(logits), jnp.asarray(t),
                                 jnp.asarray(k), jnp.asarray(p),
                                 jnp.asarray(s), jnp.int32(0)))
    got = sample_tokens(torch.from_numpy(logits), t, k, p, s, 0).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [3, 0, 17, 5, 298, 1])
    assert got.dtype == np.int32


def test_greedy_random_logits_match_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(16, 512).astype(np.float32)
    t, k, p, s = _greedy_params(16)
    want = np.asarray(jax_sample(jnp.asarray(logits), jnp.asarray(t),
                                 jnp.asarray(k), jnp.asarray(p),
                                 jnp.asarray(s), jnp.int32(3)))
    got = sample_tokens(torch.from_numpy(logits), t, k, p, s, 3).numpy()
    np.testing.assert_array_equal(got, want)


def test_sampled_rows_seeded_and_bounded():
    rng = np.random.RandomState(2)
    B, V = 4, 200
    logits = torch.from_numpy(rng.randn(B, V).astype(np.float32))
    temp = np.array([0.0, 1.0, 0.7, 1.0], np.float32)
    topk = np.array([0, 0, 5, 1], np.int32)
    topp = np.array([1.0, 0.9, 1.0, 1.0], np.float32)
    seeds = np.array([0, 11, 12, 13], np.uint32)
    steps = np.array([0, 4, 4, 4], np.int32)
    a = sample_tokens(logits, temp, topk, topp, seeds, steps)
    b = sample_tokens(logits, temp, topk, topp, seeds, steps)
    assert torch.equal(a, b)  # same (seed, step) → same draw
    greedy = torch.argmax(logits, -1)
    assert a[0] == greedy[0] and a[3] == greedy[3]  # greedy / top-k=1
    top5 = torch.topk(logits[2] / 0.7, 5).indices
    assert a[2] in top5
    # a different step moves the stream: across steps the draws vary
    draws = {int(sample_tokens(logits, temp, topk, topp, seeds,
                               np.full(B, i, np.int32))[1])
             for i in range(20)}
    assert len(draws) > 1


def test_sampled_distribution_follows_softmax():
    """Over many (seed, step) streams the empirical frequencies of a
    4-token distribution follow softmax(logits / T) (4-sigma bound)."""
    logits = torch.tensor([[2.0, 1.0, 0.5, -1.0] + [-1e9] * 60])
    T = 1.3
    probs = torch.softmax(logits[0, :4] / T, -1).numpy()
    n = 1500
    counts = np.zeros(4)
    for i in range(n):
        tok = int(sample_tokens(logits, np.array([T], np.float32),
                                np.zeros(1, np.int32),
                                np.ones(1, np.float32),
                                np.array([i], np.uint32), 0)[0])
        counts[tok] += 1
    sigma = np.sqrt(n * probs * (1 - probs))
    assert np.all(np.abs(counts - n * probs) < 4 * sigma), (counts, probs)


def test_sampling_batch_pads_with_greedy_rows():
    sb = SamplingBatch.build([SamplingOptions(temperature=0.5, top_k=7,
                                              top_p=0.9, seed=42)], 4)
    np.testing.assert_array_equal(sb.temperature, [0.5, 0, 0, 0])
    np.testing.assert_array_equal(sb.top_k, [7, 0, 0, 0])
    np.testing.assert_allclose(sb.top_p, [0.9, 1, 1, 1])
    assert sb.seeds[0] == 42


def _mixed_batch(B=6, V=300, seed=4):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, V).astype(np.float32)
    logits[1, [7, 9]] = 9.0  # a greedy row with a tie
    temp = np.array([0.0, 0.0, 0.9, 1.2, 0.0, 0.6], np.float32)[:B]
    topk = np.array([0, 5, 20, 0, 3, 1], np.int32)[:B]
    topp = np.array([1.0, 0.5, 0.8, 1.0, 1.0, 0.3], np.float32)[:B]
    seeds = np.array([1, 2, 3, 4, 5, 6], np.uint32)[:B]
    steps = np.array([0, 3, 7, 2, 0, 9], np.int32)[:B]
    return logits, temp, topk, topp, seeds, steps


def test_greedy_rows_of_a_mixed_batch_match_jax():
    """Greedy rows beside sampled ones: identical to the JAX sampler
    (top-k / top-p settings of a greedy row change nothing)."""
    logits, temp, topk, topp, seeds, steps = _mixed_batch()
    want = np.asarray(jax_sample(*map(jnp.asarray, (
        logits, temp, topk, topp, seeds, steps))))
    got = sample_tokens(torch.from_numpy(logits), temp, topk, topp, seeds,
                        steps).numpy()
    greedy = temp == 0
    np.testing.assert_array_equal(got[greedy], want[greedy])
    assert got[1] == 7  # first index of the tie
    # top-k = 1 draws the maximum whatever the temperature
    assert got[5] == np.argmax(logits[5])


def test_sampler_reads_no_host_value():
    """Device tensors in, no .item()/.cpu()/nonzero/mask indexing inside:
    the draw can run in a captured window without a sync."""
    logits, temp, topk, topp, seeds, steps = _mixed_batch()
    args = [torch.from_numpy(a) for a in (
        logits, temp, topk, topp, seeds.astype(np.int64), steps)]
    want = sample_tokens(*args)
    with NoHostReads():
        got = sample_tokens(*args)
    assert torch.equal(got, want)


def test_sampled_draw_is_a_function_of_seed_step_and_row_only():
    """A row's draw depends on its (seed, step) and logits only: not on
    its place in the batch nor on the other rows."""
    logits, temp, topk, topp, seeds, steps = _mixed_batch()
    full = sample_tokens(torch.from_numpy(logits), temp, topk, topp, seeds,
                         steps)
    perm = np.array([3, 0, 5, 2, 4, 1])
    shuffled = sample_tokens(torch.from_numpy(logits[perm]), temp[perm],
                             topk[perm], topp[perm], seeds[perm],
                             steps[perm])
    assert torch.equal(shuffled, full[perm])
    for i in range(len(temp)):
        one = sample_tokens(torch.from_numpy(logits[i:i + 1]), temp[i:i + 1],
                            topk[i:i + 1], topp[i:i + 1], seeds[i:i + 1],
                            steps[i:i + 1])
        assert int(one[0]) == int(full[i])


def test_top_p_keeps_the_first_candidate_only_when_tiny():
    rng = np.random.RandomState(5)
    logits = torch.from_numpy(rng.randn(8, 100).astype(np.float32))
    B = 8
    got = sample_tokens(logits, np.full(B, 1.5, np.float32),
                        np.zeros(B, np.int32), np.full(B, 1e-6, np.float32),
                        np.arange(B, dtype=np.uint32), np.arange(B))
    assert torch.equal(got.long(), torch.argmax(logits, -1))


def test_gumbel_noise_is_counter_based():
    """Same (seed, step) → same noise; any change of seed or step moves
    every candidate's noise; the uniforms behind it stay inside (0, 1)
    (finite noise) and have mean 0.5772 (Euler's constant) over many
    draws (4-sigma bound, sigma = pi / sqrt(6 n))."""
    seeds = torch.tensor([0, 1, 2**32 - 1, 12345], dtype=torch.int64)
    step = torch.tensor([0, 0, 5, 2**31 - 1], dtype=torch.int64)
    a, b = gumbel_noise(seeds, step, 64), gumbel_noise(seeds, step, 64)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert (a != gumbel_noise(seeds, step + 1, 64)).all()
    assert (a != gumbel_noise(seeds + 1, step, 64)).all()
    many = gumbel_noise(torch.arange(4000, dtype=torch.int64),
                        torch.zeros(4000, dtype=torch.int64), 64)
    n = many.numel()
    assert abs(float(many.mean()) - 0.5772157) < 4 * np.pi / np.sqrt(6 * n)
