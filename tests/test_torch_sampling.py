"""The port's sampler (engine/sampling.py) against the JAX package's.

Greedy rows must be token-identical to ``dynamo_tpu.engine.sampling
.sample_tokens``, ties included (first index of the maximum). Sampled
rows cannot match the JAX threefry stream bit for bit: they are checked
by seeded self-consistency and by their distribution."""

import jax.numpy as jnp
import numpy as np
import torch

from dynamo_tpu.engine.sampling import sample_tokens as jax_sample
from dynamo_tpu_torch.engine.sampling import SamplingBatch, sample_tokens
from dynamo_tpu_torch.llm.protocols.common import SamplingOptions


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
