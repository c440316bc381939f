"""The port's latency histograms (runtime/slo.py) against the JAX
package's: the same observations through ``dynamo_tpu.runtime.slo
.LatencyRecorder`` and the port's copy give identical wire forms (what
``stats()["latency_hist"]`` exports), and the histograms' nearest-bucket
quantiles agree."""

import numpy as np
import pytest

from dynamo_tpu.runtime import slo as jax_slo
from dynamo_tpu_torch.runtime import slo


def _observations(seed: int):
    """(metric, seconds, n) triples over every metric, from token
    cadence to past the last bucket bound, some on a bound exactly."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(300):
        metric = slo.METRICS[rng.randint(len(slo.METRICS))]
        value = float(np.exp(rng.uniform(np.log(1e-4), np.log(2000.0))))
        out.append((metric, value, int(rng.randint(1, 5))))
    out += [("ttft", b, 1) for b in slo.LATENCY_BUCKETS]
    out += [("itl", 0.0, 3), ("e2e", 1e4, 2), ("queue_wait", 0.5, 0)]
    return out


def test_grid_and_metric_names_are_the_jax_packages():
    assert slo.LATENCY_BUCKETS == jax_slo.LATENCY_BUCKETS
    assert slo.METRICS == jax_slo.METRICS


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("role", ["unified", "prefill"])
def test_recorder_wire_matches_jax(seed, role):
    ours, theirs = slo.LatencyRecorder(role), jax_slo.LatencyRecorder(role)
    for metric, value, n in _observations(seed):
        ours.observe(metric, value, n)
        theirs.observe(metric, value, n)
    assert ours.to_wire() == theirs.to_wire()
    assert set(ours.to_wire()[role]) == set(slo.METRICS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_quantiles_match_jax(seed):
    ours, theirs = slo.Histogram(), jax_slo.Histogram()
    assert ours.quantile(0.5) is None and theirs.quantile(0.5) is None
    for _, value, n in _observations(seed):
        ours.observe(value, n)
        theirs.observe(value, n)
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert ours.quantile(q) == theirs.quantile(q)
    assert ours.to_wire() == theirs.to_wire()
