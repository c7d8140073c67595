"""The port's sampling diagnostics (``tsu_tpu_torch/ops/stats.py``) against
``tsu_tpu/ops/stats.py`` on the same numpy inputs, and the port's
enumeration oracle against the JAX package's. On the CPU."""

import numpy as np
import pytest
import torch

from tsu_tpu.ops import stats as jstats
from tsu_tpu.oracle import numpy_ref
from tsu_tpu_torch import oracle
from tsu_tpu_torch.ops import stats


def _ar1(seed, n, phi):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=n)
    x = np.zeros(n)
    for i in range(1, n):
        x[i] = phi * x[i - 1] + e[i]
    return x


@pytest.mark.parametrize("max_lag", [None, 7])
def test_autocorrelation_equals_jax(max_lag):
    x = _ar1(0, 600, 0.8)
    np.testing.assert_array_equal(stats.autocorrelation(x, max_lag),
                                  jstats.autocorrelation(x, max_lag))
    np.testing.assert_array_equal(stats.autocorrelation(np.ones(9)), jstats.autocorrelation(np.ones(9)))


@pytest.mark.parametrize("phi", [0.0, 0.6, 0.95])
def test_effective_sample_size_equals_jax(phi):
    x = _ar1(1, 2000, phi)
    assert stats.effective_sample_size(x) == jstats.effective_sample_size(x)
    assert stats.effective_sample_size(np.ones(50)) == 50.0
    assert stats.effective_sample_size(x[:3]) == 3.0


@pytest.mark.parametrize("shape", [(500,), (400, 3), (2, 300, 2)])
def test_ess_multichain_equals_jax(shape):
    x = np.random.default_rng(2).normal(size=shape).cumsum(axis=-2 if len(shape) > 1 else 0)
    assert stats.ess_multichain(x) == jstats.ess_multichain(x)


def test_kl_estimators_equal_jax():
    rng = np.random.default_rng(3)
    q = rng.random(32)
    q /= q.sum()
    counts = np.bincount(rng.choice(32, size=400, p=q), minlength=32).astype(float)
    p = counts / counts.sum()
    assert stats.kl_divergence_discrete(p, q) == jstats.kl_divergence_discrete(p, q)
    assert stats.kl_divergence_corrected(counts, q) == jstats.kl_divergence_corrected(counts, q)
    assert (stats.kl_divergence_calibrated(counts, q, n_boot=10, seed=4)
            == jstats.kl_divergence_calibrated(counts, q, n_boot=10, seed=4))


def test_moment_zscores_equal_jax():
    x = np.random.default_rng(5).normal(0.1, 1.0, (300, 6))
    exact = np.zeros(6)
    assert stats.moment_zscores(x, exact, 250.0) == jstats.moment_zscores(x, exact, 250.0)


def test_running_moments_equal_jax():
    x = np.random.default_rng(6).normal(size=(64, 5)).astype(np.float32)
    mean, std = stats.running_moments(torch.tensor(x))
    jm, js = jstats.running_moments(x)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(std.numpy(), np.asarray(js), rtol=1e-6)


@pytest.mark.parametrize("T", [0.5, 2.0])
def test_oracle_equals_jax(T):
    rng = np.random.default_rng(7)
    J = rng.normal(0, 0.5, (6, 6))
    J = (J + J.T) / 2
    np.fill_diagonal(J, 0)
    h = rng.normal(0, 0.3, 6)
    for ours, ref in ((oracle.exact_boltzmann_moments, numpy_ref.exact_boltzmann_moments),
                      (oracle.exact_ising_moments, numpy_ref.exact_ising_moments)):
        a, b = ours(J, h, T), ref(J, h, T)
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["mean"], b["mean"])
        for k in a:
            if k != "mean":
                assert a[k] == b[k]
    with pytest.raises(ValueError):
        oracle.exact_ising_moments(np.zeros((21, 21)), np.zeros(21))
