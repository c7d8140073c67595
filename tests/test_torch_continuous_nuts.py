"""Moment tests of the port's NUTS and adaptive HMC on the CPU, with the
bounds of the JAX package's tests (tests/test_nuts.py; the adaptive HMC
cases of tests/test_vi_mala.py).

Where a reference test runs many sequential transitions, this one runs more
chains and fewer transitions, so that the file stays well inside its time
on the CPU. On the CPU the NUTS doubling stops once every chain is done.
"""

import numpy as np
import torch

from tsu_tpu_torch.energy import MixtureOfGaussians, Quadratic
from tsu_tpu_torch.samplers import sample_hmc_adaptive, sample_nuts

CPU = "cpu"


def _flat(samples, dim):
    return samples.reshape(-1, dim).numpy()


def _aniso(var0, var1):
    def energy(x):
        return x[0] ** 2 / (2 * var0) + x[1] ** 2 / (2 * var1)
    return energy


class TestNUTS:
    def test_standard_gaussian_moments(self):
        samples, info = sample_nuts(0, np.zeros((32, 4)), energy_fn=Quadratic(0.0, 1.0),
                                    n_samples=100, n_burnin=100, max_depth=6, device=CPU)
        flat = _flat(samples, 4)
        assert np.all(np.abs(flat.mean(axis=0)) < 0.08)
        assert np.all(np.abs(flat.std(axis=0) - 1.0) < 0.08)
        assert 0.5 < info["accept_stat"] < 1.0

    def test_anisotropic_gaussian(self):
        samples, _ = sample_nuts(1, np.zeros((32, 2)), energy_fn=_aniso(9.0, 0.04),
                                 n_samples=80, n_burnin=80, max_depth=8, device=CPU)
        flat = _flat(samples, 2)
        assert abs(flat[:, 0].std() - 3.0) < 0.35
        assert abs(flat[:, 1].std() - 0.2) < 0.03

    def test_trees_deepen_for_hard_targets(self):
        def energy(x):
            return x[0] ** 2 / (2 * 100.0) + torch.sum(x[1:] ** 2) / 2.0

        _, info = sample_nuts(2, np.zeros((4, 3)), energy_fn=energy, n_samples=100,
                              n_burnin=100, max_depth=8, device=CPU)
        assert info["mean_tree_depth"] > 1.5

    def test_bimodal_with_close_modes(self):
        energy = MixtureOfGaussians(((-1.5,), (1.5,)), (0.8, 0.8))
        samples, _ = sample_nuts(3, np.zeros((64, 1)), energy_fn=energy, n_samples=125,
                                 n_burnin=100, max_depth=7, device=CPU)
        assert 0.3 < np.mean(samples.numpy().ravel() < 0) < 0.7


class TestAdaptiveHMC:
    def test_gaussian_moments(self):
        samples, info = sample_hmc_adaptive(0, np.zeros((32, 4)), energy_fn=Quadratic(0.0, 1.0),
                                            n_samples=100, n_burnin=150, device=CPU)
        flat = _flat(samples, 4)
        assert np.all(np.abs(flat.mean(axis=0)) < 0.08)
        assert np.all(np.abs(flat.std(axis=0) - 1.0) < 0.08)
        assert 0.6 < info["accept_rate"] < 0.95

    def test_anisotropic(self):
        samples, _ = sample_hmc_adaptive(1, np.zeros((32, 2)), energy_fn=_aniso(9.0, 0.04),
                                         n_samples=100, n_burnin=150, n_leapfrog=32, device=CPU)
        flat = _flat(samples, 2)
        assert abs(flat[:, 0].std() - 3.0) < 0.4
        assert abs(flat[:, 1].std() - 0.2) < 0.04
