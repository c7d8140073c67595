"""Moment tests of the port's continuous samplers on the CPU, with the
bounds of the JAX package's tests (tests/test_samplers.py: Langevin, HMC,
SMC; tests/test_vi_mala.py: VI and MALA). NUTS and adaptive HMC are in
tests/test_torch_continuous_nuts.py.

Where a reference test runs many sequential steps, this one runs more
chains and fewer steps for about the same sample count, so that the file
stays well inside its time on the CPU.
"""

import numpy as np
import pytest
import torch

from tsu_tpu_torch.energy import MixtureOfGaussians, Quadratic
from tsu_tpu_torch.samplers import (
    annealed_smc,
    fit_meanfield_vi,
    sample_hmc,
    sample_langevin,
    sample_mala,
    systematic_resample_indices,
)

CPU = "cpu"


def _flat(samples, dim):
    return samples.reshape(-1, dim).numpy()


def _aniso(var0, var1):
    def energy(x):
        return x[0] ** 2 / (2 * var0) + x[1] ** 2 / (2 * var1)
    return energy


class TestLangevin:
    @pytest.mark.parametrize("underdamped", [True, False])
    def test_gaussian_moments(self, underdamped):
        # Reference: 16 chains x 300 samples after 300 burn-in steps; here
        # 512 chains x 10, so the samples are nearly independent.
        s = sample_langevin(0, np.zeros((512, 2)), energy_fn=Quadratic(0.0, 1.0), n_samples=10,
                            dt=0.05 if underdamped else 0.01, n_burnin=300, n_steps=5,
                            underdamped=underdamped, device=CPU)
        assert s.shape == (512, 10, 2)
        flat = _flat(s, 2)
        assert np.all(np.abs(flat.mean(axis=0)) < 0.1)
        assert np.all(np.abs(flat.std(axis=0) - 1.0) < 0.12)

    def test_temperature_scales_variance(self):
        kwargs = dict(energy_fn=Quadratic(0.0, 1.0), n_samples=100, dt=0.05, n_burnin=300,
                      n_steps=5, device=CPU)
        hot = sample_langevin(1, np.zeros((32, 1)), temperature=4.0, **kwargs)
        cold = sample_langevin(1, np.zeros((32, 1)), temperature=0.25, **kwargs)
        # Var scales linearly with T: std ratio ~ sqrt(16) = 4.
        ratio = hot.std() / cold.std()
        assert 2.5 < float(ratio) < 6.0


class TestHMC:
    def test_gaussian_exact(self):
        s, acc = sample_hmc(0, np.zeros((32, 3)), energy_fn=Quadratic(0.0, 1.0), n_samples=125,
                            step_size=0.3, n_leapfrog=8, n_burnin=50, device=CPU)
        assert s.shape == (32, 125, 3)
        assert acc > 0.7
        flat = _flat(s, 3)
        assert np.all(np.abs(flat.mean(axis=0)) < 0.08)
        assert np.all(np.abs(flat.std(axis=0) - 1.0) < 0.08)

    def test_anisotropic_gaussian(self):
        s, _ = sample_hmc(2, np.zeros((32, 2)), energy_fn=_aniso(4.0, 0.25), n_samples=200,
                          step_size=0.2, n_leapfrog=10, n_burnin=100, device=CPU)
        flat = _flat(s, 2)
        assert abs(flat[:, 0].std() - 2.0) < 0.25
        assert abs(flat[:, 1].std() - 0.5) < 0.08


class TestSMC:
    def test_systematic_resampling_unbiased(self):
        log_w = torch.log(torch.tensor([0.1, 0.2, 0.3, 0.4]))
        gen = torch.Generator().manual_seed(0)
        counts = np.zeros(4)
        for _ in range(200):
            idx = systematic_resample_indices(torch.rand((), generator=gen), log_w)
            counts += np.bincount(idx.numpy(), minlength=4)
        np.testing.assert_allclose(counts / counts.sum(), [0.1, 0.2, 0.3, 0.4], atol=0.03)

    def test_multimodal_target(self):
        energy = MixtureOfGaussians(((-3.0,), (3.0,)), (0.5, 0.5))
        particles = 3.0 * torch.randn((512, 1), generator=torch.Generator().manual_seed(1))
        out = annealed_smc(1, particles, energy_fn=energy, n_steps=40, n_moves=5, dt=0.05,
                           device=CPU)
        x = out["particles"].numpy().ravel()
        assert 0.3 < np.mean(x < 0) < 0.7
        # Mode means near ±3.
        assert abs(np.mean(np.abs(x)) - 3.0) < 0.4

    def test_log_z_gaussian(self):
        # Target N(0, 1) from base N(0, 3^2): Z_target / Z_base = 1/3.
        particles = 3.0 * torch.randn((2048, 1), generator=torch.Generator().manual_seed(3))
        out = annealed_smc(3, particles, energy_fn=Quadratic(0.0, 1.0), n_steps=60, n_moves=3,
                           dt=0.1, base_sigma=3.0, device=CPU)
        expected = 0.5 * np.log(2 * np.pi) - 0.5 * np.log(2 * np.pi * 9.0)
        assert float(out["log_Z"]) == pytest.approx(expected, abs=0.15)
        assert out["route"] == "eager"


class TestMeanFieldVI:
    def test_gaussian_recovered_exactly(self):
        # Target N(2, 0.5^2): mean-field VI on a Gaussian is exact.
        out = fit_meanfield_vi(0, Quadratic(2.0, 0.5), 3, n_steps=800, learning_rate=0.05,
                               device=CPU)
        np.testing.assert_allclose(out["mu"].numpy(), 2.0, atol=0.08)
        np.testing.assert_allclose(out["sigma"].numpy(), 0.5, atol=0.08)

    def test_elbo_improves(self):
        # Start far from the target so there is ground to gain.
        out = fit_meanfield_vi(1, Quadratic(0.0, 1.0), 2, n_steps=400,
                               init_mu=np.array([4.0, -4.0]), init_sigma=0.1, device=CPU)
        losses = out["losses"].numpy()
        assert losses[-50:].mean() < losses[:50].mean() - 1.0

    def test_sample_closure(self):
        out = fit_meanfield_vi(2, Quadratic(1.0, 1.0), 2, n_steps=500, device=CPU)
        s = out["sample"](3, 4000).numpy()
        assert s.shape == (4000, 2)
        assert np.all(np.abs(s.mean(axis=0) - 1.0) < 0.1)

    def test_correlated_target_matches_marginals(self):
        out = fit_meanfield_vi(4, _aniso(4.0, 0.25), 2, n_steps=1000, device=CPU)
        sig = out["sigma"].numpy()
        assert abs(sig[0] - 2.0) < 0.2
        assert abs(sig[1] - 0.5) < 0.08


class TestMALA:
    def test_gaussian_moments_exact(self):
        samples, _ = sample_mala(0, np.zeros((64, 3)), energy_fn=Quadratic(0.0, 1.0),
                                 n_samples=125, n_burnin=300, device=CPU)
        flat = _flat(samples, 3)
        assert np.all(np.abs(flat.mean(axis=0)) < 0.08)
        assert np.all(np.abs(flat.std(axis=0) - 1.0) < 0.08)

    def test_adaptation_hits_target(self):
        _, info = sample_mala(1, np.zeros((32, 5)), energy_fn=Quadratic(0.0, 1.0),
                              n_samples=300, n_burnin=500, step_size=1e-3, device=CPU)
        assert 0.4 < info["accept_rate"] < 0.8
        assert info["step_size"] > 5e-3

    def test_no_adapt_keeps_step(self):
        _, info = sample_mala(2, np.zeros((4, 2)), energy_fn=Quadratic(0.0, 1.0), n_samples=50,
                              n_burnin=50, step_size=0.05, adapt=False, device=CPU)
        assert info["step_size"] == pytest.approx(0.05, rel=1e-5)
