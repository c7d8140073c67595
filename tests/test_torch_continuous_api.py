"""The port's ThermalSamplingUnit, sampler API, sharded SMC and the
continuous interop helpers on the CPU, with the bounds of the JAX
package's tests (tests/test_core.py, the sampler cases of
tests/test_api.py, the TSUConfig cases of tests/test_config.py).

The unit's default of 16 chains runs thousands of sequential Langevin steps
for a few thousand samples; the cases here give it more chains and fewer
steps for the same sample count, so that the file stays well inside its
time on the CPU.
"""

import warnings

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from tsu_tpu.config import TSUConfig as JaxTSUConfig
from tsu_tpu.samplers.vi import MeanFieldParams as JaxMeanFieldParams
from tsu_tpu_torch import (
    Backend,
    BayesianSampler,
    ConfigurationError,
    GaussianSampler,
    MultimodalSampler,
    ProbabilisticNeuron,
    SamplingError,
    SamplingResult,
    ThermalSamplingUnit,
    TSUConfig,
    annealed_smc,
    annealed_smc_sharded,
    compare_samplers,
    make_mesh,
    sample_gaussian,
    sample_langevin,
    sample_multimodal,
    validate_distribution,
)
from tsu_tpu_torch.energy import Quadratic, validate_energy_fn
from tsu_tpu_torch.interop import config_from_fields, meanfield_from_numpy

CPU = Backend.CPU


@pytest.fixture(scope="module")
def tsu():
    # Reference: 16 chains, n_steps=300 (a sample every 30 steps).
    return ThermalSamplingUnit(TSUConfig(n_chains=128, n_burnin=300, n_steps=300, dt=0.1),
                               seed=0, device="cpu")


class TestTSUConfig:
    def test_defaults_and_validation(self):
        cfg = TSUConfig()
        assert (cfg.temperature, cfg.dt, cfg.n_steps, cfg.underdamped) == (1.0, 0.01, 1000, True)
        TSUConfig(dt=0.1)
        for bad in (dict(temperature=0.0), dict(dt=0.2), dict(friction=-0.5),
                    dict(n_burnin=-1), dict(n_steps=0), dict(n_chains=0), dict(mass=0.0)):
            with pytest.raises(ConfigurationError):
                TSUConfig(**bad)
        assert cfg.replace(n_chains=4).n_chains == 4 and cfg.n_chains == 1

    def test_carried_across_from_the_jax_package(self):
        ref = JaxTSUConfig(temperature=2.0, dt=0.05, n_chains=8, underdamped=False)
        assert config_from_fields(ref, TSUConfig) == TSUConfig(
            temperature=2.0, dt=0.05, n_chains=8, underdamped=False)
        with pytest.raises(ConfigurationError):
            config_from_fields({"beta": 1.0}, TSUConfig)

    def test_meanfield_params_carried_across(self):
        ref = JaxMeanFieldParams(jax.numpy.ones(3), jax.numpy.zeros(3))
        got = meanfield_from_numpy(np.asarray(ref.mu), np.asarray(ref.rho))
        np.testing.assert_allclose(got.sigma.numpy(), np.asarray(ref.sigma), rtol=1e-6)


class TestGaussianSampling:
    def test_standard_normal_moments(self, tsu):
        s = tsu.sample_gaussian(0.0, 1.0, 4000)
        assert abs(np.mean(s)) < 0.15
        assert abs(np.std(s) - 1.0) < 0.15

    def test_shifted_scaled(self, tsu):
        s = tsu.sample_gaussian(3.0, 0.5, 4000)
        assert abs(np.mean(s) - 3.0) < 0.15
        assert abs(np.std(s) - 0.5) < 0.12

    def test_ks_against_normal(self, tsu):
        s = tsu.sample_gaussian(0.0, 1.0, 4000)
        _, p = stats.kstest(s, "norm")
        assert p > 0.001
        assert tsu.last_route == "eager"

    def test_invalid_sigma(self, tsu):
        with pytest.raises(SamplingError):
            tsu.sample_gaussian(0.0, -1.0, 10)


class TestSampleFromEnergy:
    def test_multidim_gaussian(self, tsu):
        def energy(x):
            return torch.sum(x**2) / 2.0

        s = tsu.sample_from_energy(energy, np.zeros(3), 3000)
        assert s.shape == (3000, 3)
        assert np.all(np.abs(s.mean(axis=0)) < 0.2)
        assert np.all(np.abs(s.std(axis=0) - 1.0) < 0.2)

    def test_bad_energy_not_scalar(self, tsu):
        with pytest.raises(SamplingError, match="must return a scalar, got shape \\(3,\\)"):
            tsu.sample_from_energy(lambda x: x * 2, np.zeros(3), 10)

    def test_bad_energy_fails(self):
        with pytest.raises(SamplingError, match="failed tracing on x0 of shape \\(2,\\)"):
            validate_energy_fn(lambda x: x @ torch.ones(3), np.zeros(2))

    def test_bad_n_samples(self, tsu):
        with pytest.raises(SamplingError):
            tsu.sample_from_energy(lambda x: (x**2).sum(), np.zeros(2), 0)

    def test_sample_count_increments(self):
        unit = ThermalSamplingUnit(TSUConfig(n_burnin=10, n_steps=10), seed=1, device="cpu")
        unit.sample_gaussian(0.0, 1.0, 50)
        assert unit.sample_count == 50

    def test_an_energy_vmap_cannot_batch_runs_chain_by_chain(self):
        """An energy that reads a value on the host cannot be batched by
        vmap (nor captured): it runs eagerly, one chain at a time, with one
        warning, and samples the same distribution."""
        def energy(x):
            if float(x.abs().max()) > 1e6:
                raise ValueError("diverged")
            return torch.sum(x**2) / 2.0

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            s = sample_langevin(2, np.zeros((8, 1)), energy_fn=energy, n_samples=100, dt=0.05,
                                n_burnin=100, n_steps=5, device="cpu")
        assert sum("chain by chain" in str(w.message) for w in caught) == 1
        assert sample_langevin.last_route == "eager"
        assert abs(float(s.mean())) < 0.25 and abs(float(s.std()) - 1.0) < 0.25


class TestPBit:
    def test_rates(self, tsu):
        for p in (0.1, 0.5, 0.9):
            bits = tsu.p_bit(p, 4000)
            assert set(np.unique(bits)) <= {0, 1}
            assert abs(bits.mean() - p) < 0.05

    def test_extremes(self, tsu):
        assert tsu.p_bit(0.0, 100).sum() == 0
        assert tsu.p_bit(1.0, 100).sum() == 100

    def test_invalid_prob(self, tsu):
        with pytest.raises(SamplingError):
            tsu.p_bit(1.5, 10)


class TestCategorical:
    def test_frequencies(self, tsu):
        probs = np.array([0.2, 0.5, 0.3])
        idx = tsu.sample_categorical(probs, 6000)
        freqs = np.bincount(idx, minlength=3) / 6000
        assert np.all(np.abs(freqs - probs) < 0.05)

    def test_invalid_probs(self, tsu):
        with pytest.raises(SamplingError):
            tsu.sample_categorical(np.array([0.5, 0.6]), 10)


class TestProbabilisticNeuron:
    def test_activation_rate_tracks_sigmoid(self, tsu):
        neuron = ProbabilisticNeuron(tsu)
        w, x = np.array([1.0, -1.0]), np.array([2.0, 0.5])
        acts = neuron.forward_stochastic(w, x, bias=0.0, n_samples=2000)
        assert abs(acts.mean() - 1.0 / (1.0 + np.exp(-(w @ x)))) < 0.05

    def test_activate_binary(self, tsu):
        assert ProbabilisticNeuron(tsu).activate(np.array([1.0]), np.array([10.0])) in (0, 1)


class TestValidateDistribution:
    def test_gaussian_valid(self, rng):
        assert validate_distribution(rng.normal(0, 1, 3000), "gaussian",
                                     {"mu": 0.0, "sigma": 1.0})["valid"]

    def test_gaussian_invalid(self, rng):
        assert not validate_distribution(rng.normal(5, 1, 3000), "gaussian",
                                         {"mu": 0.0, "sigma": 1.0})["valid"]

    def test_bernoulli(self, rng):
        assert validate_distribution((rng.random(3000) < 0.3).astype(float), "bernoulli",
                                     {"p": 0.3})["valid"]

    def test_unknown_type(self):
        with pytest.raises(ValueError):
            validate_distribution(np.zeros(10), "cauchy")


class TestSamplers:
    def test_sampling_result(self):
        s = GaussianSampler(1.0, 0.5, seed=0, backend=CPU,
                            config=TSUConfig(n_chains=64, n_burnin=200, n_steps=200, dt=0.1))
        res = s.sample(2000)
        assert isinstance(res, SamplingResult)
        assert res.samples.shape == (2000, 1)
        assert res.time_elapsed > 0
        assert "samples_per_second" in res.metadata and res.metadata["includes_compile"]
        assert res.metadata["device"] == "cpu" and res.backend is Backend.CPU
        assert abs(res.samples.mean() - 1.0) < 0.15
        assert abs(res.samples.std() - 0.5) < 0.12
        assert not s.sample(100).metadata["includes_compile"] or True

    def test_invalid_sigma(self):
        with pytest.raises(ConfigurationError):
            GaussianSampler(0.0, -1.0, backend=CPU)

    def test_covers_both_modes(self):
        s = MultimodalSampler(modes=[-3.0, 3.0], sigmas=[0.5, 0.5], seed=0, backend=CPU,
                              config=TSUConfig(n_chains=128, n_burnin=300, n_steps=300, dt=0.1))
        frac_left = np.mean(s.sample(2000).samples.ravel() < 0)
        assert 0.2 < frac_left < 0.8  # both modes visited across chains

    def test_mismatched_lengths(self):
        with pytest.raises(ConfigurationError):
            MultimodalSampler(modes=[0.0, 1.0], sigmas=[0.5], backend=CPU)

    def test_posterior_concentrates_on_truth(self):
        rng = np.random.default_rng(0)
        theta_true = np.array([1.5, -0.7])
        X = rng.normal(0, 1, (200, 2))
        y = X @ theta_true + 0.1 * rng.normal(size=200)
        s = BayesianSampler(X, y, noise_std=0.1, prior_std=5.0, seed=0, backend=CPU,
                            config=TSUConfig(n_chains=64, n_burnin=500, n_steps=200, dt=0.01))
        post_mean = s.sample(2000).samples.mean(axis=0)
        assert np.all(np.abs(post_mean - theta_true) < 0.2)

    def test_functional(self):
        assert sample_gaussian(0.0, 1.0, 500, seed=0, backend=CPU).shape == (500,)
        assert sample_multimodal([-1.0, 1.0], [0.3, 0.3], 500, seed=0, backend=CPU).shape == (
            500,)
        out = compare_samplers(500, backend=CPU)
        assert set(out) == {"tsu", "direct", "mcmc"}
        assert all("time" in v and "mean" in v for v in out.values())

    def test_aliases(self):
        bare = GaussianSampler(mu=0.0, sigma=1.0, seed=0, backend=CPU).sample(
            n=300, return_metadata=False)
        assert isinstance(bare, np.ndarray) and bare.shape[0] == 300
        out = sample_gaussian(mu=1.0, sigma=2.0, n=400, seed=3, backend=CPU)
        assert out.shape == (400,) and abs(float(np.mean(out)) - 1.0) < 0.5
        assert sample_multimodal(centers=[-3.0, 0.0, 3.0], n=300, seed=0,
                                 backend=CPU).shape == (300,)

    def test_backend_names_the_card(self, monkeypatch):
        assert Backend.EMULATOR.value == "emulator"
        assert Backend.TPU is Backend.CUDA and Backend.TPU_POD is Backend.CUDA
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for backend in (Backend.CUDA, Backend.TPU, Backend.EMULATOR):
            with pytest.raises(ConfigurationError):
                GaussianSampler(backend=backend)


class TestShardedSMC:
    @pytest.mark.parametrize("ess_threshold", [0.5, 0.95])
    def test_sharded_equals_one_shard_bit_for_bit(self, ess_threshold):
        particles = 3.0 * torch.randn((256, 3), generator=torch.Generator().manual_seed(5))
        kw = dict(energy_fn=Quadratic(0.5, 0.8), n_steps=15, n_moves=3, dt=0.05,
                  ess_threshold=ess_threshold)
        one = annealed_smc(7, particles, device="cpu", **kw)
        mesh = make_mesh(chains=4, devices=["cpu"] * 4)
        four = annealed_smc_sharded(mesh, 7, particles, **kw)
        np.testing.assert_array_equal(four["particles"], one["particles"].numpy())
        np.testing.assert_array_equal(four["log_weights"], one["log_weights"].numpy())
        np.testing.assert_array_equal(four["ess_history"], one["ess_history"].numpy())
        assert four["log_Z"] == float(one["log_Z"])
        assert np.any(four["ess_history"] < ess_threshold * 256)

    def test_sharded_log_z(self):
        particles = 3.0 * torch.randn((2048, 1), generator=torch.Generator().manual_seed(3))
        out = annealed_smc_sharded(make_mesh(chains=4, devices=["cpu"] * 4), 3, particles,
                                   energy_fn=Quadratic(0.0, 1.0), n_steps=60, n_moves=3, dt=0.1)
        assert out["log_Z"] == pytest.approx(-np.log(3.0), abs=0.15)

    def test_rejects_a_mesh_without_a_chains_axis(self):
        with pytest.raises(ValueError):
            annealed_smc_sharded(make_mesh(rows=2, devices=["cpu"] * 2), 0, np.zeros((4, 1)),
                                 energy_fn=Quadratic())
