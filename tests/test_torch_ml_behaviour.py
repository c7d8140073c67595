"""The behaviour tests of ``tests/test_ml.py`` on the port's BNN module
(``tsu_tpu_torch/models/ml.py``), on the CPU: shapes, validation errors,
that sigma is learned, that sigma_n recovers the noise, calibrated
intervals, the ensemble's out-of-distribution spread and active learning,
with the reference's sizes, seeds and bounds.
"""

import numpy as np
import pytest
import torch

from tsu_tpu_torch import (
    AnchoredEnsembleRegressor,
    BayesianLinear,
    BayesianNetwork,
    BayesianRegressor,
    ConfigurationError,
    PredictionResult,
)
from tsu_tpu_torch.models import ml

CPU = "cpu"


class TestStochasticLayer:
    def test_sample_weights_shapes(self):
        w, b = BayesianLinear(3, 2, seed=0, device=CPU).sample_weights()
        assert w.shape == (3, 2) and b.shape == (2,)

    def test_temperature_scales_variance(self):
        layer = BayesianLinear(20, 20, seed=0, device=CPU)
        cold = np.std([layer.sample_weights(0.01)[0] for _ in range(10)])
        hot = np.std([layer.sample_weights(4.0)[0] for _ in range(10)])
        assert hot > cold

    def test_kl_monotonic_in_mu(self):
        layer = BayesianLinear(4, 4, seed=0, device=CPU)
        kl0 = layer.compute_kl_divergence()
        with torch.no_grad():
            layer.w_mu += 3.0
        assert layer.compute_kl_divergence() > kl0

    def test_forward_shape_and_parameters(self):
        layer = BayesianLinear(3, 2, seed=0, device=CPU)
        assert layer.forward(np.ones((5, 3))).shape == (5, 2)
        assert sorted(n for n, _ in layer.named_parameters()) == sorted(ml.KEYS)

    def test_bad_dims_rejected(self):
        with pytest.raises(ConfigurationError):
            BayesianLinear(0, 2, device=CPU)


class TestBayesianNetwork:
    def test_forward_shapes_and_module_list(self):
        net = BayesianNetwork([2, 8, 1], seed=0, device=CPU)
        assert net.forward(np.ones((4, 2))).shape == (4, 1)
        assert isinstance(net.layers, torch.nn.ModuleList) and len(net.layers) == 2

    def test_stochastic_forward_varies(self):
        net = BayesianNetwork([2, 8, 1], seed=0, device=CPU)
        outs = [net.forward(np.ones((1, 2)))[0, 0] for _ in range(5)]
        assert np.std(outs) > 0

    def test_predict_result(self):
        net = BayesianNetwork([1, 8, 1], seed=0, device=CPU)
        res = net.predict(np.linspace(-1, 1, 7)[:, None], n_samples=20)
        assert isinstance(res, PredictionResult)
        assert res.mean.shape == (7, 1) and res.std.shape == (7, 1)
        assert res.samples.shape == (20, 7, 1)
        assert np.all(res.std >= 0) and np.all((0 <= res.confidence) & (res.confidence <= 1))
        assert net.last_route == "eager"

    def test_activations(self):
        for act in ("relu", "tanh", "sigmoid"):
            BayesianNetwork([2, 4, 1], activation=act, seed=0, device=CPU).forward(np.ones((1, 2)))
        with pytest.raises(ConfigurationError):
            BayesianNetwork([2, 4, 1], activation="swish", device=CPU)
        with pytest.raises(ConfigurationError):
            BayesianNetwork([2], device=CPU)

    def test_training_reduces_loss(self):
        rng = np.random.default_rng(0)
        x = rng.uniform(-1, 1, (64, 1)).astype(np.float32)
        net = BayesianNetwork([1, 16, 1], temperature=0.1, seed=0, device=CPU)
        losses = net.fit(x, np.sin(3 * x), n_epochs=60, batch_size=32, learning_rate=0.02,
                         kl_weight=1e-4)["loss_history"]
        assert len(losses) == 60 and losses[-1] < losses[0] * 0.5

    def test_sigma_is_learned(self):
        rng = np.random.default_rng(1)
        x = rng.uniform(-1, 1, (64, 1)).astype(np.float32)
        net = BayesianNetwork([1, 8, 1], temperature=1.0, seed=0, device=CPU)
        rho_before = net.layers[0].w_rho.detach().clone()
        net.fit(x, 2 * x, n_epochs=30, batch_size=32, learning_rate=0.05, kl_weight=0.01)
        assert not torch.allclose(rho_before, net.layers[0].w_rho.detach())

    def test_sample_posterior(self):
        net = BayesianNetwork([2, 4, 1], seed=0, device=CPU)
        posts = net.sample_posterior(3)
        assert len(posts) == 3 and posts[0].weights[0].shape == (2, 4)
        # The reference's quirk: each sample's energy is the KL to the prior.
        assert posts[0].energy == pytest.approx(float(ml.kl_to_prior(net.params, 1.0)))

    def test_compute_loss(self):
        net = BayesianNetwork([1, 4, 1], seed=0, device=CPU)
        total, data, kl = net.compute_loss(np.ones((3, 1)), np.zeros(3), kl_weight=0.1, n_mc=2)
        assert total == pytest.approx(data + 0.1 * kl / 3, rel=1e-5)

    def test_default_device_is_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(ConfigurationError):
            BayesianNetwork([1, 4, 1])
        with pytest.raises(ConfigurationError):
            AnchoredEnsembleRegressor(1, [4])


class TestBayesianRegressor:
    def test_fit_predict_interval(self):
        rng = np.random.default_rng(2)
        x = np.linspace(-1, 1, 80)[:, None].astype(np.float32)
        y = (x**2 + 0.05 * rng.normal(size=x.shape)).astype(np.float32)
        reg = BayesianRegressor(1, [16], temperature=0.1, seed=0, device=CPU)
        reg.fit(x, y, n_epochs=80, learning_rate=0.02, kl_weight=1e-4)
        mean, lo, hi = reg.predict_with_interval(x, n_samples=50)
        assert np.all(lo <= hi)
        _, lo99, hi99 = reg.predict_with_interval(x, n_samples=50, confidence=0.99)
        assert np.mean(hi99 - lo99) >= np.mean(hi - lo) * 0.8

    def test_interval_covers_training_data(self):
        x = np.linspace(-1, 1, 60)[:, None].astype(np.float32)
        y = np.sin(2 * x).astype(np.float32)
        reg = BayesianRegressor(1, [32], temperature=0.3, seed=1, device=CPU)
        reg.fit(x, y, n_epochs=150, learning_rate=0.02, kl_weight=1e-5)
        mean, lo, hi = reg.predict_with_interval(x, n_samples=100, confidence=0.95)
        assert np.mean((y >= lo) & (y <= hi)) > 0.6

    def test_select_informative_samples(self):
        reg = BayesianRegressor(1, [8], seed=0, device=CPU)
        x_train = np.linspace(-0.2, 0.2, 30)[:, None].astype(np.float32)
        reg.fit(x_train, 2 * x_train, n_epochs=40, learning_rate=0.02, kl_weight=1e-4)
        pool = np.linspace(-3, 3, 50)[:, None].astype(np.float32)
        idx = reg.select_informative_samples(pool, n_select=5)
        assert len(idx) == 5 and np.mean(np.abs(pool[idx])) > np.mean(np.abs(pool))

    def test_single_sample_batch(self):
        reg = BayesianRegressor(2, [4], seed=0, device=CPU)
        assert reg.predict(np.ones((1, 2)), n_samples=10).mean.shape == (1, 1)


class TestObservationNoise:
    def test_sigma_n_recovers_true_noise(self):
        rng = np.random.default_rng(4)
        x = rng.uniform(-1, 1, (200, 1)).astype(np.float32)
        y = (np.sin(3 * x) + 0.2 * rng.normal(size=x.shape)).astype(np.float32)
        reg = BayesianRegressor(1, [32, 32], seed=0, device=CPU)
        reg.fit(x, y, n_epochs=600, batch_size=200, learning_rate=0.01, kl_weight=0.1)
        assert 0.1 < float(reg.observation_noise_std[0]) < 0.35  # true scale 0.2

    def test_predictive_interval_calibrated(self):
        rng = np.random.default_rng(5)
        x = rng.uniform(-1, 1, (150, 1)).astype(np.float32)
        y = (x**2 + 0.15 * rng.normal(size=x.shape)).astype(np.float32)
        reg = BayesianRegressor(1, [32, 32], seed=0, device=CPU)
        reg.fit(x, y, n_epochs=600, batch_size=150, learning_rate=0.01, kl_weight=0.1)
        x_test = np.linspace(-1, 1, 200)[:, None].astype(np.float32)
        y_test = x_test**2 + 0.15 * rng.normal(size=x_test.shape)
        mean, lo, hi = reg.predict_with_interval(x_test, n_samples=200,
                                                 include_observation_noise=True)
        assert 0.88 <= np.mean((y_test >= lo) & (y_test <= hi)) <= 1.0

    def test_noise_learning_optional(self):
        net = BayesianNetwork([1, 4, 1], seed=0, learn_observation_noise=False, device=CPU)
        assert net.observation_noise_std is None
        x = np.linspace(-1, 1, 32)[:, None].astype(np.float32)
        net.fit(x, 2 * x, n_epochs=20, batch_size=32, learning_rate=0.02)
        assert net.log_noise is None


class TestAnchoredEnsemble:
    def _toy(self, seed=2, n_train=80):
        rng = np.random.default_rng(seed)
        x = rng.uniform(-1, 1, (n_train, 1)).astype(np.float32)
        y = (x**3 + 0.05 * rng.normal(size=x.shape)).astype(np.float32)
        return x, y, rng

    def test_validation(self):
        with pytest.raises(ConfigurationError):
            AnchoredEnsembleRegressor(1, [8], n_members=1, device=CPU)
        with pytest.raises(ConfigurationError):
            AnchoredEnsembleRegressor(1, [8], activation="nope", device=CPU)

    def test_fit_reduces_loss_and_predict_shapes(self):
        x, y, _ = self._toy()
        reg = AnchoredEnsembleRegressor(1, [16], n_members=4, seed=0, device=CPU)
        reg.fit(x, y, n_epochs=300)
        assert reg.loss_history[-1] < reg.loss_history[0]
        res = reg.predict(np.linspace(-1, 1, 7)[:, None].astype(np.float32))
        assert res.samples.shape == (4, 7, 1) and res.mean.shape == (7, 1)
        mean, lo, hi = reg.predict_with_interval(x[:5])
        assert np.all(lo <= mean) and np.all(mean <= hi)

    def test_ood_uncertainty_reverts_to_prior(self):
        x, y, _ = self._toy()
        reg = AnchoredEnsembleRegressor(1, [32, 32], n_members=6, seed=0, device=CPU)
        reg.fit(x, y, n_epochs=1200)
        x_test = np.linspace(-3, 3, 61)[:, None].astype(np.float32)
        std = reg.predict(x_test).std.ravel()
        in_d = std[np.abs(x_test.ravel()) <= 1.0].mean()
        out_d = std[np.abs(x_test.ravel()) > 2.5].mean()
        assert out_d > 5.0 * in_d and out_d > 2.0

    def test_extrapolation_coverage_in_band(self):
        x, y, rng = self._toy()
        x_test = np.linspace(-3, 3, 200)[:, None].astype(np.float32)
        y_test = x_test**3 + 0.05 * rng.normal(size=x_test.shape)
        reg = AnchoredEnsembleRegressor(1, [32, 32], n_members=8, seed=0, device=CPU)
        reg.fit(x, y, n_epochs=2000)
        mean, lo, hi = reg.predict_with_interval(x_test, confidence=0.95)
        assert 0.88 <= np.mean((y_test >= lo) & (y_test <= hi)) <= 1.0

    def test_active_learning_prefers_ood(self):
        x, y, _ = self._toy()
        reg = AnchoredEnsembleRegressor(1, [16], n_members=4, seed=0, device=CPU)
        reg.fit(x, y, n_epochs=300)
        pool = np.linspace(-3, 3, 25)[:, None].astype(np.float32)
        picked = reg.select_informative_samples(pool, 4)
        assert np.all(np.abs(pool[picked].ravel()) > 1.5)


class TestBNNPosteriorMCMC:
    def test_predict_mcmc_interface(self):
        rng = np.random.default_rng(1)
        x = rng.uniform(-1, 1, (30, 1)).astype(np.float32)
        y = np.sin(2 * x).astype(np.float32)
        reg = BayesianRegressor(1, [8], seed=0, device=CPU)
        reg.fit(x, y, n_epochs=100, batch_size=30)
        x_test = np.linspace(-1, 1, 9)[:, None].astype(np.float32)
        res = reg.predict_mcmc(x, y, x_test, n_samples=64, n_chains=4, n_burnin=300)
        assert res.mean.shape == (9, 1) and res.samples.shape == (64, 9, 1)
        assert np.all(res.std >= 0) and np.all(np.isfinite(res.samples))
