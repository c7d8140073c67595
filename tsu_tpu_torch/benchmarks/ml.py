"""ML benchmarks: BNN regression quality and calibration.

Counterpart of ``tsu_tpu/benchmarks/ml.py``, with its tasks, sizes, seeds
and result keys: sinusoid, heteroscedastic noise and extrapolation, and the
full-Bayes MALA row. Metrics: MSE, R^2, expected calibration error (ECE),
95% interval coverage, Gaussian NLL and the extrapolation uncertainty
ratio. ``routes`` records each row's loop route ("graph" when every loop
of the row replayed CUDA graphs).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from tsu_tpu_torch.models.ml import AnchoredEnsembleRegressor, BayesianRegressor


@dataclass
class MLResult:
    """One ML benchmark outcome."""

    name: str
    mse: float
    r2: float
    ece: float
    coverage_95: float
    nll: float
    time_elapsed: float
    extra: Dict = field(default_factory=dict)

    def summary(self) -> dict:
        return {
            "name": self.name,
            "mse": round(self.mse, 4),
            "r2": round(self.r2, 4),
            "ece": round(self.ece, 4),
            "coverage_95": round(self.coverage_95, 3),
            "nll": round(self.nll, 4),
            "time_s": round(self.time_elapsed, 2),
            **self.extra,
        }


def expected_calibration_error(y_true, mean, std, n_bins: int = 10) -> float:
    """ECE over central-interval confidence levels."""
    from scipy import stats

    y_true = np.asarray(y_true).ravel()
    mean = np.asarray(mean).ravel()
    std = np.maximum(np.asarray(std).ravel(), 1e-8)
    levels = np.linspace(0.05, 0.95, n_bins)
    ece = 0.0
    for p in levels:
        z = stats.norm.ppf(0.5 + p / 2)
        observed = np.mean(np.abs(y_true - mean) <= z * std)
        ece += abs(observed - p)
    return float(ece / n_bins)


def gaussian_nll(y_true, mean, std) -> float:
    y_true = np.asarray(y_true).ravel()
    mean = np.asarray(mean).ravel()
    std = np.maximum(np.asarray(std).ravel(), 1e-6)
    return float(np.mean(0.5 * np.log(2 * np.pi * std**2)
                         + (y_true - mean) ** 2 / (2 * std**2)))


def joint_route(*routes) -> str:
    """"graph" when every loop replayed graphs, else "eager"."""
    return "graph" if all(r == "graph" for r in routes) else "eager"


class MLBenchmark:
    """BNN regression benchmark suite on ``device`` (default the card)."""

    def __init__(self, seed: int = 0, device=None):
        self.seed = seed
        self.device = device
        self.results: List[MLResult] = []
        self.routes: Dict[str, str] = {}

    def _evaluate(self, name, reg, x_test, y_test, t_elapsed, extra=None, res=None) -> MLResult:
        """Calibration against held-out noisy observations: the interval is
        the predictive one, the weight posterior's spread plus the learned
        aleatoric scale sigma_n. ``res``: a precomputed
        :class:`PredictionResult` (the MCMC row's)."""
        if res is None:
            res = reg.predict(x_test, n_samples=200)
        mean = res.mean.ravel()
        sig_n = reg.observation_noise_std
        sig_n = float(sig_n[0]) if sig_n is not None else 0.0
        std = np.sqrt(res.std.ravel() ** 2 + sig_n**2)
        y = np.asarray(y_test).ravel()
        mse = float(np.mean((mean - y) ** 2))
        var = float(np.var(y))
        r2 = 1.0 - mse / var if var > 0 else 0.0
        lo, hi = mean - 1.96 * std, mean + 1.96 * std
        result = MLResult(
            name=name,
            mse=mse,
            r2=r2,
            ece=expected_calibration_error(y, mean, std),
            coverage_95=float(np.mean((y >= lo) & (y <= hi))),
            nll=gaussian_nll(y, mean, std),
            time_elapsed=t_elapsed,
            extra={"sigma_n": round(sig_n, 4), **(extra or {})},
        )
        self.results.append(result)
        return result

    def _vi_row(self, name, x, y, x_test, y_test, n_epochs) -> MLResult:
        reg = BayesianRegressor(1, [32, 32], seed=self.seed, device=self.device)
        t0 = time.perf_counter()
        reg.fit(x, y, n_epochs=n_epochs, batch_size=len(x), learning_rate=0.01, kl_weight=0.1)
        fit_route = reg.last_route
        result = self._evaluate(name, reg, x_test, y_test, time.perf_counter() - t0)
        self.routes[name] = joint_route(fit_route, reg.last_route)
        return result

    def benchmark_sinusoid(self, n_train: int = 100, n_epochs: int = 200) -> MLResult:
        """y = sin(3x) + noise."""
        rng = np.random.default_rng(self.seed)
        x = rng.uniform(-1, 1, (n_train, 1)).astype(np.float32)
        y = (np.sin(3 * x) + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        x_test = np.linspace(-1, 1, 200)[:, None].astype(np.float32)
        y_test = (np.sin(3 * x_test) + 0.1 * rng.normal(size=x_test.shape)).astype(np.float32)
        return self._vi_row("sinusoid", x, y, x_test, y_test, n_epochs)

    def benchmark_heteroscedastic(self, n_train: int = 150, n_epochs: int = 200) -> MLResult:
        """Noise grows with |x|."""
        rng = np.random.default_rng(self.seed + 1)
        x = rng.uniform(-2, 2, (n_train, 1)).astype(np.float32)
        y = (0.5 * x**2 + np.abs(x) * 0.3 * rng.normal(size=x.shape)).astype(np.float32)
        x_test = np.linspace(-2, 2, 200)[:, None].astype(np.float32)
        y_test = (0.5 * x_test**2
                  + np.abs(x_test) * 0.3 * rng.normal(size=x_test.shape)).astype(np.float32)
        return self._vi_row("heteroscedastic", x, y, x_test, y_test, n_epochs)

    def benchmark_sinusoid_mcmc(self, n_train: int = 100, n_epochs: int = 800,
                                quick: bool = False) -> MLResult:
        """Full-Bayes row: MALA over the exact weight posterior
        (``predict_mcmc``) on the sinusoid split, from a VI fit's means and
        learned noise. ``quick=True`` runs the scaled-down variant (one
        16-unit hidden layer, 300 VI epochs, 8 chains, 800 burn-in, 128
        draws), marked ``indicative_only``."""
        rng = np.random.default_rng(self.seed)
        x = rng.uniform(-1, 1, (n_train, 1)).astype(np.float32)
        y = (np.sin(3 * x) + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        x_test = np.linspace(-1, 1, 200)[:, None].astype(np.float32)
        y_test = (np.sin(3 * x_test) + 0.1 * rng.normal(size=x_test.shape)).astype(np.float32)
        hidden = [16] if quick else [32, 32]
        reg = BayesianRegressor(1, hidden, seed=self.seed, device=self.device)
        t0 = time.perf_counter()
        reg.fit(x, y, n_epochs=300 if quick else n_epochs, batch_size=n_train,
                learning_rate=0.01, kl_weight=0.1)
        fit_route = reg.last_route
        res = reg.predict_mcmc(x, y, x_test, n_samples=128 if quick else 512,
                               n_chains=8 if quick else 16, n_burnin=800 if quick else 3000)
        elapsed = time.perf_counter() - t0
        extra = {"estimator": "mala_full_bayes", "n_posterior_draws": int(res.samples.shape[0])}
        if quick:
            extra["indicative_only"] = True
        name = "sinusoid_mcmc_quick" if quick else "sinusoid_mcmc"
        self.routes[name] = joint_route(fit_route, reg.last_route)
        return self._evaluate(name, reg, x_test, y_test, elapsed, res=res, extra=extra)

    def benchmark_extrapolation(self, n_train: int = 80, n_epochs: int = 2000) -> MLResult:
        """Train on [-1, 1], test on [-3, 3]: uncertainty must grow out of
        distribution. Estimator: an anchored ensemble of 8 (randomized-MAP
        posterior sampling), whose OOD predictive reverts to the prior's."""
        rng = np.random.default_rng(self.seed + 2)
        x = rng.uniform(-1, 1, (n_train, 1)).astype(np.float32)
        y = (x**3 + 0.05 * rng.normal(size=x.shape)).astype(np.float32)
        x_test = np.linspace(-3, 3, 200)[:, None].astype(np.float32)
        y_test = (x_test**3 + 0.05 * rng.normal(size=x_test.shape)).astype(np.float32)
        reg = AnchoredEnsembleRegressor(1, [32, 32], n_members=8, seed=self.seed,
                                        device=self.device)
        t0 = time.perf_counter()
        reg.fit(x, y, n_epochs=n_epochs, learning_rate=0.01)
        elapsed = time.perf_counter() - t0
        self.routes["extrapolation"] = reg.last_route
        res = reg.predict(x_test)
        std = res.std.ravel()
        in_dist = std[np.abs(x_test.ravel()) <= 1.0].mean()
        out_dist = std[np.abs(x_test.ravel()) > 2.0].mean()
        return self._evaluate(
            "extrapolation", reg, x_test, y_test, elapsed,
            extra={"uncertainty_ratio": round(float(out_dist / max(in_dist, 1e-8)), 2),
                   "estimator": "anchored_ensemble_8"},
        )

    def run_all_benchmarks(self, quick: bool = False) -> List[MLResult]:
        # The ensemble row keeps its full budget in quick mode too:
        # under-trained members sit away from their anchors, which skews
        # OOD coverage. The full-Bayes row runs its scaled-down variant in
        # quick mode.
        epochs = 500 if quick else 800
        self.benchmark_sinusoid(n_epochs=epochs)
        self.benchmark_heteroscedastic(n_epochs=epochs)
        self.benchmark_extrapolation(n_epochs=2000)
        self.benchmark_sinusoid_mcmc(quick=quick)
        return self.results
