"""Framework comparisons.

Counterpart of ``tsu_tpu/benchmarks/comparison.py``, with its rows, sizes,
seeds and result keys:

1. Sampling: this engine vs direct NumPy vs Metropolis-Hastings on a binary
   Boltzmann target, KL and wall time per method.
2. Optimization: simulated annealing vs random search vs greedy under a
   shared time budget on MAX-CUT.
3. Multi-trial Gibbs vs Metropolis-Hastings KL with a paired t-test.

``routes`` records the route of each engine row.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from tsu_tpu_torch.benchmarks.sampling import _exact_distribution, _state_histogram
from tsu_tpu_torch.config import GibbsConfig
from tsu_tpu_torch.ops.stats import kl_divergence_calibrated
from tsu_tpu_torch.samplers.annealing import takes_native
from tsu_tpu_torch.samplers.gibbs import GibbsSampler


def _kl(samples, exact):
    """Bootstrap-calibrated KL from samples (the plug-in estimator's bias
    floor swamps the signal at quick sizes)."""
    counts = _state_histogram(samples) * samples.shape[0]
    return kl_divergence_calibrated(counts, exact)


@dataclass
class ComparisonResult:
    """One comparison row."""

    name: str
    method: str
    metric: float
    metric_name: str
    time_elapsed: float
    extra: Dict = field(default_factory=dict)

    def summary(self) -> dict:
        return {
            "name": self.name,
            "method": self.method,
            self.metric_name: round(self.metric, 6),
            "time_ms": round(self.time_elapsed * 1e3, 2),
            **self.extra,
        }


def _metropolis_bits(rng, J, h, n_samples, temperature=1.0, n_burnin=500):
    """Single-flip Metropolis baseline."""
    n = J.shape[0]
    state = (rng.random(n) < 0.5).astype(np.float64)

    def energy(b):
        return -0.5 * b @ J @ b - h @ b

    e = energy(state)
    out = np.empty((n_samples, n))
    total = n_burnin + n_samples
    for t in range(total):
        i = rng.integers(n)
        state[i] = 1 - state[i]
        e_new = energy(state)
        if np.log(rng.random()) < (e - e_new) / temperature:
            e = e_new
        else:
            state[i] = 1 - state[i]
        if t >= n_burnin:
            out[t - n_burnin] = state
    return out


class ComparisonBenchmark:
    """Method comparison suite on ``device`` (default the card)."""

    def __init__(self, seed: int = 0, device=None):
        self.seed = seed
        self.device = device
        self.results: List[ComparisonResult] = []
        self.routes: Dict[str, str] = {}

    def compare_sampling_methods(self, n_bits: int = 10,
                                 n_samples: int = 2_000) -> List[ComparisonResult]:
        rng = np.random.default_rng(self.seed)
        J = rng.normal(0, 0.4, (n_bits, n_bits))
        J = ((J + J.T) / 2).astype(np.float32)
        np.fill_diagonal(J, 0)
        h = rng.normal(0, 0.3, n_bits).astype(np.float32)
        exact = _exact_distribution(J, h, 1.0)
        rows = []

        # This engine (colour sweeps). The warm-up keeps first-call costs
        # out of the comparison (steady state, like the NumPy baselines).
        sampler = GibbsSampler(GibbsConfig(n_burnin=100, n_sweeps=2,
                                           n_chains=32,
                                           update_order="checkerboard"),
                               seed=self.seed, device=self.device)
        sampler.sample_boltzmann(J, bias=h, n_samples=n_samples)
        t0 = time.perf_counter()
        s = sampler.sample_boltzmann(J, bias=h, n_samples=n_samples)
        t_tsu = time.perf_counter() - t0
        self.routes["sampling/tsu_tpu_gibbs"] = sampler.last_route
        rows.append(ComparisonResult(
            "sampling", "tsu_tpu_gibbs",
            _kl(s, exact),
            "kl_divergence", t_tsu,
        ))

        # Direct (exact) sampling from the enumerated distribution.
        t0 = time.perf_counter()
        idx = rng.choice(len(exact), size=n_samples, p=exact)
        direct = ((idx[:, None] >> np.arange(n_bits)) & 1).astype(np.float64)
        t_direct = time.perf_counter() - t0
        rows.append(ComparisonResult(
            "sampling", "direct_numpy",
            _kl(direct, exact),
            "kl_divergence", t_direct,
        ))

        # Metropolis-Hastings.
        t0 = time.perf_counter()
        mh = _metropolis_bits(rng, J.astype(np.float64), h.astype(np.float64),
                              n_samples)
        t_mh = time.perf_counter() - t0
        rows.append(ComparisonResult(
            "sampling", "metropolis_hastings",
            _kl(mh, exact),
            "kl_divergence", t_mh,
        ))

        self.results.extend(rows)
        return rows

    def compare_optimization_methods(self, n_nodes: int = 20,
                                     time_budget_s: float = 2.0) -> List[ComparisonResult]:
        from tsu_tpu_torch.api import MaxCutProblem, optimize
        from tsu_tpu_torch.benchmarks.optimization import greedy_maxcut_bound

        rng = np.random.default_rng(self.seed + 1)
        W = (rng.random((n_nodes, n_nodes)) < 0.5).astype(np.float32)
        W = np.triu(W, 1)
        W = W + W.T
        problem = MaxCutProblem(W)
        rows = []

        # Warm-up: the comparison is steady-state SA vs the NumPy baselines.
        optimize(problem, n_steps=500, n_chains=16, seed=self.seed, device=self.device)
        t0 = time.perf_counter()
        out = optimize(problem, n_steps=500, n_chains=16, seed=self.seed, device=self.device)
        t_sa = time.perf_counter() - t0
        self.routes["optimization/simulated_annealing"] = (
            "native_cpp" if takes_native(n_nodes, 500, 16) else "device")
        rows.append(ComparisonResult(
            "optimization", "simulated_annealing",
            problem.cut_value(out["best_solution"]), "cut_value", t_sa,
        ))

        # Random search under the SA time budget (at least 200 tries).
        t0 = time.perf_counter()
        best = 0.0
        tries = 0
        while time.perf_counter() - t0 < min(t_sa, time_budget_s) or tries < 200:
            s = rng.choice([-1.0, 1.0], n_nodes)
            best = max(best, problem.cut_value(s))
            tries += 1
            if tries > 100_000:
                break
        rows.append(ComparisonResult(
            "optimization", "random_search", best, "cut_value",
            time.perf_counter() - t0, extra={"tries": tries},
        ))

        t0 = time.perf_counter()
        greedy = greedy_maxcut_bound(W, seed=self.seed)
        rows.append(ComparisonResult(
            "optimization", "greedy_local_search", greedy, "cut_value",
            time.perf_counter() - t0,
        ))

        self.results.extend(rows)
        return rows

    def run_trials(self, n_trials: int = 5, n_bits: int = 8,
                   n_samples: int = 1_000) -> dict:
        """Multi-trial statistical comparison: repeats the Gibbs-vs-MH KL comparison over ``n_trials`` independent
        instances and reports mean±std, win rate, and a paired t-test.
        """
        from scipy import stats

        rng = np.random.default_rng(self.seed + 7)
        kl_gibbs, kl_mh = [], []
        for trial in range(n_trials):
            J = rng.normal(0, 0.4, (n_bits, n_bits))
            J = ((J + J.T) / 2).astype(np.float32)
            np.fill_diagonal(J, 0)
            h = rng.normal(0, 0.3, n_bits).astype(np.float32)
            exact = _exact_distribution(J, h, 1.0)

            sampler = GibbsSampler(
                GibbsConfig(n_burnin=100, n_sweeps=2, n_chains=16,
                            update_order="checkerboard"),
                seed=self.seed + trial, device=self.device,
            )
            s = sampler.sample_boltzmann(J, bias=h, n_samples=n_samples)
            self.routes["multi_trial/gibbs"] = sampler.last_route
            kl_gibbs.append(_kl(s, exact))

            mh = _metropolis_bits(rng, J.astype(np.float64),
                                  h.astype(np.float64), n_samples)
            kl_mh.append(_kl(mh, exact))

        kl_gibbs = np.asarray(kl_gibbs)
        kl_mh = np.asarray(kl_mh)
        t_stat, p_value = stats.ttest_rel(kl_gibbs, kl_mh)
        return {
            "n_trials": n_trials,
            "kl_gibbs_mean": float(kl_gibbs.mean()),
            "kl_gibbs_std": float(kl_gibbs.std()),
            "kl_mh_mean": float(kl_mh.mean()),
            "kl_mh_std": float(kl_mh.std()),
            "gibbs_win_rate": float(np.mean(kl_gibbs < kl_mh)),
            "t_statistic": float(t_stat),
            "p_value": float(p_value),
        }

    def run_all_comparisons(self, quick: bool = False) -> List[ComparisonResult]:
        self.compare_sampling_methods(n_samples=500 if quick else 2_000)
        self.compare_optimization_methods(time_budget_s=0.5 if quick else 2.0)
        trials = self.run_trials(n_trials=3 if quick else 5)
        self.results.append(ComparisonResult(
            name="multi_trial", method="gibbs_vs_mh",
            metric=trials["gibbs_win_rate"], metric_name="gibbs_win_rate",
            time_elapsed=0.0,
            extra={k: round(v, 5) if isinstance(v, float) else v
                   for k, v in trials.items()},
        ))
        return self.results
