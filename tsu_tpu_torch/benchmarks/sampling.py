"""Sampling-quality benchmarks.

Counterpart of ``tsu_tpu/benchmarks/sampling.py``, with its tasks, sizes,
seeds and result keys: uniform-binary, ferromagnetic Boltzmann chain,
bimodal ferromagnet. Metrics: KL divergence against the enumerated target,
Geyer ESS, moment z-scores and throughput in samples/s and bit-flips/s.
``routes`` records each row's ``GibbsSampler.last_route``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from tsu_tpu_torch.config import GibbsConfig
from tsu_tpu_torch.ops.stats import (
    ess_multichain,
    kl_divergence_calibrated,
    kl_divergence_discrete,
    moment_zscores,
)
from tsu_tpu_torch.oracle import exact_boltzmann_moments
from tsu_tpu_torch.samplers.gibbs import GibbsSampler


@dataclass
class SamplingResult:
    """One sampling benchmark outcome."""

    name: str
    n_samples: int
    n_bits: int
    kl_divergence: float
    ess: float
    time_elapsed: float
    samples_per_second: float
    bit_flips_per_second: float
    extra: Dict = field(default_factory=dict)

    def summary(self) -> dict:
        return {
            "name": self.name,
            "n_samples": self.n_samples,
            "n_bits": self.n_bits,
            "kl_divergence": round(self.kl_divergence, 6),
            "ess": round(self.ess, 1),
            "time_s": round(self.time_elapsed, 4),
            "samples_per_s": round(self.samples_per_second, 1),
            "bit_flips_per_s": round(self.bit_flips_per_second, 1),
            **self.extra,
        }


def _state_histogram(samples: np.ndarray) -> np.ndarray:
    """Empirical distribution over all 2^n binary states (n small)."""
    n = samples.shape[1]
    idx = samples.astype(np.int64) @ (1 << np.arange(n, dtype=np.int64))
    return np.bincount(idx, minlength=1 << n) / samples.shape[0]


def _exact_distribution(J, h, temperature) -> np.ndarray:
    """Exact Boltzmann probabilities over all 2^n bit states."""
    import itertools

    n = J.shape[0]
    states = np.array(list(itertools.product([0.0, 1.0], repeat=n)))
    E = -0.5 * np.einsum("ki,ij,kj->k", states, J, states) - states @ h
    logw = -E / temperature
    logw -= logw.max()
    w = np.exp(logw)
    # bincount index convention: bit i has weight 2^i.
    idx = states.astype(np.int64) @ (1 << np.arange(n, dtype=np.int64))
    p = np.zeros(1 << n)
    p[idx.astype(int)] = w
    return p / p.sum()


class SamplingBenchmark:
    """Sampling benchmark suite on ``device`` (default the card)."""

    def __init__(self, seed: int = 0, n_chains: int = 32, device=None):
        self.seed = seed
        self.n_chains = n_chains
        self.device = device
        self.results: List[SamplingResult] = []
        self.routes: Dict[str, str] = {}

    def _run_case(self, name, J, h, n_samples, temperature=1.0,
                  n_burnin=100, n_sweeps=2,
                  update_order="sequential") -> SamplingResult:
        """``update_order`` defaults to "sequential", which on these tiny
        (n <= 10) problems takes the native host sampler (only the
        sequential and random orders may); all orders share the invariant
        distribution."""
        n = J.shape[0]
        sampler = GibbsSampler(
            GibbsConfig(temperature=temperature, n_burnin=n_burnin,
                        n_sweeps=n_sweeps, n_chains=self.n_chains,
                        update_order=update_order),
            seed=self.seed, device=self.device,
        )
        # A warm-up call with the same shapes keeps first-call costs (graph
        # capture, builds) out of the timed runs; throughput is the best of
        # 3 with the median beside it.
        t_w = time.perf_counter()
        sampler.sample_boltzmann(J, bias=h, n_samples=n_samples)
        warmup = time.perf_counter() - t_w
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            samples = sampler.sample_boltzmann(J, bias=h, n_samples=n_samples)
            times.append(time.perf_counter() - t0)
        self.routes[name] = sampler.last_route
        elapsed = min(times)
        median_elapsed = sorted(times)[len(times) // 2]

        q_exact = _exact_distribution(J, h, temperature)
        counts = _state_histogram(samples) * samples.shape[0]
        kl = kl_divergence_calibrated(counts, q_exact, seed=self.seed)
        kl_plugin = kl_divergence_discrete(counts / samples.shape[0], q_exact)
        n_full = (n_samples // self.n_chains) * self.n_chains
        if n_full >= self.n_chains:
            chains = samples[:n_full].reshape(-1, self.n_chains, n).transpose(1, 0, 2)
        else:
            chains = samples[None]
        ess = ess_multichain(chains)
        # Site-mean errors against enumeration in MC standard errors (no
        # small-sample bias floor, unlike KL).
        zs = moment_zscores(samples, exact_boltzmann_moments(J, h, temperature)["mean"],
                            ess)
        result = SamplingResult(
            name=name,
            n_samples=n_samples,
            n_bits=n,
            kl_divergence=kl,
            ess=ess,
            time_elapsed=elapsed,
            samples_per_second=n_samples / elapsed,
            bit_flips_per_second=n_samples * n_sweeps * n / elapsed,
            extra={
                "kl_plugin": round(kl_plugin, 6),
                "max_abs_z": round(zs["max_abs_z"], 2),
                "mean_abs_z": round(zs["mean_abs_z"], 2),
                "max_z_null_p": round(zs["max_z_null_p"], 3),
                "warmup_time_s": round(warmup, 4),
                "median_time_s": round(median_elapsed, 4),
                "median_samples_per_s": round(n_samples / median_elapsed, 1),
            },
        )
        self.results.append(result)
        return result

    def benchmark_uniform_binary(self, n_samples: int = 10_000) -> SamplingResult:
        """dim=1 unbiased bit: target Bernoulli(1/2)."""
        J = np.zeros((1, 1), np.float32)
        h = np.zeros(1, np.float32)
        return self._run_case("uniform_binary", J, h, n_samples, n_sweeps=1,
                              n_burnin=10)

    def benchmark_boltzmann_chain(self, n_spins: int = 10,
                                  n_samples: int = 2_000) -> SamplingResult:
        """Ferromagnetic chain."""
        J = np.zeros((n_spins, n_spins), np.float32)
        for i in range(n_spins - 1):
            J[i, i + 1] = J[i + 1, i] = 1.0
        h = np.zeros(n_spins, np.float32)
        return self._run_case("boltzmann_chain", J, h, n_samples)

    def benchmark_ferromagnet_bimodal(self, n_spins: int = 10,
                                      n_samples: int = 20_000) -> SamplingResult:
        """Fully-connected ferromagnet: bimodal all-up/all-down, the hardest
        row (the modes autocorrelate the chains), hence 20k samples."""
        J = np.full((n_spins, n_spins), 0.35, np.float32)
        np.fill_diagonal(J, 0.0)
        h = np.full(n_spins, -0.35 * (n_spins - 1) / 2, np.float32)
        # Bias centers the bit model so both modes are equally likely
        # (equivalent to a zero-field spin ferromagnet).
        res = self._run_case("ferromagnet_bimodal", J, h, n_samples,
                             n_burnin=200, n_sweeps=3)
        return res

    def run_all_benchmarks(self, quick: bool = False) -> List[SamplingResult]:
        scale = 5 if quick else 1
        self.benchmark_uniform_binary(10_000 // scale)
        self.benchmark_boltzmann_chain(10, 2_000 // scale)
        # The bimodal row keeps a 20k/4k budget: its z-gate needs the
        # larger sample to hold a statistical margin.
        self.benchmark_ferromagnet_bimodal(10, 20_000 // scale)
        return self.results
