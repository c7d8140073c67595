"""Sampling diagnostics: autocorrelation, effective sample size, moments.

Counterpart of ``tsu_tpu/ops/stats.py``: the Geyer initial-positive-sequence
ESS (FFT autocorrelation), the plug-in, Miller-Madow and bootstrap-calibrated
KL estimators and moment z-scores, in numpy as in the reference; only
``running_moments`` is a reduction on a tensor's device.
"""

from __future__ import annotations

import numpy as np
import torch


def autocorrelation(x: np.ndarray, max_lag: int | None = None) -> np.ndarray:
    """Normalized autocorrelation function of a 1-D chain via FFT."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    if max_lag is None:
        max_lag = n - 1
    x = x - x.mean()
    # FFT autocorrelation with zero padding to avoid circular wrap.
    m = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, m)
    acf = np.fft.irfft(f * np.conj(f), m)[: n]
    if acf[0] == 0:
        return np.zeros(min(max_lag + 1, n))
    acf /= acf[0]
    return acf[: max_lag + 1]


def effective_sample_size(x: np.ndarray) -> float:
    """Geyer initial-positive-sequence ESS for a 1-D chain.

    ESS = N / (1 + 2 * sum_k rho_k) where the sum runs over pairs
    Gamma_m = rho_{2m} + rho_{2m+1} truncated at the first negative pair.
    """
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    if n < 4 or np.std(x) == 0:
        return float(n)
    rho = autocorrelation(x)
    # Pair consecutive lags starting at lag 1: (1,2), (3,4), ...
    pair_sum = 0.0
    m = 1
    while m + 1 < n:
        gamma = rho[m] + rho[m + 1]
        if gamma < 0:
            break
        pair_sum += gamma
        m += 2
    ess = n / (1.0 + 2.0 * pair_sum)
    return float(np.clip(ess, 1.0, n))


def ess_multichain(samples: np.ndarray) -> float:
    """Mean per-dimension ESS over a (n_samples, dim) array, summed over chains
    if a leading chain axis is present ((chains, n_samples, dim))."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        return effective_sample_size(samples)
    if samples.ndim == 2:
        return float(np.mean([effective_sample_size(samples[:, d])
                              for d in range(samples.shape[1])]))
    return float(
        sum(ess_multichain(samples[c]) for c in range(samples.shape[0]))
    )


def kl_divergence_discrete(p: np.ndarray, q: np.ndarray, eps: float = 1e-12) -> float:
    """KL(p || q) for discrete distributions (benchmark metric)."""
    p = np.asarray(p, dtype=np.float64) + eps
    q = np.asarray(q, dtype=np.float64) + eps
    p /= p.sum()
    q /= q.sum()
    return float(np.sum(p * np.log(p / q)))


def kl_divergence_corrected(counts: np.ndarray, q: np.ndarray,
                            eps: float = 1e-12) -> float:
    """Miller-Madow bias-corrected KL(p_hat || q) from raw counts.

    The plug-in estimator underestimates the entropy of p by about
    (K_hat - 1) / (2 N) nats (K_hat = observed support size), which inflates
    KL by the same amount — at 400 samples over 2^10 states the inflation is
    ~0.8 nats, drowning the signal. The cross-entropy term is unbiased, so subtracting the entropy
    correction debiases the KL. Clipped at zero.
    """
    counts = np.asarray(counts, dtype=np.float64)
    n = counts.sum()
    k_hat = np.count_nonzero(counts)
    kl = kl_divergence_discrete(counts / n, q, eps)
    return float(max(0.0, kl - (k_hat - 1) / (2.0 * n)))


def kl_divergence_calibrated(counts: np.ndarray, q: np.ndarray,
                             n_boot: int = 20, seed: int = 0,
                             eps: float = 1e-12) -> float:
    """Bootstrap-calibrated KL(p_hat || q): plug-in KL minus the expected
    plug-in KL of *exact* same-size draws from q.

    The parametric bootstrap removes the finite-sample bias to all orders in
    expectation (Miller-Madow only removes the first-order (K-1)/2N term,
    which at 400 samples over 2^10 states still leaves ~0.3 nats). An exact
    sampler scores ~0 by construction; any excess is genuine distribution
    mismatch. Clipped at zero.
    """
    counts = np.asarray(counts, dtype=np.float64)
    n = int(counts.sum())
    q = np.asarray(q, dtype=np.float64)
    q = q / q.sum()
    kl = kl_divergence_discrete(counts / n, q, eps)
    rng = np.random.default_rng(seed)
    boot = [
        kl_divergence_discrete(
            np.bincount(rng.choice(len(q), size=n, p=q), minlength=len(q)) / n,
            q, eps,
        )
        for _ in range(n_boot)
    ]
    return float(max(0.0, kl - np.mean(boot)))


def moment_zscores(samples: np.ndarray, exact_mean: np.ndarray,
                   ess: float) -> dict:
    """Site-wise mean errors vs an exact oracle, in MC standard-error units.

    z_i = (m_hat_i - m_i) / sqrt(var_i / ESS). A correct sampler gives
    |z| ~ O(1); max|z| > ~4 is a decisive failure regardless of sample
    count — unlike plug-in KL this acceptance check has no small-sample
    bias floor.
    """
    samples = np.asarray(samples, dtype=np.float64)
    flat = samples.reshape(-1, samples.shape[-1])
    m_hat = flat.mean(axis=0)
    var = flat.var(axis=0)
    ess_per_site = max(float(ess), 1.0)
    se = np.sqrt(np.maximum(var, 1e-12) / ess_per_site)
    z = (m_hat - np.asarray(exact_mean, dtype=np.float64)) / se
    # Null calibration for the MAX statistic: max over d sites of |N(0,1)|
    # has expectation ~1.5 at d=10 and exceeds 2.9 with ~8% probability, so
    # a raw "max_abs_z < 1.5" reading would flag a CORRECT sampler most
    # runs (verified empirically: bimodal site-mean errors shrink as
    # 1/sqrt(n) while max_abs_z stays on this null across seeds). The
    # p-value states how surprising the observed max actually is.
    from math import erfc

    d = z.shape[0]
    max_z = float(np.max(np.abs(z)))
    p_site = erfc(max_z / np.sqrt(2.0))
    return {
        "max_abs_z": max_z,
        "mean_abs_z": float(np.mean(np.abs(z))),
        "max_z_null_p": float(1.0 - (1.0 - p_site) ** d),
    }


def running_moments(x: torch.Tensor):
    """Mean and (population) std over the leading axis, a reduction on x's
    device."""
    return torch.mean(x, dim=0), torch.std(x, dim=0, correction=0)
