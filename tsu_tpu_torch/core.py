"""ThermalSamplingUnit: the continuous sampling engine's front end.

Counterpart of ``tsu_tpu/core.py``, on the port's Langevin engine
(``samplers/langevin.py``):

* ``sample_from_energy`` takes any energy of one (dim,) state written with
  torch operations and runs all chains, burn-in and thinning on the unit's
  device (the card by default), as CUDA graphs there.
* ``p_bit`` is exact Bernoulli sampling and ``sample_categorical`` exact
  categorical sampling, one draw on the device each.
* ``sample_gaussian`` runs the Langevin engine on the quadratic energy: the
  engine's statistical self-test, validated against N(mu, sigma).

The unit's randomness comes from a CPU ``torch.Generator`` seeded by
``seed``; each call seeds a device generator from it.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.func import grad, jvp

from tsu_tpu_torch.config import SamplingError, TSUConfig, resolve_device
from tsu_tpu_torch.energy import Quadratic, validate_energy_fn
from tsu_tpu_torch.rng import as_generator, device_generator
from tsu_tpu_torch.samplers.langevin import run_langevin
from tsu_tpu_torch.samplers.loop import Draws


class ThermalSamplingUnit:
    """Langevin-dynamics sampler for arbitrary energy landscapes.

    ``seed``: an int, a CPU ``torch.Generator`` or None (fresh entropy).
    ``device``: where the chains run (default the card). ``last_route``:
    the route of the last ``sample_from_energy`` ("graph" or "eager").
    """

    def __init__(self, config: Optional[TSUConfig] = None, seed=None, device=None):
        self.config = config or TSUConfig()
        self.device = resolve_device(device)
        self._gen = as_generator(seed)
        self.sample_count = 0
        self.last_route: Optional[str] = None

    def _device_gen(self) -> torch.Generator:
        return device_generator(self._gen, self.device)

    def sample_from_energy(self, energy_fn: Callable, initial_state, n_samples: int = 100
                           ) -> np.ndarray:
        """Sample from p(x) ∝ exp(-E(x)/T).

        Returns a numpy array of shape (n_samples, dim): ``config.n_chains``
        chains, their samples interleaved.
        """
        if n_samples <= 0:
            raise SamplingError(f"n_samples must be positive, got {n_samples}")
        x0 = torch.atleast_1d(torch.as_tensor(np.asarray(initial_state, np.float32)))
        if x0.dim() != 1:
            raise SamplingError(f"initial_state must be 1-D, got shape {tuple(x0.shape)}")
        x0 = x0.to(self.device)
        validate_energy_fn(energy_fn, x0)

        cfg = self.config
        n_chains = cfg.n_chains
        per_chain = -(-n_samples // n_chains)  # ceil

        # Scale-invariant preconditioning: one Hessian-vector probe at x0
        # estimates the energy's local curvature k ~ 1/sigma^2; rescaling the
        # particle mass (underdamped) or friction (overdamped) by k makes the
        # mixing time independent of the target's length scale.
        curvature = self._estimate_curvature(energy_fn, x0)
        mass = cfg.mass * curvature if cfg.underdamped else cfg.mass
        friction = cfg.friction if cfg.underdamped else cfg.friction * curvature

        gen = self._device_gen()
        # Jitter the chains' starts.
        starts = x0[None, :] + 0.1 * torch.randn((n_chains, x0.shape[0]), generator=gen,
                                                 device=self.device)
        samples, self.last_route = run_langevin(
            Draws(gen), starts, energy_fn=energy_fn, n_samples=per_chain,
            temperature=cfg.temperature, dt=cfg.dt, friction=friction, mass=mass,
            n_burnin=cfg.n_burnin, n_steps=max(1, cfg.n_steps // 10),
            underdamped=cfg.underdamped)
        # (chains, per_chain, dim) -> interleave chains -> (n_samples, dim)
        out = samples.transpose(0, 1).reshape(-1, x0.shape[0])[:n_samples].cpu().numpy()
        self.sample_count += n_samples
        return out

    @staticmethod
    def _estimate_curvature(energy_fn: Callable, x0: torch.Tensor) -> float:
        """Hutchinson estimate of the mean Hessian diagonal of E at x0 (a
        forward-mode derivative of the gradient along a vector of ones).

        Clamped to [1e-3, 1e4], and 1 where it is not positive and finite,
        so saddle or flat starting points degrade to the unpreconditioned
        dynamics."""
        try:
            v = torch.ones_like(x0)
            hvp = jvp(grad(energy_fn), (x0,), (v,))[1]
            k = float(torch.dot(v, hvp) / torch.dot(v, v))
        except Exception:  # noqa: BLE001 - the curvature is optional
            return 1.0
        if not np.isfinite(k) or k <= 0.0:
            return 1.0
        return float(np.clip(k, 1e-3, 1e4))

    def p_bit(self, prob: float, n_samples: int = 1) -> np.ndarray:
        """Sample Bernoulli(prob) bits, exactly: one uniform per bit on the
        unit's device."""
        if not 0.0 <= prob <= 1.0:
            raise SamplingError(f"prob must be in [0, 1], got {prob}")
        if n_samples <= 0:
            raise SamplingError(f"n_samples must be positive, got {n_samples}")
        u = torch.rand((n_samples,), generator=self._device_gen(), device=self.device)
        self.sample_count += n_samples
        return (u < prob).to(torch.int32).cpu().numpy()

    def sample_gaussian(self, mu: float = 0.0, sigma: float = 1.0, n_samples: int = 100
                        ) -> np.ndarray:
        """Sample N(mu, sigma) via Langevin on the quadratic energy: the
        engine's statistical self-test."""
        if sigma <= 0:
            raise SamplingError(f"sigma must be positive, got {sigma}")
        samples = self.sample_from_energy(Quadratic(mu=mu, sigma=sigma), np.array([mu]),
                                          n_samples)
        return samples[:, 0]

    def sample_categorical(self, probs, n_samples: int = 1) -> np.ndarray:
        """Sample categorical indices, exactly (``torch.multinomial`` with
        replacement on the unit's device)."""
        probs = np.asarray(probs, dtype=np.float64)
        if probs.ndim != 1 or probs.size == 0:
            raise SamplingError("probs must be a non-empty 1-D array")
        if np.any(probs < 0) or not np.isclose(probs.sum(), 1.0, atol=1e-6):
            raise SamplingError("probs must be non-negative and sum to 1")
        idx = torch.multinomial(torch.as_tensor(probs).to(self.device), n_samples,
                                replacement=True, generator=self._device_gen())
        self.sample_count += n_samples
        return idx.to(torch.int32).cpu().numpy()


class ProbabilisticNeuron:
    """Stochastic neuron on p-bit sampling."""

    def __init__(self, tsu: ThermalSamplingUnit):
        self.tsu = tsu

    @staticmethod
    def _prob(weights, inputs, bias: float) -> float:
        z = float(np.dot(weights, inputs) + bias)
        return float(torch.sigmoid(torch.tensor(z, dtype=torch.float32)))

    def activate(self, weights, inputs, bias: float = 0.0) -> int:
        """Stochastic binary activation: Bernoulli(sigmoid(w·x + b))."""
        return int(self.tsu.p_bit(self._prob(weights, inputs, bias), 1)[0])

    def forward_stochastic(self, weights, inputs, bias: float = 0.0, n_samples: int = 100
                           ) -> np.ndarray:
        return self.tsu.p_bit(self._prob(weights, inputs, bias), n_samples)


def validate_distribution(samples, expected_type: str = "gaussian",
                          expected_params: Optional[dict] = None) -> dict:
    """Statistical validation of samples.

    gaussian: KS test against N(mu, sigma); bernoulli: empirical-rate error.
    Returns a dict with 'valid' plus diagnostics.
    """
    from scipy import stats

    samples = np.asarray(samples).ravel()
    params = expected_params or {}
    if expected_type == "gaussian":
        mu = params.get("mu", 0.0)
        sigma = params.get("sigma", 1.0)
        ks_stat, p_value = stats.kstest(samples, stats.norm(loc=mu, scale=sigma).cdf)
        # MC-error-aware moment check.
        se_mean = sigma / np.sqrt(len(samples))
        mean_err = abs(samples.mean() - mu)
        return {
            "valid": bool(p_value > 0.01),
            "ks_statistic": float(ks_stat),
            "p_value": float(p_value),
            "sample_mean": float(samples.mean()),
            "sample_std": float(samples.std()),
            "mean_error_sigmas": float(mean_err / max(se_mean, 1e-12)),
        }
    if expected_type == "bernoulli":
        p = params.get("p", 0.5)
        rate = float(samples.mean())
        se = np.sqrt(p * (1 - p) / max(len(samples), 1))
        return {
            "valid": bool(abs(rate - p) < max(5 * se, 0.05)),
            "empirical_prob": rate,
            "expected_prob": float(p),
            "error": float(abs(rate - p)),
        }
    raise ValueError(f"unknown distribution type: {expected_type!r}")
