"""Quickstart: the main entry points of the port in one script.

Counterpart of ``examples/quickstart.py``: Langevin sampling of a Gaussian
and of a double well written with torch operations
(``ThermalSamplingUnit``), a 2-bit Boltzmann machine (``GibbsSampler``), a
32x32 Ising grid (``IsingGrid``, the fused sweep K1) and Bayesian
regression with credible intervals (``BayesianRegressor``).

Run: python3 -m tsu_tpu_torch.examples.quickstart [--device cpu] [--<size> N ...]
"""

from __future__ import annotations

import numpy as np
import torch

from tsu_tpu_torch import (
    BayesianRegressor,
    GibbsConfig,
    GibbsSampler,
    IsingGrid,
    ThermalSamplingUnit,
    TSUConfig,
)
from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.examples import cli


def double_well(x: torch.Tensor) -> torch.Tensor:
    return torch.sum((x**2 - 1.0) ** 2)


def main(n_gaussian: int = 5000, n_well: int = 3000, grid: int = 32, n_epochs: int = 100,
         device=None) -> dict:
    device = resolve_device(device)
    # 1. Continuous sampling from an energy written with torch operations.
    unit = ThermalSamplingUnit(TSUConfig(n_chains=16, n_burnin=300, n_steps=200, dt=0.1),
                               seed=0, device=device)
    samples = unit.sample_gaussian(mu=2.0, sigma=0.5, n_samples=n_gaussian)
    print(f"Gaussian: mean={samples.mean():.3f} std={samples.std():.3f}")

    # 2. A custom energy.
    s = unit.sample_from_energy(double_well, np.zeros(1), n_well)
    print(f"Double well: both wells visited -> mean |x| = "
          f"{np.abs(s).mean():.3f} (minima at +-1)")

    # 3. Boltzmann machine bits.
    gibbs = GibbsSampler(GibbsConfig(n_chains=16), seed=0, device=device)
    J = np.array([[0.0, 2.0], [2.0, 0.0]], np.float32)
    bits = gibbs.sample_boltzmann(J, n_samples=2000)
    aligned = float(np.mean(bits[:, 0] == bits[:, 1]))
    print(f"2-bit ferromagnet: aligned fraction = {aligned:.2f}")

    # 4. 2-D Ising lattice (the fused sweep on the card).
    ising = IsingGrid((grid, grid), coupling_strength=1.0, periodic=True, seed=0, device=device)
    states = ising.sample(n_samples=50, temperature=1.8)
    m = abs(ising.magnetization(states))
    line = f"{grid}x{grid} Ising @ T=1.8: |M| = {m:.3f}"
    print(line)

    # 5. Bayesian regression with calibrated uncertainty.
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (100, 1)).astype(np.float32)
    y = np.sin(3 * x) + 0.1 * rng.normal(size=x.shape).astype(np.float32)
    reg = BayesianRegressor(1, [32, 32], temperature=0.2, seed=0, device=device)
    reg.fit(x, y, n_epochs=n_epochs, learning_rate=0.01, kl_weight=1e-4)
    mean, lo, hi = reg.predict_with_interval(x[:5])
    for xi, mi, li, hi_ in zip(x[:5].ravel(), mean.ravel(), lo.ravel(), hi.ravel()):
        print(f"  f({xi:+.2f}) = {mi:+.3f}  95% CI [{li:+.3f}, {hi_:+.3f}]")
    return {"gaussian_mean": float(samples.mean()), "gaussian_std": float(samples.std()),
            "well_abs_mean": float(np.abs(s).mean()), "aligned": aligned,
            "abs_magnetization": float(m), "prediction": (mean, lo, hi),
            "x": x[:5], "line": line}


if __name__ == "__main__":
    cli(main, __doc__)
