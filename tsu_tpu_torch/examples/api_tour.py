"""Tour of the public API: functional samplers, object samplers with
metadata, optimization, probabilistic models and Ising grids, each end to
end.

Counterpart of ``examples/api_tour.py``. The samplers take the card's
backend (``Backend.EMULATOR``), or ``Backend.CPU`` with ``--device cpu``.

Run: python3 -m tsu_tpu_torch.examples.api_tour [--device cpu] [--<size> N ...]
"""

from __future__ import annotations

import numpy as np

import tsu_tpu_torch
from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.examples import cli


def main(n: int = 500, grid: int = 16, device=None) -> dict:
    device = resolve_device(device)
    backend = tsu_tpu_torch.Backend.CPU if device.type == "cpu" else tsu_tpu_torch.Backend.EMULATOR
    print(f"[OK] tsu_tpu_torch {tsu_tpu_torch.__version__}, "
          f"{len(tsu_tpu_torch.__all__)} public symbols")

    # 1. Functional API.
    s = tsu_tpu_torch.sample_gaussian(mu=0.0, sigma=1.0, n=n, backend=backend)
    print(f"1. sample_gaussian: mean={np.mean(s):.3f} std={np.std(s):.3f}")

    # 2. Object API with timing metadata.
    sampler = tsu_tpu_torch.GaussianSampler(mu=5.0, sigma=2.0, seed=0, backend=backend)
    result = sampler.sample(n)
    if not isinstance(result, tsu_tpu_torch.SamplingResult):
        raise AssertionError(f"GaussianSampler.sample returned {type(result).__name__}")
    print(f"2. GaussianSampler: mean={np.mean(result.samples):.3f} "
          f"({result.metadata['samples_per_second']:.0f} samples/s on "
          f"{result.metadata['device']})")

    # 3. Multimodal sampling.
    m = tsu_tpu_torch.sample_multimodal(modes=[-3.0, 3.0], sigmas=[0.5, 0.5], n=n,
                                        backend=backend)
    frac_left = float(np.mean(m < 0))
    print(f"3. sample_multimodal: {frac_left:.0%} in the left mode")

    # 4. Optimization: MAX-CUT by annealed sampling.
    rng = np.random.default_rng(0)
    n_nodes = 12
    adj = (rng.random((n_nodes, n_nodes)) < 0.4).astype(float)
    adj = np.triu(adj, 1) + np.triu(adj, 1).T
    problem = tsu_tpu_torch.MaxCutProblem(adj)
    res = tsu_tpu_torch.optimize(problem, n_steps=300, seed=0, device=device)
    cut = -res["best_objective"]
    print(f"4. MAX-CUT (n={n_nodes}): cut value {cut:.0f} of "
          f"{int(adj.sum() / 2)} edges in {res['time_elapsed']:.2f}s")

    # 5. Probabilistic model (Keras-style).
    model = tsu_tpu_torch.ProbabilisticModel()
    model.add(tsu_tpu_torch.StochasticLinear(4, 3, weight_noise=0.1, seed=0, device=device))
    model.add(tsu_tpu_torch.BernoulliActivation(seed=1, device=device))
    out = model.forward(np.ones((2, 4)))
    print(f"5. ProbabilisticModel forward: shape {out.shape}, "
          f"values in {sorted(set(np.unique(out).tolist()))}")

    # 6. Ising grid with observables.
    ising = tsu_tpu_torch.IsingGrid((grid, grid), coupling_strength=1.0, periodic=True,
                                    device=device)
    states = ising.sample(n_samples=30, temperature=1.5)
    abs_m = abs(ising.magnetization(states))
    line = f"6. IsingGrid {grid}x{grid} @T=1.5: |M|={abs_m:.2f}"
    print(line)

    print("[OK] API tour complete")
    return {"gaussian": s, "sampler_mean": float(np.mean(result.samples)),
            "left_fraction": frac_left, "cut": float(cut), "edges": int(adj.sum() / 2),
            "forward": out, "abs_magnetization": float(abs_m), "line": line}


if __name__ == "__main__":
    cli(main, __doc__)
