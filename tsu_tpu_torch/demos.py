"""Demos: multimodal sampling against Metropolis-Hastings, the Ising phase
transition, Bayesian inference.

Counterpart of ``tsu_tpu/demos.py``. Each demo runs on ``device`` (default
the card, ``"cuda"``; ``device="cpu"`` runs the plain PyTorch versions) and
returns its data so that notebooks and tests can assert on it; plots are
optional (matplotlib, plotly) and drawn only on request.
``metropolis_hastings`` is the baseline on the host: it evaluates the
energy one point per step on the CPU in float32, since on the card each
step would be a host sync.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.energy import MixtureOfGaussians


@dataclass
class MultimodalDistribution:
    """10-D, 3-mode Gaussian mixture benchmark target; the modes are the
    reference's arrays (numpy's generator, the same draws)."""

    dim: int = 10
    n_modes: int = 3
    separation: float = 4.0
    sigma: float = 0.6
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        directions = rng.normal(size=(self.n_modes, self.dim))
        directions /= np.linalg.norm(directions, axis=1, keepdims=True)
        self.modes = (directions * self.separation).astype(np.float32)
        self.energy = MixtureOfGaussians(
            tuple(map(tuple, self.modes)), (self.sigma,) * self.n_modes
        )

    def mode_coverage(self, samples: np.ndarray) -> dict:
        """Fraction of samples assigned to each mode by nearest center."""
        d = np.linalg.norm(samples[:, None, :] - self.modes[None], axis=-1)
        assign = d.argmin(axis=1)
        counts = np.bincount(assign, minlength=self.n_modes)
        fracs = counts / max(len(samples), 1)
        return {
            "fractions": fracs,
            "n_modes_covered": int((fracs > 0.05).sum()),
        }


def metropolis_hastings(rng, energy_fn, x0, n_samples, step=0.5, n_burnin=500):
    """Plain random-walk MH baseline on the host (numpy proposals, the
    energy in float32 on the CPU)."""
    def energy(x):
        return float(energy_fn(torch.as_tensor(x, dtype=torch.float32)))

    x = np.asarray(x0, dtype=np.float64)
    e = energy(x)
    out = np.empty((n_samples, x.shape[0]))
    accepts = 0
    for t in range(n_burnin + n_samples):
        prop = x + step * rng.normal(size=x.shape)
        e_new = energy(prop)
        if np.log(rng.random()) < e - e_new:
            x, e = prop, e_new
            accepts += 1
        if t >= n_burnin:
            out[t - n_burnin] = x
    return out, accepts / (n_burnin + n_samples)


def demo_continuous_sampling(n_samples: int = 2000, seed: int = 0,
                             make_plots: bool = False, device=None) -> dict:
    """Multimodal sampling: annealed SMC on ``device`` against host MH."""
    from tsu_tpu_torch.samplers.smc import annealed_smc

    dev = resolve_device(device)
    dist = MultimodalDistribution(seed=seed)
    gen = torch.Generator().manual_seed(seed)
    results = {}

    # The engine: an annealed SMC population, built for multimodality.
    t0 = time.perf_counter()
    particles = dist.separation * torch.randn((n_samples, dist.dim), generator=gen)
    out = annealed_smc(
        gen, particles, energy_fn=dist.energy, n_steps=60, n_moves=5, dt=0.02,
        base_sigma=dist.separation, device=dev,
    )
    tsu_samples = out["particles"].cpu().numpy()
    t_tsu = time.perf_counter() - t0
    results["tsu"] = {
        "samples": tsu_samples,
        "time_s": t_tsu,
        "coverage": dist.mode_coverage(tsu_samples),
    }

    # MCMC baseline.
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    mh_samples, acc = metropolis_hastings(
        rng, dist.energy, np.zeros(dist.dim), min(n_samples, 2000)
    )
    results["mcmc"] = {
        "samples": mh_samples,
        "time_s": time.perf_counter() - t0,
        "acceptance": acc,
        "coverage": dist.mode_coverage(mh_samples),
    }

    print("demo_continuous_sampling:")
    print(f"  tsu  (SMC): {results['tsu']['coverage']['n_modes_covered']}/"
          f"{dist.n_modes} modes, {t_tsu:.2f}s")
    print(f"  mcmc (MH):  {results['mcmc']['coverage']['n_modes_covered']}/"
          f"{dist.n_modes} modes, {results['mcmc']['time_s']:.2f}s "
          f"(acc {acc:.2f})")

    if make_plots:
        from tsu_tpu_torch.visualization import plot_sampling_diagnostics

        plot_sampling_diagnostics(tsu_samples[:, 0], show=False,
                                  title="TSU samples, dim 0")
        try:
            analysis = analyze_results(results, dist, device=dev)
            create_plotly_mode_visualization(
                tsu_samples, mh_samples, dist,
                save_path="visual_output/tsu_modes_2d.html")
            create_plotly_energy_comparison(
                analysis["tsu_quality"], analysis["mcmc_quality"],
                save_path="visual_output/tsu_energy_comparison_2d.html")
        except ImportError:
            pass  # plotly is optional
    return results


def demo_phase_transition(size: int = 32, n_temps: int = 12, seed: int = 0,
                          make_plots: bool = False, device=None) -> dict:
    """Ising phase transition across T_c, against Onsager's magnetization."""
    from tsu_tpu_torch.models.ising import demonstrate_phase_transition
    from tsu_tpu_torch.oracle import onsager_magnetization

    temps = np.linspace(1.0, 3.6, n_temps)
    res = demonstrate_phase_transition([size], temps, n_samples=48, seed=seed,
                                       device=device)
    m = res[size]["magnetization"]
    onsager = np.array([onsager_magnetization(float(T)) for T in temps])
    print("demo_phase_transition:")
    for T, mi, oi in zip(temps, m, onsager):
        bar = "#" * int(mi * 30)
        print(f"  T={T:5.2f} |M|={mi:6.3f} (onsager {oi:5.3f}) {bar}")
    if make_plots:
        from tsu_tpu_torch.visualization import plot_phase_transition

        plot_phase_transition(temps, m, critical_temp=2.269, show=False)
    return {"temperatures": temps, "magnetization": m, "onsager": onsager}


def demo_bayesian_inference(seed: int = 0, make_plots: bool = False, device=None) -> dict:
    """Bayesian linear-regression posterior via Langevin sampling."""
    from tsu_tpu_torch.api import Backend, BayesianSampler
    from tsu_tpu_torch.config import TSUConfig

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    theta_true = np.array([2.0, -1.0])
    X = rng.normal(0, 1, (100, 2))
    y = X @ theta_true + 0.1 * rng.normal(size=100)

    sampler = BayesianSampler(
        X, y, noise_std=0.1, prior_std=5.0, seed=seed,
        backend=Backend.CPU if dev.type == "cpu" else Backend.CUDA,
        config=TSUConfig(n_chains=16, n_burnin=500, n_steps=200, dt=0.01),
    )
    result = sampler.sample(2000)
    post_mean = result.samples.mean(axis=0)
    post_std = result.samples.std(axis=0)
    print("demo_bayesian_inference:")
    for i, (t, m, s) in enumerate(zip(theta_true, post_mean, post_std)):
        print(f"  theta[{i}]: true={t:+.3f} posterior={m:+.3f} ± {s:.3f}")
    if make_plots:
        from tsu_tpu_torch.visualization import plot_sampling_diagnostics

        plot_sampling_diagnostics(result.samples[:, 0], show=False)
    return {
        "theta_true": theta_true,
        "posterior_mean": post_mean,
        "posterior_std": post_std,
        "time_s": result.time_elapsed,
    }


def _energy_stats(energy_fn, samples: np.ndarray, device=None) -> dict:
    """Mean, std and min of the energy over the samples, evaluated in one
    batch on ``device`` (default the card)."""
    x = torch.as_tensor(np.asarray(samples, np.float32)).to(resolve_device(device))
    e = torch.func.vmap(energy_fn)(x).cpu().numpy()
    return {
        "mean_energy": float(e.mean()),
        "std_energy": float(e.std()),
        "min_energy": float(e.min()),
    }


def analyze_results(results: dict, dist: MultimodalDistribution,
                    hardware_time_s: Optional[float] = None, device=None) -> dict:
    """Statistical report comparing the engine with the MCMC baseline.

    Takes the dict returned by :func:`demo_continuous_sampling`, prints a
    formatted report and returns its summary. ``hardware_time_s`` is an
    optional projected hardware wall time (see ``tsu_tpu_torch.hardware``)
    for the emulator-to-hardware speedup row; the energies are evaluated on
    ``device`` (default the card).
    """
    tsu, mcmc = results["tsu"], results["mcmc"]
    tsu_q = _energy_stats(dist.energy, tsu["samples"], device)
    mcmc_q = _energy_stats(dist.energy, mcmc["samples"], device)
    tsu_cov = tsu["coverage"]["n_modes_covered"]
    mcmc_cov = mcmc["coverage"]["n_modes_covered"]
    tsu_q["n_modes_covered"] = tsu_cov
    mcmc_q["n_modes_covered"] = mcmc_cov

    print("\n" + "=" * 72)
    print("DETAILED STATISTICAL ANALYSIS")
    print("=" * 72)
    print(f"{'Metric':<28} {'TSU':>16} {'MCMC':>16}")
    print("-" * 72)
    print(f"{'Sample count':<28} {len(tsu['samples']):>16} {len(mcmc['samples']):>16}")
    for k, label in (("mean_energy", "Mean energy"),
                     ("std_energy", "Std energy"),
                     ("min_energy", "Min energy")):
        print(f"{label:<28} {tsu_q[k]:>16.4f} {mcmc_q[k]:>16.4f}")
    print(f"{'Modes found':<28} {tsu_cov:>14}/{dist.n_modes} {mcmc_cov:>14}/{dist.n_modes}")
    print(f"{'Wall time (s)':<28} {tsu['time_s']:>16.2f} {mcmc['time_s']:>16.2f}")

    time_ratio = tsu["time_s"] / max(mcmc["time_s"], 1e-12)
    print(f"\nTSU/MCMC time ratio: {time_ratio:.2f}x")
    hardware_speedup = None
    if hardware_time_s is not None and hardware_time_s > 0:
        hardware_speedup = tsu["time_s"] / hardware_time_s
        print(f"Projected hardware time: {hardware_time_s * 1e6:.2f} us "
              f"({hardware_speedup:.0e}x emulator-to-hardware speedup)")

    wins = sum([
        tsu_q["min_energy"] < mcmc_q["min_energy"],
        tsu_cov > mcmc_cov,
        tsu_q["std_energy"] < mcmc_q["std_energy"],
    ])
    verdicts = {0: "comparable to", 3: "outperforms on all metrics"}
    print(f"\nAssessment: TSU {verdicts.get(wins, f'{wins}/3 metric advantages vs')} "
          "classical MCMC on this instance")

    mcmc_mean = mcmc_q["mean_energy"]
    return {
        "tsu_quality": tsu_q,
        "mcmc_quality": mcmc_q,
        "mean_energy_improvement": (
            (mcmc_mean - tsu_q["mean_energy"]) / abs(mcmc_mean) * 100.0
            if mcmc_mean != 0 else 0.0
        ),
        "mode_coverage_tsu": tsu_cov / dist.n_modes,
        "mode_coverage_mcmc": mcmc_cov / dist.n_modes,
        "time_ratio": time_ratio,
        "hardware_speedup": hardware_speedup,
        "metric_wins": wins,
    }


def _plotly_go():
    try:
        import plotly.graph_objects as go
        from plotly.subplots import make_subplots
    except ImportError as e:
        raise ImportError("plotly required for interactive comparison plots") from e
    return go, make_subplots


def create_plotly_mode_visualization(
    tsu_samples, mcmc_samples, dist: MultimodalDistribution,
    save_path: Optional[str] = None,
):
    """Interactive 2-D mode-coverage comparison: both sample sets on their
    first two dimensions with the mixture's mode centers; returns the plotly
    Figure and writes HTML to ``save_path`` when given. Requires plotly."""
    go, _ = _plotly_go()
    tsu_samples = np.asarray(tsu_samples)
    mcmc_samples = np.asarray(mcmc_samples)
    fig = go.Figure()
    fig.add_trace(go.Scatter(
        x=mcmc_samples[:, 0], y=mcmc_samples[:, 1], mode="markers",
        name="Metropolis-Hastings",
        marker=dict(size=4, opacity=0.3, color="#d62728"),
    ))
    fig.add_trace(go.Scatter(
        x=tsu_samples[:, 0], y=tsu_samples[:, 1], mode="markers",
        name="tsu_tpu_torch (annealed SMC)",
        marker=dict(size=5, opacity=0.45, color="#2ca02c"),
    ))
    for i, mode in enumerate(dist.modes):
        fig.add_trace(go.Scatter(
            x=[float(mode[0])], y=[float(mode[1])], mode="markers+text",
            name=f"mode {i + 1}",
            marker=dict(size=16, symbol="diamond", color="#1f77b4",
                        line=dict(color="black", width=2)),
            text=[f"M{i + 1}"], textposition="top center",
        ))
    fig.update_layout(
        title="Mode coverage: tsu_tpu_torch vs MCMC (dims 0-1 of "
              f"{dist.dim}-D, {dist.n_modes} modes)",
        xaxis_title="dimension 0", yaxis_title="dimension 1",
        width=900, height=700, hovermode="closest",
    )
    if save_path:
        fig.write_html(save_path)
    return fig


def create_plotly_energy_comparison(
    tsu_quality: dict, mcmc_quality: dict, save_path: Optional[str] = None,
):
    """2x2 grouped-bar quality dashboard of the ``tsu_quality`` and
    ``mcmc_quality`` dicts of :func:`analyze_results`; returns the plotly
    Figure. Requires plotly."""
    go, make_subplots = _plotly_go()
    metrics = [
        ("mean_energy", "Mean energy (lower = better)"),
        ("std_energy", "Energy std"),
        ("min_energy", "Best (min) energy"),
        ("n_modes_covered", "Modes covered"),
    ]
    fig = make_subplots(rows=2, cols=2,
                        subplot_titles=[t for _, t in metrics])
    for idx, (key, _title) in enumerate(metrics):
        row, col = idx // 2 + 1, idx % 2 + 1
        vals = [tsu_quality.get(key), mcmc_quality.get(key)]
        if vals[0] is None or vals[1] is None:
            continue
        fig.add_trace(
            go.Bar(x=["tsu_tpu_torch", "MCMC"], y=vals,
                   marker_color=["#2ca02c", "#d62728"],
                   showlegend=False),
            row=row, col=col,
        )
    fig.update_layout(
        title="Sampling quality: tsu_tpu_torch vs Metropolis-Hastings",
        width=900, height=700,
    )
    if save_path:
        fig.write_html(save_path)
    return fig


def run_all_demos(seed: int = 0, device=None):
    demo_continuous_sampling(seed=seed, device=device)
    demo_phase_transition(seed=seed, device=device)
    demo_bayesian_inference(seed=seed, device=device)


if __name__ == "__main__":
    run_all_demos()
