"""Plots of samples, uncertainty and Ising states.

Counterpart of ``tsu_tpu/visualization.py``: the same eight public functions
and signatures (the two energy plots take one more keyword, ``device``).
matplotlib, and plotly for the interactive plot, are imported when a plot is
drawn, never when this module is imported: the package imports without
them, and a plot call without them raises ``ImportError`` naming the
missing library. Arrays are pulled to the host with ``np.asarray`` (tensors
on the card through ``.cpu()``). An energy function is evaluated over the
grid in one batch, ``torch.func.vmap`` on one tensor on ``device`` (default
the card, ``"cuda"``), in place of the reference's ``jax.vmap``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from tsu_tpu_torch.config import resolve_device

SPIN_CMAP = "coolwarm"
UNCERTAINTY_COLOR = "#4C72B0"
ERROR_COLOR = "#C44E52"


def pyplot():
    """matplotlib and its pyplot, or ImportError naming matplotlib."""
    try:
        import matplotlib
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError("matplotlib is required for tsu_tpu_torch's plots") from e
    return matplotlib, plt


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x)


def _finish(fig, save_path: Optional[str], show: bool):
    matplotlib, plt = pyplot()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    if show and matplotlib.get_backend().lower() != "agg":
        plt.show()
    return fig


def _eval_energy(energy_fn: Callable, points: np.ndarray, device) -> np.ndarray:
    """energy_fn at each row of ``points``: one vmap over a float32 batch on
    ``device``, or point by point for an energy vmap cannot batch (host
    code, data-dependent branches)."""
    pts = torch.as_tensor(np.asarray(points, np.float32)).to(resolve_device(device))
    try:
        return torch.func.vmap(energy_fn)(pts).detach().cpu().numpy().astype(np.float64)
    except (RuntimeError, TypeError, ValueError):
        return np.array([float(energy_fn(p)) for p in pts])


def _eval_energy_grid(energy_fn: Callable, xlim, ylim, resolution: int, device=None):
    """The energy over a resolution x resolution grid: (XX, YY, Z)."""
    xs = np.linspace(xlim[0], xlim[1], resolution)
    ys = np.linspace(ylim[0], ylim[1], resolution)
    XX, YY = np.meshgrid(xs, ys)
    Z = _eval_energy(energy_fn, np.stack([XX.ravel(), YY.ravel()], axis=1), device)
    return XX, YY, Z.reshape(resolution, resolution)


def plot_predictions_with_uncertainty(
    x: np.ndarray,
    y_pred: np.ndarray,
    y_std: np.ndarray,
    y_true: Optional[np.ndarray] = None,
    x_train: Optional[np.ndarray] = None,
    y_train: Optional[np.ndarray] = None,
    title: str = "Predictions with Uncertainty",
    xlabel: str = "Input",
    ylabel: str = "Output",
    confidence_levels: List[float] = [1.0, 2.0],
    figsize: Tuple[int, int] = (10, 6),
    save_path: Optional[str] = None,
    show: bool = True,
):
    """Shaded confidence bands around the predictive mean."""
    _, plt = pyplot()
    x = _host(x).ravel()
    y_pred = _host(y_pred).ravel()
    y_std = _host(y_std).ravel()
    order = np.argsort(x)
    x, y_pred, y_std = x[order], y_pred[order], y_std[order]

    fig, ax = plt.subplots(figsize=figsize)
    for level in sorted(confidence_levels, reverse=True):
        ax.fill_between(
            x, y_pred - level * y_std, y_pred + level * y_std,
            alpha=0.25 / max(level, 1.0), color=UNCERTAINTY_COLOR,
            label=f"±{level:g}σ",
        )
    ax.plot(x, y_pred, color=UNCERTAINTY_COLOR, lw=2, label="Prediction")
    if y_true is not None:
        ax.plot(x, _host(y_true).ravel()[order], "k--", lw=1.5, label="True")
    if x_train is not None and y_train is not None:
        ax.scatter(_host(x_train), _host(y_train), c="black", s=25, zorder=5,
                   label="Training data")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.legend()
    return _finish(fig, save_path, show)


def plot_uncertainty_vs_error(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    y_std: np.ndarray,
    title: str = "Uncertainty vs Prediction Error",
    bins: int = 20,
    figsize: Tuple[int, int] = (12, 5),
    save_path: Optional[str] = None,
    show: bool = True,
):
    """Calibration: |error| against the predicted std, raw and binned."""
    _, plt = pyplot()
    err = np.abs(_host(y_true).ravel() - _host(y_pred).ravel())
    std = _host(y_std).ravel()

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=figsize)
    ax1.scatter(std, err, alpha=0.4, s=15, color=UNCERTAINTY_COLOR)
    lim = max(std.max(), err.max()) if len(std) else 1.0
    ax1.plot([0, lim], [0, lim], "k--", lw=1, label="y = x")
    ax1.set_xlabel("Predicted uncertainty (std)")
    ax1.set_ylabel("|error|")
    ax1.set_title("Uncertainty vs |error|")
    ax1.legend()

    if len(std):
        edges = np.unique(np.quantile(std, np.linspace(0, 1, bins + 1)))
        idx = np.clip(np.digitize(std, edges) - 1, 0, len(edges) - 2)
        centers = 0.5 * (edges[:-1] + edges[1:])
        means = np.array([err[idx == b].mean() if np.any(idx == b) else np.nan
                          for b in range(len(edges) - 1)])
        stds = np.array([err[idx == b].std() if np.any(idx == b) else np.nan
                         for b in range(len(edges) - 1)])
        ax2.errorbar(centers, means, yerr=stds, fmt="o-", color=ERROR_COLOR)
    ax2.set_xlabel("Predicted uncertainty (binned)")
    ax2.set_ylabel("Mean |error|")
    ax2.set_title("Binned calibration")
    fig.suptitle(title)
    return _finish(fig, save_path, show)


def plot_energy_landscape_2d(
    energy_fn: Callable,
    xlim: Tuple[float, float],
    ylim: Tuple[float, float],
    samples: Optional[np.ndarray] = None,
    trajectory: Optional[np.ndarray] = None,
    resolution: int = 100,
    title: str = "Energy Landscape",
    figsize: Tuple[int, int] = (10, 8),
    save_path: Optional[str] = None,
    show: bool = True,
    device=None,
):
    """Contour plot of a 2-D energy with optional samples and trajectory;
    the energy is evaluated on ``device`` (default the card)."""
    _, plt = pyplot()
    XX, YY, Z = _eval_energy_grid(energy_fn, xlim, ylim, resolution, device)
    fig, ax = plt.subplots(figsize=figsize)
    cs = ax.contourf(XX, YY, Z, levels=30, cmap="viridis")
    fig.colorbar(cs, ax=ax, label="Energy")
    if samples is not None:
        samples = _host(samples)
        ax.scatter(samples[:, 0], samples[:, 1], s=8, c="white", alpha=0.5,
                   label="Samples")
    if trajectory is not None:
        trajectory = _host(trajectory)
        ax.plot(trajectory[:, 0], trajectory[:, 1], "r.-", lw=1, ms=3,
                alpha=0.8, label="Trajectory")
    if samples is not None or trajectory is not None:
        ax.legend()
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_title(title)
    return _finish(fig, save_path, show)


def plot_ising_state(
    state: np.ndarray,
    title: str = "Ising Configuration",
    colorbar: bool = True,
    figsize: Optional[Tuple[int, int]] = None,
    save_path: Optional[str] = None,
    show: bool = True,
):
    """1-D arrow plot or 2-D heatmap of spins."""
    _, plt = pyplot()
    state = _host(state)
    spins = np.where(state > 0, 1.0, -1.0)
    if state.ndim == 1:
        fig, ax = plt.subplots(figsize=figsize or (max(6, len(state) * 0.25), 2))
        for i, s in enumerate(spins):
            ax.annotate(
                "", xy=(i, 0.5 * s), xytext=(i, -0.5 * s),
                arrowprops=dict(arrowstyle="-|>", lw=2,
                                color="#C44E52" if s > 0 else "#4C72B0"),
            )
        ax.set_xlim(-1, len(state))
        ax.set_ylim(-1, 1)
        ax.set_yticks([])
        ax.set_title(title)
    elif state.ndim == 2:
        fig, ax = plt.subplots(figsize=figsize or (6, 6))
        im = ax.imshow(spins, cmap=SPIN_CMAP, vmin=-1, vmax=1)
        if colorbar:
            fig.colorbar(im, ax=ax, label="Spin")
        ax.set_title(title)
    else:
        raise ValueError(f"state must be 1-D or 2-D, got ndim={state.ndim}")
    return _finish(fig, save_path, show)


def plot_phase_transition(
    temperatures: np.ndarray,
    magnetizations: np.ndarray,
    magnetization_errors: Optional[np.ndarray] = None,
    critical_temp: Optional[float] = None,
    title: str = "Phase Transition",
    figsize: Tuple[int, int] = (10, 6),
    save_path: Optional[str] = None,
    show: bool = True,
):
    """|M| against T with optional error bars and a T_c marker."""
    _, plt = pyplot()
    fig, ax = plt.subplots(figsize=figsize)
    T = _host(temperatures)
    M = _host(magnetizations)
    if magnetization_errors is not None:
        ax.errorbar(T, M, yerr=_host(magnetization_errors), fmt="o-",
                    color=UNCERTAINTY_COLOR, capsize=3)
    else:
        ax.plot(T, M, "o-", color=UNCERTAINTY_COLOR)
    if critical_temp is not None:
        ax.axvline(critical_temp, color=ERROR_COLOR, ls="--",
                   label=f"$T_c$ = {critical_temp:.3f}")
        ax.legend()
    ax.set_xlabel("Temperature")
    ax.set_ylabel("|Magnetization|")
    ax.set_title(title)
    return _finish(fig, save_path, show)


def plot_sampling_diagnostics(
    samples: np.ndarray,
    true_distribution: Optional[Callable] = None,
    title: str = "Sampling Diagnostics",
    figsize: Tuple[int, int] = (15, 5),
    save_path: Optional[str] = None,
    show: bool = True,
):
    """Histogram, autocorrelation (the FFT estimator of ``ops/stats.py``)
    and trace of the first dimension."""
    from tsu_tpu_torch.ops.stats import autocorrelation, effective_sample_size

    _, plt = pyplot()
    samples = _host(samples)
    x = samples if samples.ndim == 1 else samples[:, 0]

    fig, (ax1, ax2, ax3) = plt.subplots(1, 3, figsize=figsize)
    ax1.hist(x, bins=50, density=True, alpha=0.7, color=UNCERTAINTY_COLOR,
             label="Samples")
    if true_distribution is not None:
        grid = np.linspace(x.min(), x.max(), 200)
        ax1.plot(grid, [true_distribution(g) for g in grid], "k-", lw=2,
                 label="True PDF")
        ax1.legend()
    ax1.set_title("Histogram")

    max_lag = min(100, len(x) - 1)
    acf = autocorrelation(x, max_lag)
    ax2.bar(np.arange(len(acf)), acf, color=UNCERTAINTY_COLOR, width=1.0)
    ax2.axhline(0, color="k", lw=0.5)
    ax2.set_title(f"Autocorrelation (ESS≈{effective_sample_size(x):.0f})")
    ax2.set_xlabel("Lag")

    ax3.plot(x, lw=0.5, color=UNCERTAINTY_COLOR)
    ax3.set_title("Trace")
    ax3.set_xlabel("Iteration")
    fig.suptitle(title)
    return _finish(fig, save_path, show)


def plot_active_learning_curve(
    n_labeled: np.ndarray,
    accuracies_active: np.ndarray,
    accuracies_random: np.ndarray,
    title: str = "Active Learning Performance",
    figsize: Tuple[int, int] = (10, 6),
    save_path: Optional[str] = None,
    show: bool = True,
):
    """Active against random query strategies."""
    _, plt = pyplot()
    fig, ax = plt.subplots(figsize=figsize)
    ax.plot(_host(n_labeled), _host(accuracies_active), "o-", color=UNCERTAINTY_COLOR,
            label="Active (uncertainty)")
    ax.plot(_host(n_labeled), _host(accuracies_random), "s--", color=ERROR_COLOR,
            label="Random")
    ax.set_xlabel("Labeled examples")
    ax.set_ylabel("Performance")
    ax.set_title(title)
    ax.legend()
    return _finish(fig, save_path, show)


def plot_interactive_energy_landscape(
    energy_fn: Callable,
    xlim: Tuple[float, float],
    ylim: Tuple[float, float],
    samples: Optional[np.ndarray] = None,
    resolution: int = 50,
    title: str = "Interactive Energy Landscape",
    device=None,
):
    """Plotly 3-D surface of a 2-D energy, evaluated on ``device`` (default
    the card), with optional samples on it."""
    try:
        import plotly.graph_objects as go
    except ImportError as e:
        raise ImportError("plotly required for interactive plots") from e
    XX, YY, Z = _eval_energy_grid(energy_fn, xlim, ylim, resolution, device)
    traces = [go.Surface(x=XX, y=YY, z=Z, colorscale="Viridis", opacity=0.9)]
    if samples is not None:
        samples = _host(samples)
        traces.append(
            go.Scatter3d(
                x=samples[:, 0], y=samples[:, 1], z=_eval_energy(energy_fn, samples, device),
                mode="markers", marker=dict(size=2, color="white"),
            )
        )
    fig = go.Figure(data=traces)
    fig.update_layout(title=title, scene=dict(zaxis_title="Energy"))
    return fig
