"""The port's plots (``tsu_tpu_torch/visualization.py`` and the model plots
of ``tsu_tpu_torch/models/ising.py``) against the JAX package's, on Agg.

``tests/test_visualization.py``'s twelve checks run on the port's
functions. The energy grid equals the JAX package's (rtol 1e-5); the data
the diagnostics and phase-transition plots draw, the model plots' images
and ``compute_domains`` equal the reference's on the same inputs. With
matplotlib and plotly blocked, ``import tsu_tpu_torch`` still works and a
plot call raises ``ImportError`` naming the missing library.
"""

import importlib.util
import subprocess
import sys

import numpy as np
import pytest
import torch
from matplotlib.figure import Figure

import tsu_tpu.visualization as jviz
from tsu_tpu.energy import MixtureOfGaussians as JaxMixture
from tsu_tpu.energy import Quadratic as JaxQuadratic
from tsu_tpu.models.ising import IsingChain as JaxChain
from tsu_tpu.models.ising import IsingGrid as JaxGrid
from tsu_tpu_torch import (
    IsingChain,
    IsingGrid,
    MixtureOfGaussians,
    Quadratic,
    plot_active_learning_curve,
    plot_energy_landscape_2d,
    plot_interactive_energy_landscape,
    plot_ising_state,
    plot_phase_transition,
    plot_predictions_with_uncertainty,
    plot_sampling_diagnostics,
    plot_uncertainty_vs_error,
)
from tsu_tpu_torch.visualization import _eval_energy_grid

CPU = "cpu"


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    import matplotlib.pyplot as plt

    plt.close("all")


@pytest.fixture
def xy(rng):
    x = np.linspace(-2, 2, 40)
    y = np.sin(x) + 0.1 * rng.normal(size=40)
    return x, y


class TestPlots:
    def test_predictions_with_uncertainty(self, xy):
        x, y = xy
        fig = plot_predictions_with_uncertainty(
            x, y, 0.2 * np.ones_like(x), y_true=np.sin(x),
            x_train=x[::5], y_train=y[::5], show=False,
        )
        assert isinstance(fig, Figure)

    def test_uncertainty_vs_error(self, xy, rng):
        x, y = xy
        fig = plot_uncertainty_vs_error(y, y + 0.1 * rng.normal(size=40),
                                        np.abs(rng.normal(0.2, 0.05, 40)), show=False)
        assert isinstance(fig, Figure)

    def test_energy_landscape_2d(self, rng):
        fig = plot_energy_landscape_2d(
            lambda p: torch.sum(p**2), (-2, 2), (-2, 2),
            samples=rng.normal(0, 1, (50, 2)), trajectory=rng.normal(0, 1, (10, 2)),
            resolution=20, show=False, device=CPU,
        )
        assert isinstance(fig, Figure)

    def test_ising_state_1d(self):
        fig = plot_ising_state(np.array([1, -1, 1, -1.0]), show=False)
        assert isinstance(fig, Figure)

    def test_ising_state_2d(self, rng):
        fig = plot_ising_state(np.where(rng.random((8, 8)) < 0.5, 1.0, -1.0), show=False)
        assert isinstance(fig, Figure)

    def test_ising_state_3d_rejected(self):
        with pytest.raises(ValueError):
            plot_ising_state(np.ones((2, 2, 2)), show=False)

    def test_phase_transition(self):
        T = np.linspace(0.5, 4, 10)
        fig = plot_phase_transition(T, np.exp(-T), magnetization_errors=0.05 * np.ones(10),
                                    critical_temp=2.269, show=False)
        assert isinstance(fig, Figure)

    def test_sampling_diagnostics(self, rng):
        fig = plot_sampling_diagnostics(
            rng.normal(0, 1, 500),
            true_distribution=lambda z: np.exp(-z**2 / 2) / np.sqrt(2 * np.pi), show=False,
        )
        assert isinstance(fig, Figure)

    def test_sampling_diagnostics_2d_input(self, rng):
        fig = plot_sampling_diagnostics(rng.normal(0, 1, (300, 3)), show=False)
        assert isinstance(fig, Figure)

    def test_active_learning_curve(self):
        n = np.arange(10, 60, 10)
        fig = plot_active_learning_curve(n, 1 - 1 / n, 1 - 2 / n, show=False)
        assert isinstance(fig, Figure)

    def test_save_path(self, xy, tmp_path):
        x, y = xy
        out = tmp_path / "fig.png"
        plot_predictions_with_uncertainty(x, y, np.ones_like(x), save_path=str(out),
                                          show=False)
        assert out.exists()

    def test_interactive_landscape(self):
        def energy(p):
            return torch.sum(p**2)

        if importlib.util.find_spec("plotly") is None:
            with pytest.raises(ImportError, match="plotly"):
                plot_interactive_energy_landscape(energy, (-1, 1), (-1, 1), resolution=10,
                                                  device=CPU)
        else:
            fig = plot_interactive_energy_landscape(energy, (-1, 1), (-1, 1), resolution=10,
                                                    device=CPU)
            assert fig is not None


@pytest.mark.parametrize("ours,ref", [
    (Quadratic(mu=0.5, sigma=1.3), JaxQuadratic(mu=0.5, sigma=1.3)),
    (MixtureOfGaussians(((-2.0, 0.0), (2.0, 1.0)), (0.6, 0.9)),
     JaxMixture(((-2.0, 0.0), (2.0, 1.0)), (0.6, 0.9))),
], ids=["quadratic", "mixture"])
def test_energy_grid_equals_the_reference(ours, ref):
    XX, YY, Z = _eval_energy_grid(ours, (-3, 3), (-2, 2.5), 17, device=CPU)
    JX, JY, JZ = jviz._eval_energy_grid(ref, (-3, 3), (-2, 2.5), 17)
    np.testing.assert_array_equal(XX, JX)
    np.testing.assert_array_equal(YY, JY)
    np.testing.assert_allclose(Z, JZ, rtol=1e-5)


def test_energy_grid_falls_back_point_by_point():
    calls = []

    def host_energy(p):
        calls.append(1)
        return float(np.sum(np.asarray(p) ** 2))

    _, _, Z = _eval_energy_grid(host_energy, (-1, 1), (-1, 1), 4, device=CPU)
    assert len(calls) == 1 + 16        # the batched call that failed, then each point
    assert Z.shape == (4, 4) and Z[0, 0] == pytest.approx(2.0)


def _drawn(fig) -> list:
    """The data every axis of a figure draws: line points, bar heights."""
    out = []
    for ax in fig.axes:
        out.append([np.asarray(line.get_xydata()) for line in ax.lines])
        out.append([p.get_height() for p in ax.patches])
        out.append(ax.get_title())
    return out


def _same_drawing(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, str):
            assert x == y
        else:
            assert len(x) == len(y)
            for u, v in zip(x, y):
                np.testing.assert_allclose(u, v, rtol=1e-12)


@pytest.mark.parametrize("shape", [(400,), (300, 3)])
def test_sampling_diagnostics_draw_the_reference_data(shape, rng):
    samples = rng.normal(0.3, 1.2, shape)
    pdf = None if len(shape) > 1 else (lambda z: np.exp(-z**2 / 2))
    ours = plot_sampling_diagnostics(samples, true_distribution=pdf, show=False)
    ref = jviz.plot_sampling_diagnostics(samples, true_distribution=pdf, show=False)
    _same_drawing(_drawn(ours), _drawn(ref))


@pytest.mark.parametrize("errors", [None, 0.05])
def test_phase_transition_draws_the_reference_data(errors):
    T = np.linspace(0.5, 4, 12)
    err = None if errors is None else errors * np.ones(12)
    ours = plot_phase_transition(T, np.exp(-T), magnetization_errors=err,
                                 critical_temp=2.269, show=False)
    ref = jviz.plot_phase_transition(T, np.exp(-T), magnetization_errors=err,
                                     critical_temp=2.269, show=False)
    _same_drawing(_drawn(ours), _drawn(ref))


def _image(fig) -> np.ndarray:
    return np.asarray(fig.axes[0].images[0].get_array())


def test_grid_visualize_equals_the_reference(rng):
    state = np.where(rng.random(6 * 8) < 0.5, 1.0, -1.0).astype(np.float32)
    ours = IsingGrid((6, 8), device=CPU, seed=0).visualize(state, title="t")
    ref = JaxGrid((6, 8), seed=0).visualize(state, title="t")
    np.testing.assert_array_equal(_image(ours), _image(ref))
    assert len(ours.axes) == len(ref.axes) == 2       # the colour bar
    assert ours.axes[0].get_title() == ref.axes[0].get_title()


def test_chain_visualize_equals_the_reference(rng):
    state = np.where(rng.random(12) < 0.5, 1.0, -1.0).astype(np.float32)
    ours = IsingChain(12, device=CPU, seed=0).visualize(state)
    ref = JaxChain(12, seed=0).visualize(state)
    np.testing.assert_array_equal(_image(ours), _image(ref))
    assert ours.get_size_inches().tolist() == ref.get_size_inches().tolist()


@pytest.mark.parametrize("shape,p_up", [((8, 8), 0.5), ((6, 10), 0.8), ((16, 16), 0.3)])
def test_compute_domains_equals_the_reference(shape, p_up, rng):
    ours, ref = IsingGrid(shape, device=CPU, seed=0), JaxGrid(shape, seed=0)
    for _ in range(3):
        state = np.where(rng.random(shape[0] * shape[1]) < p_up, 1.0, -1.0)
        assert ours.compute_domains(state) == ref.compute_domains(state)
    assert ours.compute_domains(np.ones(shape[0] * shape[1])) == 1


BLOCKED = """
import sys
sys.modules["matplotlib"] = None
sys.modules["plotly"] = None
import numpy as np
import tsu_tpu_torch
assert "plot_phase_transition" in tsu_tpu_torch.__all__
for call, name in (
        (lambda: tsu_tpu_torch.plot_phase_transition(np.ones(3), np.ones(3), show=False),
         "matplotlib"),
        (lambda: tsu_tpu_torch.IsingGrid((4, 4), device="cpu").visualize(np.ones(16)),
         "matplotlib"),
        (lambda: tsu_tpu_torch.IsingChain(4, device="cpu").visualize(np.ones(4)),
         "matplotlib"),
        (lambda: tsu_tpu_torch.plot_interactive_energy_landscape(
            lambda p: p.sum(), (-1, 1), (-1, 1), device="cpu"), "plotly")):
    try:
        call()
    except ImportError as e:
        assert name in str(e), e
    else:
        raise AssertionError(name + " was not required")
print("blocked ok")
"""


def test_import_without_matplotlib_and_plotly():
    out = subprocess.run([sys.executable, "-c", BLOCKED], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "blocked ok" in out.stdout
