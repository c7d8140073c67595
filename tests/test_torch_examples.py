"""The port's oracle functions against tsu_tpu.oracle, bit for bit, and
the seven examples of tsu_tpu_torch.examples run small on the CPU, each
meeting its own check."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import tsu_tpu.oracle as joracle  # noqa: E402
from tsu_tpu_torch import oracle  # noqa: E402
from tsu_tpu_torch.config import ConfigurationError  # noqa: E402
from tsu_tpu_torch.examples import (  # noqa: E402
    NAMES,
    api_tour,
    bayesian_nn_demo,
    checkpoint_resume,
    hardware_projection,
    large_scale_maxcut,
    quickstart,
    spin_glass_ground_state,
)

REPO = Path(__file__).resolve().parents[1]


def _couplings(seed, n):
    rng = np.random.default_rng(seed)
    J = rng.normal(scale=0.7, size=(n, n))
    J = np.triu(J, 1) + np.triu(J, 1).T + np.diag(rng.normal(size=n))
    return J, rng.normal(size=n)


def test_oracle_exports_every_name_of_the_reference():
    assert set(joracle.__all__) <= set(oracle.__all__)
    assert all(callable(getattr(oracle, name)) for name in oracle.__all__)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_energies_equal_the_reference(seed):
    J, h = _couplings(seed, 9)
    rng = np.random.default_rng(seed + 10)
    b = (rng.random(9) < 0.5).astype(np.float64)
    s = 2.0 * b - 1.0
    assert oracle.boltzmann_energy(b, J, h) == joracle.boltzmann_energy(b, J, h)
    assert oracle.ising_energy(s, J, h) == joracle.ising_energy(s, J, h)


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("J,h", [(1.0, 0.0), (0.7, 0.3)])
def test_lattice_energy_equals_the_reference(periodic, J, h):
    s = np.where(np.random.default_rng(3).random((6, 10)) < 0.5, 1.0, -1.0)
    assert (oracle.lattice_energy_np(s, J, h, periodic)
            == joracle.lattice_energy_np(s, J, h, periodic))


@pytest.mark.parametrize("name", ["sequential_gibbs_bits", "sequential_gibbs_spins"])
@pytest.mark.parametrize("T", [0.5, 1.7])
def test_sequential_gibbs_equals_the_reference_on_one_generator(name, T):
    """The same inputs and the same numpy generator give the same samples."""
    J, h = _couplings(4, 6)
    kw = dict(n_samples=20, temperature=T, n_burnin=5, n_sweeps=3)
    got = getattr(oracle, name)(np.random.default_rng(7), J, h, **kw)
    want = getattr(joracle, name)(np.random.default_rng(7), J, h, **kw)
    assert got.shape == (20, 6) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_checkpoint_resume_example():
    """Both of the script's equalities: the sharded sample killed at 4
    samples resumes to 12, the PT search killed at 30 iterations to 90."""
    out = checkpoint_resume.main(rows_per_shard=8, cols=32, device="cpu")
    assert out["sharded_same"] and out["pt_same"]
    assert out["magnetization"].shape == (12,)


def test_spin_glass_ground_state_example():
    out = spin_glass_ground_state.main(size=48, steps=600, restarts=2, device="cpu")
    assert out["energy_per_site"] < -1.2
    s = out["state"]
    assert s.shape == (48, 48) and set(np.unique(s)) <= {-1.0, 1.0}


def test_large_scale_maxcut_example_reaches_the_greedy_bound():
    out = large_scale_maxcut.main(n=2000, m=10_000, n_steps=400, device="cpu")
    assert out["cut"] >= out["greedy_cut"] > 0
    assert out["cut"] <= out["n_edges"]


def test_quickstart_example():
    out = quickstart.main(n_gaussian=1000, n_well=1000, grid=32, n_epochs=20, device="cpu")
    assert abs(out["gaussian_mean"] - 2.0) < 0.15 and abs(out["gaussian_std"] - 0.5) < 0.1
    assert 0.5 < out["well_abs_mean"] < 1.2
    # Two bits coupled by J = 2 at T = 1 align with probability (1 + e^2) / (3 + e^2).
    assert abs(out["aligned"] - (1 + np.e**2) / (3 + np.e**2)) < 0.05
    assert out["abs_magnetization"] > 0.8
    mean, lo, hi = out["prediction"]
    assert np.all(lo <= mean) and np.all(mean <= hi)


def test_api_tour_example():
    out = api_tour.main(n=200, grid=16, device="cpu")
    assert 0.2 < out["left_fraction"] < 0.8
    assert 0 < out["cut"] <= out["edges"]
    assert out["forward"].shape == (2, 3) and set(np.unique(out["forward"])) <= {0.0, 1.0}
    assert out["abs_magnetization"] > 0.5      # an unseeded grid, as the script has it


def test_bayesian_nn_demo_example_is_wider_outside_the_data(tmp_path):
    out = bayesian_nn_demo.main(n_epochs=50, plot_dir=str(tmp_path), device="cpu")
    assert out["width_out"] > out["width_in"] > 0
    assert np.all(np.abs(out["picks"]) > 3)       # the learner asks outside the data
    assert out["figure"] == str(tmp_path / "bayesian_nn_demo.png")
    assert (tmp_path / "bayesian_nn_demo.png").stat().st_size > 0


def test_hardware_projection_example():
    out = hardware_projection.main(size=64, sweeps=10, device="cpu")
    assert out["measured_flips_per_s"] > 0 and out["card"] == "cpu"
    assert out["share_of_ceiling"] is None       # a CPU rate is no share of the card's ceiling
    ceilings = [out["rooflines"][n]["flips_per_s_ceiling"] for n in (1024, 4096, 16384)]
    assert all(c > 1e11 for c in ceilings)
    assert out["conservative_s"] > out["optimistic_s"]


@pytest.mark.parametrize("name", NAMES)
def test_examples_default_to_the_card(name, monkeypatch):
    """Without CUDA an example run with no device raises before any work."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigurationError):
        importlib.import_module(f"tsu_tpu_torch.examples.{name}").main()


def test_an_example_runs_under_python_m_and_imports_no_jax():
    """``python -m tsu_tpu_torch.examples.api_tour --device cpu`` runs to its
    end; importing every example and the oracle brings in no JAX, no
    tsu_tpu and no triton."""
    out = subprocess.run([sys.executable, "-m", "tsu_tpu_torch.examples.api_tour", "--device",
                          "cpu", "--n", "100"], cwd=REPO, check=True, capture_output=True,
                         text=True, timeout=240)
    assert out.stdout.splitlines()[-1] == "[OK] API tour complete"
    code = ("import json, sys, importlib\n"
            "import tsu_tpu_torch.oracle\n"
            "from tsu_tpu_torch.examples import NAMES\n"
            "for name in NAMES:\n"
            "    importlib.import_module('tsu_tpu_torch.examples.' + name)\n"
            "print(json.dumps({k: k in sys.modules for k in ('jax', 'tsu_tpu', 'triton')}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.splitlines()[-1]) == {
        "jax": False, "tsu_tpu": False, "triton": False}
