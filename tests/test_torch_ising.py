"""The port's whole slice on the CPU: IsingGrid -> sample_grid -> fused sweep,
against exact enumeration and against tsu_tpu's IsingGrid."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import tsu_tpu_torch  # noqa: E402
from tsu_tpu.config import IsingConfig as JaxIsingConfig  # noqa: E402
from tsu_tpu.models.ising import IsingGrid as JaxIsingGrid  # noqa: E402
from tsu_tpu.ops.checkerboard import split_checkerboard as jax_split  # noqa: E402
from tsu_tpu.oracle import exact_ising_moments  # noqa: E402
from tsu_tpu_torch import (  # noqa: E402
    ConfigurationError,
    IsingConfig,
    IsingGrid,
    demonstrate_phase_transition,
)
from tsu_tpu_torch.interop import (  # noqa: E402
    config_from_fields,
    lattice_to_planes,
    planes_from_numpy,
)
from tsu_tpu_torch.ops.checkerboard import merge_checkerboard  # noqa: E402
from tsu_tpu_torch.ops.checkerboard_fused import fused_sweep, fused_sweep_batched  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
T = 2.5
N_SAMPLES = 2000


def _dense_grid_couplings(R, C):
    J = np.zeros((R * C, R * C))
    for r in range(R):
        for c in range(C):
            i = r * C + c
            for j in (r * C + (c + 1) % C, ((r + 1) % R) * C + c):
                J[i, j] = J[j, i] = 1.0
    return J


def _batch_means_se(x, n_batches=40):
    b = np.asarray(x, np.float64)[: len(x) // n_batches * n_batches]
    b = b.reshape(n_batches, -1).mean(axis=1)
    return b.std(ddof=1) / np.sqrt(n_batches)


def _abs_m_and_e(samples, energies):
    return np.abs(samples.mean(axis=1)), energies / samples.shape[1]


@pytest.fixture(scope="module")
def port_samples():
    grid = IsingGrid((4, 4), periodic=True, seed=0, device="cpu",
                     config=IsingConfig(n_burnin=100, n_sweeps=1))
    s = grid.sample(n_samples=N_SAMPLES, temperature=T)
    return s, grid.energies(s)


def test_grid_sample_matches_exact_enumeration(port_samples):
    s, e = port_samples
    assert s.shape == (N_SAMPLES, 16) and s.dtype == np.float32
    assert set(np.unique(s)) == {-1.0, 1.0}
    exact = exact_ising_moments(_dense_grid_couplings(4, 4), np.zeros(16), T)
    m, e_site = _abs_m_and_e(s, e)
    assert abs(m.mean() - exact["abs_magnetization"]) < 4 * _batch_means_se(m)
    assert abs(e_site.mean() - exact["energy"] / 16) < 4 * _batch_means_se(e_site)


def test_grid_sample_matches_jax_grid(port_samples):
    grid = JaxIsingGrid((4, 4), periodic=True, seed=0, use_pallas=False,
                        config=JaxIsingConfig(n_burnin=100, n_sweeps=1))
    sj = grid.sample(n_samples=N_SAMPLES, temperature=T)
    mj, ej = _abs_m_and_e(sj, grid.energies(sj))
    mt, et = _abs_m_and_e(*port_samples)
    for a, b in ((mt, mj), (et, ej)):
        se = np.hypot(_batch_means_se(a), _batch_means_se(b))
        assert abs(a.mean() - b.mean()) < 4 * se


def test_same_seed_same_samples():
    def run(seed):
        return IsingGrid((8, 6), periodic=False, seed=seed, device="cpu",
                         config=IsingConfig(n_burnin=5, n_sweeps=2)).sample(
            n_samples=3, temperature=2.269)

    a = run(7)
    np.testing.assert_array_equal(a, run(7))
    assert not np.array_equal(a, run(8))


def test_initial_state_is_honoured():
    grid = IsingGrid((8, 8), periodic=True, seed=1, device="cpu",
                     config=IsingConfig(n_burnin=3, n_sweeps=1))
    s = grid.sample(n_samples=2, initial_state=np.ones(64), temperature=0.05)
    np.testing.assert_array_equal(s, np.ones((2, 64), np.float32))


def test_sample_observables_match_exact_enumeration():
    grid = IsingGrid((4, 4), periodic=True, seed=3, device="cpu",
                     config=IsingConfig(n_burnin=50, n_sweeps=1))
    out = grid.sample_observables(n_samples=N_SAMPLES, temperature=T)
    m, e = out["magnetization"], out["energy"]
    assert m.shape == e.shape == (N_SAMPLES,)
    exact = exact_ising_moments(_dense_grid_couplings(4, 4), np.zeros(16), T)
    assert abs(np.abs(m).mean() - exact["abs_magnetization"]) < 4 * _batch_means_se(np.abs(m))
    assert abs(e.mean() - exact["energy"]) < 4 * _batch_means_se(e)


@pytest.mark.parametrize("periodic", [True, False])
def test_observables_match_jax_grid(periodic):
    rng = np.random.default_rng(5)
    samples = np.where(rng.random((6, 36)) < 0.5, 1.0, -1.0).astype(np.float32)
    port = IsingGrid((6, 6), coupling_strength=0.7, periodic=periodic, seed=0, device="cpu")
    ref = JaxIsingGrid((6, 6), coupling_strength=0.7, periodic=periodic,
                       seed=0, use_pallas=False)
    np.testing.assert_allclose(port.energies(samples), ref.energies(samples),
                               rtol=1e-6)
    assert port.energy(samples[0]) == pytest.approx(ref.energy(samples[0]), rel=1e-6)
    assert port.magnetization(samples) == pytest.approx(ref.magnetization(samples))
    assert port.susceptibility(samples, 2.0) == pytest.approx(
        ref.susceptibility(samples, 2.0))
    assert port.specific_heat(samples, 2.0) == pytest.approx(
        ref.specific_heat(samples, 2.0), rel=1e-5)


def test_interop_carries_jax_state():
    rng = np.random.default_rng(6)
    lat = np.where(rng.random((8, 10)) < 0.5, 1.0, -1.0).astype(np.float32)
    red_j, black_j = jax_split(jnp.asarray(lat))
    red, black = planes_from_numpy(red_j, black_j)
    r2, b2 = lattice_to_planes(lat)
    assert torch.equal(red, r2) and torch.equal(black, b2)
    ref = JaxIsingGrid((8, 10), periodic=True, seed=0, use_pallas=False)
    port = IsingGrid((8, 10), periodic=True, seed=0, device="cpu")
    assert port.energy(merge_checkerboard(red, black).numpy()) == ref.energy(lat)
    cfg = JaxIsingConfig(temperature=1.7, n_burnin=12, n_sweeps=3,
                         coupling_strength=0.5, n_chains=2)
    assert config_from_fields(cfg) == IsingConfig(1.7, 12, 3, 0.5, 2)
    assert config_from_fields({"temperature": 1.7}) == IsingConfig(temperature=1.7)
    with pytest.raises(ConfigurationError):
        config_from_fields({"beta": 1.0})


def test_import_pulls_in_no_jax_or_triton_and_builds_nothing():
    code = (
        "import json, sys\n"
        "import torch\n"
        "import tsu_tpu_torch, tsu_tpu_torch.samplers, tsu_tpu_torch.interop\n"
        "from tsu_tpu_torch.models.lattice_sampler import sample_grid_ensemble\n"
        "from tsu_tpu_torch.ops import _build\n"
        "tsu_tpu_torch.IsingGrid((4, 4), seed=0, device='cpu').sample(n_samples=2)\n"
        "sample_grid_ensemble(torch.Generator().manual_seed(0), torch.ones(3, 4, 4),\n"
        "                     [1.5, 2.5, 3.5], n_samples=2, n_burnin=2)\n"
        "J = torch.ones(4, 4)\n"
        "tsu_tpu_torch.IsingGrid((4, 4), seed=0, bonds=(J, -J), device='cpu').sample(\n"
        "    n_samples=2)\n"
        "tsu_tpu_torch.parallel_tempering_bonds(0, J, -J, temperatures=[1.0, 2.0],\n"
        "                                       n_samples=2, n_burnin=2, device='cpu')\n"
        "mesh = tsu_tpu_torch.make_mesh(rows=2, cols=2, devices=['cpu'] * 4)\n"
        "tsu_tpu_torch.IsingGrid((8, 8), seed=0, device='cpu').sample_observables(\n"
        "    n_samples=2, mesh=mesh)\n"
        "tsu_tpu_torch.sample_langevin(0, [[0.0]], energy_fn=tsu_tpu_torch.Quadratic(),\n"
        "                              n_samples=2, n_burnin=2, device='cpu')\n"
        "print(json.dumps({'jax': 'jax' in sys.modules,\n"
        "                  'triton': 'triton' in sys.modules,\n"
        "                  'built': _build.fused_sweep_library.cache_info().currsize\n"
        "                  + _build.bond_sweep_library.cache_info().currsize\n"
        "                  + _build.halfsweep_library.cache_info().currsize}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.splitlines()[-1]) == {
        "jax": False, "triton": False, "built": 0}


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = fused_sweep.launches, fused_sweep_batched.launches
    with pytest.raises(ConfigurationError):
        IsingGrid((8, 8), device="cuda")
    with pytest.raises(ConfigurationError):
        demonstrate_phase_transition(sizes=[8], device="cuda")
    assert (fused_sweep.launches, fused_sweep_batched.launches) == before


def test_default_device_is_the_card(monkeypatch):
    """Entry points run on the card unless the caller asks for the CPU:
    without CUDA the default raises, and device="cpu" is the plain path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigurationError, match="CUDA is not available"):
        IsingGrid((4, 4), seed=0)
    assert IsingGrid((4, 4), seed=0, device="cpu").device == torch.device("cpu")


class _Quadratic(tsu_tpu_torch.OptimizationProblem):
    """A problem without ``to_ising`` whose objective is numpy only."""

    def objective(self, x):
        return float(np.sum(np.asarray(x) ** 2))

    @property
    def dimension(self):
        return 2


class _TorchQuadratic(tsu_tpu_torch.OptimizationProblem):
    """A problem without ``to_ising`` written with torch operations:
    minimum 0 at (1, -2)."""

    def objective(self, x):
        return torch.sum((x - torch.tensor([1.0, -2.0], device=x.device)) ** 2)

    @property
    def dimension(self):
        return 2


@pytest.mark.parametrize("call", [
    lambda: tsu_tpu_torch.IsingChain(4, device="cpu").visualize(np.ones(4)),
])
def test_later_slices_raise_not_implemented(call):
    # Slice 7 ported the last feature held back here (IsingChain.visualize):
    # the call now draws the chain instead of raising.
    fig = call()
    assert np.asarray(fig.axes[0].images[0].get_array()).shape == (1, 4)


def test_optimize_rejects_an_objective_it_cannot_differentiate():
    """As the reference does for an untraceable objective: the annealed
    Langevin fallback needs torch.func.grad of the objective."""
    with pytest.raises(ConfigurationError, match="cannot be differentiated"):
        tsu_tpu_torch.optimize(_Quadratic(), seed=0, device="cpu")


def test_optimize_anneals_a_torch_objective_to_its_minimum():
    res = tsu_tpu_torch.optimize(_TorchQuadratic(), n_steps=300, seed=0, device="cpu")
    np.testing.assert_allclose(res["best_solution"], [1.0, -2.0], atol=0.1)
    assert res["best_objective"] < 0.02
    assert res["n_steps"] == 300


def _sample_dense_5x4():
    grid = IsingGrid((5, 4), periodic=True, seed=0, device="cpu",
                     config=IsingConfig(n_burnin=5, n_sweeps=1))
    ref = JaxIsingGrid((5, 4), periodic=True, use_pallas=False)
    assert np.array_equal(grid.J, ref.J)
    return grid.sample(8)


def _sample_after_non_local_coupling():
    grid = IsingGrid((4, 4), seed=0, device="cpu", config=IsingConfig(n_burnin=5, n_sweeps=1))
    grid.set_coupling(0, 5, 1.0)
    ref = JaxIsingGrid((4, 4), use_pallas=False)
    ref.set_coupling(0, 5, 1.0)
    assert np.array_equal(grid.J, ref.J)
    return grid.sample(8)


def _anneal_with_checkpoint(tmp_path):
    best, e = tsu_tpu_torch.anneal_spin_glass(
        0, np.ones((4, 4)), np.ones((4, 4)), n_steps=50,
        checkpoint_path=str(tmp_path / "ck"), device="cpu")
    assert (tmp_path / "ck").is_file() and e == -32.0
    return best


def _scan_with_odd_size(tmp_path):
    out = demonstrate_phase_transition(sizes=[8, 5], temperatures=[2.0], n_samples=1,
                                       device="cpu")
    assert sorted(out) == [5, 8]
    return np.concatenate([out[5]["magnetization"], out[8]["magnetization"]])


def _sharded_with_checkpoint_path(tmp_path):
    out = tsu_tpu_torch.sharded_lattice_sample(
        tsu_tpu_torch.make_mesh(rows=2, devices=["cpu"] * 2), 0, torch.ones(4, 4),
        n_samples=1, temperature=2.0, checkpoint_path=str(tmp_path / "ck"))
    assert not (tmp_path / "ck").exists()      # checkpoint_every = 0: no snapshots
    return out["magnetization"].numpy()


@pytest.mark.parametrize("call", [
    lambda tmp: _sample_dense_5x4(),
    lambda tmp: _sample_after_non_local_coupling(),
    _anneal_with_checkpoint,
    _scan_with_odd_size,
    _sharded_with_checkpoint_path,
])
def test_calls_of_earlier_not_ported_slices_now_run(call, tmp_path):
    """The calls that raised "not ported" before slice 4 and checkpoint.py
    came: each runs and returns spins or observables in range."""
    out = np.asarray(call(tmp_path))
    assert np.all(np.isfinite(out)) and np.all(np.abs(out) <= 1.0)


def test_non_local_coupling_on_a_grid_with_bonds_raises():
    """As the JAX package: bond planes do not mix with non-local couplings."""
    grid = IsingGrid((4, 4), bonds=(np.ones((4, 4)), np.ones((4, 4))), device="cpu")
    with pytest.raises(ConfigurationError, match="mix"):
        grid.set_coupling(0, 5, 1.0)


def test_find_ground_state_returns_a_flat_state_and_its_energy():
    """An open 8x6 ferromagnet anneals to E0 = -(8*5 + 7*6); the state
    returned is flat, uniform and has the energy returned."""
    grid = IsingGrid((8, 6), periodic=False, seed=1, device="cpu")
    state, energy = grid.find_ground_state(n_steps=400)
    assert energy == -82.0
    assert state.shape == (48,) and state.dtype == np.float32
    assert abs(state.mean()) == 1.0 and grid.energy(state) == energy


def test_bad_shapes_and_configs_raise():
    with pytest.raises(ConfigurationError):
        IsingGrid((0, 4), device="cpu")
    with pytest.raises(ConfigurationError):
        IsingConfig(temperature=0.0)
    assert tsu_tpu_torch.IsingConfig is IsingConfig
