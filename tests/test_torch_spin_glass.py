"""The port's spin-glass paths on the CPU: IsingGrid with bonds, the ±J table
gates, anneal_spin_glass and parallel_tempering_bonds, against tsu_tpu and
against exact enumeration."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tsu_tpu.models.ising import IsingGrid as JaxIsingGrid  # noqa: E402
from tsu_tpu.ops.checkerboard_bonds import dense_from_bonds  # noqa: E402
from tsu_tpu.oracle import exact_ising_moments  # noqa: E402
from tsu_tpu.samplers import annealing as jann  # noqa: E402
from tsu_tpu.samplers.tempering import parallel_tempering_bonds as jax_pt_bonds  # noqa: E402
from tsu_tpu_torch import ConfigurationError, IsingConfig, IsingGrid  # noqa: E402
from tsu_tpu_torch.ops.checkerboard_bonds import lattice_energy_bonds  # noqa: E402
from tsu_tpu_torch.samplers import (  # noqa: E402
    anneal_spin_glass,
    discrete_table_applicable,
    parallel_tempering_bonds,
    pure_pm1_applicable,
)


def _pm1(seed, L):
    rng = np.random.default_rng(seed)
    return (rng.choice([-1.0, 1.0], (L, L)).astype(np.float32),
            rng.choice([-1.0, 1.0], (L, L)).astype(np.float32))


def _batch_means_se(x, n_batches=40):
    b = np.asarray(x, np.float64)[: len(x) // n_batches * n_batches]
    return b.reshape(n_batches, -1).mean(axis=1).std(ddof=1) / np.sqrt(n_batches)


def _ground_energy(Jh, Jv, periodic=True):
    J = dense_from_bonds(Jh, Jv, periodic=periodic)
    bits = (np.arange(2**16)[:, None] >> np.arange(16)) & 1
    s = 2.0 * bits - 1.0
    return float((-0.5 * np.einsum("bi,ij,bj->b", s, J, s)).min())


def test_bond_moments_match_exact_enumeration():
    """Gaussian bonds on the periodic 4x4 lattice at T = 2: per-site means
    within 5 standard errors (an effective sample size of a fifth, as the
    JAX package's test takes it), <e> and <m^2> within 4 batch-means SE."""
    rng = np.random.default_rng(0)
    Jh, Jv = rng.normal(0, 0.8, (2, 4, 4)).astype(np.float32)
    g = IsingGrid((4, 4), periodic=True, seed=0, bonds=(Jh, Jv),
                  config=IsingConfig(temperature=2.0, n_burnin=100, n_sweeps=1))
    s = g.sample(n_samples=3000)
    ex = exact_ising_moments(dense_from_bonds(Jh, Jv, True), np.zeros(16), 2.0)
    se = np.sqrt(s.var(axis=0) / (3000 / 5.0))
    assert np.max(np.abs(s.mean(axis=0) - ex["mean"]) / se) < 5.0
    e = g.energies(s)
    m2 = s.mean(axis=1) ** 2
    assert abs(e.mean() - ex["energy"]) < 4 * _batch_means_se(e)
    assert abs(m2.mean() - ex["m2"]) < 4 * _batch_means_se(m2)


def test_observables_match_the_samples_path():
    rng = np.random.default_rng(1)
    Jh, Jv = rng.normal(size=(2, 8, 8)).astype(np.float32)
    g = IsingGrid((8, 8), periodic=False, seed=3, bonds=(Jh, Jv),
                  config=IsingConfig(n_burnin=5, n_sweeps=2))
    out = g.sample_observables(n_samples=4, temperature=1.5)
    s = IsingGrid((8, 8), periodic=False, seed=3, bonds=(Jh, Jv),
                  config=IsingConfig(n_burnin=5, n_sweeps=2)).sample(4, temperature=1.5)
    np.testing.assert_array_equal(out["magnetization"], s.mean(axis=1))
    np.testing.assert_allclose(out["energy"], g.energies(s), rtol=0, atol=1e-5)


@pytest.mark.parametrize("periodic", [True, False])
def test_energies_and_set_coupling_match_jax_grid(periodic):
    Jh, Jv = np.random.default_rng(2).normal(size=(2, 6, 6)).astype(np.float32)
    port = IsingGrid((6, 6), periodic=periodic, seed=0, bonds=(Jh, Jv))
    ref = JaxIsingGrid((6, 6), periodic=periodic, seed=0, use_pallas=False, bonds=(Jh, Jv))
    edits = [(0, 1, 0.5), (0, 6, -2.0), (7, 13, 1.5)] + ([(0, 5, 3.0), (2, 32, -1.0)]
                                                          if periodic else [])
    for i, j, strength in edits:
        port.set_coupling(i, j, strength)
        ref.set_coupling(i, j, strength)
    s = np.where(np.random.default_rng(3).random((5, 36)) < 0.5, 1.0, -1.0).astype(np.float32)
    np.testing.assert_allclose(port.energies(s), ref.energies(s), rtol=0, atol=1e-4)
    uniform = IsingGrid((6, 6), coupling_strength=0.7, periodic=periodic, seed=0)
    uniform.set_coupling(3, 4, -0.7)
    ref_u = JaxIsingGrid((6, 6), coupling_strength=0.7, periodic=periodic, seed=0,
                         use_pallas=False)
    ref_u.set_coupling(3, 4, -0.7)
    np.testing.assert_allclose(uniform.energies(s), ref_u.energies(s), rtol=0, atol=1e-4)


@pytest.mark.parametrize("call,error", [
    (lambda: IsingGrid((4, 4), bonds=(np.ones((4, 4)), np.ones((4, 2)))), ConfigurationError),
    (lambda: IsingGrid((4, 4)).set_bonds(np.ones((2, 4)), np.ones((4, 4))), ConfigurationError),
    (lambda: IsingGrid((4, 4), periodic=False).set_coupling(0, 3, 1.0), NotImplementedError),
    (lambda: anneal_spin_glass(0, np.ones((4, 4)), np.ones((4, 4)), checkpoint_path="ck"),
     NotImplementedError),
    (lambda: anneal_spin_glass(0, np.ones((4, 4)), np.ones((4, 4)), resume=True),
     NotImplementedError),
])
def test_bond_error_paths(call, error):
    with pytest.raises(error):
        call()


@pytest.mark.parametrize("Jh,Jv,field,periodic", [
    (np.ones((8, 8)), -np.ones((8, 8)), 0.0, True),
    (np.ones((8, 8)), -np.ones((8, 8)), 0.0, False),
    (np.ones((8, 8)), -np.ones((8, 8)), 1.0, True),          # integer field: off the table
    (np.ones((8, 8)), -np.ones((8, 8)), 0.5, True),
    (np.ones((8, 8)) * 0.7, -np.ones((8, 8)), 0.0, True),
    (np.eye(8), -np.ones((8, 8)), 0.0, True),                # zero bonds: table, no parity
    (np.full((8, 8), 2.0), np.ones((8, 8)), 0.0, True),
])
def test_table_gates_equal_jax(Jh, Jv, field, periodic):
    assert discrete_table_applicable(Jh, Jv, field) == jann.discrete_table_applicable(
        jnp.asarray(Jh), jnp.asarray(Jv), field)
    assert pure_pm1_applicable(Jh, Jv, field, periodic) == jann.pure_pm1_applicable(
        jnp.asarray(Jh), jnp.asarray(Jv), field, periodic)
    assert not discrete_table_applicable(np.ones((8, 8)), np.ones((8, 8)), 1.0)


@pytest.mark.parametrize("discrete", [True, False])
def test_anneal_returns_a_state_and_its_energy_and_beats_a_quench(discrete):
    """8x8 periodic, 400 steps, 2 restarts: e/site below -1.2 (a random state
    sits near 0, the ±J ground state near -1.4) and the energy returned is
    lattice_energy_bonds of the state returned."""
    Jh, Jv = _pm1(4, 8)
    if not discrete:
        Jh = Jh * 1.05
    state, e = anneal_spin_glass(2, Jh, Jv, n_steps=400, n_restarts=2)
    assert state.shape == (8, 8) and state.dtype == np.float32
    assert set(np.unique(state)) <= {-1.0, 1.0}
    assert e / 64 < -1.2 * (1.05 if not discrete else 1.0)
    assert e == float(lattice_energy_bonds(torch.from_numpy(state), Jh, Jv))


def test_anneal_reaches_the_exact_ground_state():
    Jh, Jv = _pm1(5, 4)
    _, e = anneal_spin_glass(0, Jh, Jv, n_steps=300, n_restarts=2)
    assert e == _ground_energy(Jh, Jv)


def test_find_ground_state_with_bonds_and_seed_reproducibility():
    Jh, Jv = _pm1(6, 8)
    a = IsingGrid((8, 8), periodic=True, seed=4, bonds=(Jh, Jv)).find_ground_state(200)
    b = IsingGrid((8, 8), periodic=True, seed=4, bonds=(Jh, Jv)).find_ground_state(200)
    assert a[0].shape == (64,) and a[1] == b[1] and np.array_equal(a[0], b[0])
    grid = IsingGrid((8, 8), periodic=True, seed=4, bonds=(Jh, Jv))
    assert grid.energy(a[0]) == a[1]


@pytest.fixture(scope="module")
def pt_runs():
    Jh, Jv = _pm1(7, 8)
    kw = dict(temperatures=np.geomspace(0.6, 2.0, 5), n_samples=40, n_burnin=10,
              swap_interval=2)
    port = parallel_tempering_bonds(1, Jh, Jv, **kw)
    ref = jax_pt_bonds(jax.random.key(1), Jh, Jv, use_pallas=False, **kw)
    return port, ref


def test_pt_bonds_info_keys_and_shapes_are_jax(pt_runs):
    (cold, port), (cold_j, ref) = pt_runs
    assert tuple(cold.shape) == cold_j.shape == (40, 8, 8)
    assert port.keys() == ref.keys()
    for k in ref:
        assert np.shape(port[k]) == np.shape(ref[k]), k
    np.testing.assert_array_equal(port["pair_attempts"], ref["pair_attempts"])
    assert port["discrete_table_path"] is True
    final_e = lattice_energy_bonds(torch.from_numpy(port["final_states"]),
                                   *_pm1(7, 8)).numpy()
    np.testing.assert_array_equal(np.sort(final_e), np.sort(port["energies"][-1]))


def test_pt_bonds_cold_rung_matches_exact_enumeration():
    """A 4x4 ±J instance, 4 rungs from T = 1.0 to 2.0: the cold rung's <e>
    and <m^2> within 4 batch-means SE of enumeration at T = 1.0."""
    Jh, Jv = _pm1(8, 4)
    cold, info = parallel_tempering_bonds(2, Jh, Jv, temperatures=np.linspace(1.0, 2.0, 4),
                                          n_samples=3000, n_burnin=50, swap_interval=1)
    ex = exact_ising_moments(dense_from_bonds(Jh, Jv, True), np.zeros(16), 1.0)
    e = lattice_energy_bonds(cold, Jh, Jv).numpy()
    m2 = cold.double().mean((1, 2)).numpy() ** 2
    assert abs(e.mean() - ex["energy"]) < 4 * _batch_means_se(e)
    assert abs(m2.mean() - ex["m2"]) < 4 * _batch_means_se(m2)
    assert info["swap_accepts"] > 0


def test_pt_bonds_identical_temperatures_always_swap():
    _, info = parallel_tempering_bonds(3, *_pm1(9, 8), temperatures=[1.0, 1.0, 1.0],
                                       n_samples=16, n_burnin=4, swap_interval=1)
    assert np.all(info["pair_acceptance"] == 1.0)
    assert int(info["pair_attempts"].sum()) == info["swap_attempts"]
