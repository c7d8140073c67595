"""The port's dense Ising models and MAX-CUT on the CPU against the JAX
package and exact enumeration: IsingModel, IsingChain, odd grids, non-local
couplings and their ConfigurationError rules, optimize."""

import itertools

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from tsu_tpu.api import MaxCutProblem as JaxMaxCutProblem  # noqa: E402
from tsu_tpu.energy import DenseBoltzmann as JaxDenseBoltzmann  # noqa: E402
from tsu_tpu.energy import DenseIsing as JaxDenseIsing  # noqa: E402
from tsu_tpu.energy import ising_to_boltzmann as jax_ising_to_boltzmann  # noqa: E402
from tsu_tpu.models.ising import IsingChain as JaxIsingChain  # noqa: E402
from tsu_tpu.models.ising import IsingGrid as JaxIsingGrid  # noqa: E402
from tsu_tpu.models.ising import IsingModel as JaxIsingModel  # noqa: E402
from tsu_tpu.oracle import exact_ising_moments  # noqa: E402
from tsu_tpu_torch import (  # noqa: E402
    ConfigurationError,
    IsingChain,
    IsingConfig,
    IsingGrid,
    IsingModel,
    MaxCutProblem,
    SamplingError,
    optimize,
)
from tsu_tpu_torch.energy import DenseBoltzmann, DenseIsing, ising_to_boltzmann  # noqa: E402
from tsu_tpu_torch.interop import dense_model_from_numpy  # noqa: E402

CPU = "cpu"


def _spin_glass(seed, n):
    rng = np.random.default_rng(seed)
    J = rng.normal(0, 0.6, (n, n))
    J = np.triu(J, 1)
    return (J + J.T).astype(np.float32), rng.normal(0, 0.3, n).astype(np.float32)


def _check_moments(model, T, n_samples=4000):
    """Energy and m^2 against enumeration; tests/test_ising.py's bounds
    (0.05 per spin on <E>, 0.05 on <m^2>)."""
    exact = exact_ising_moments(model.J, model.h, T)
    s = model.sample(n_samples, temperature=T)
    assert s.shape == (n_samples, model.n_spins) and set(np.unique(s)) <= {-1.0, 1.0}
    e = model.energies(s)
    assert abs(e.mean() - exact["energy"]) / model.n_spins < 0.05
    assert abs((s.mean(axis=1) ** 2).mean() - exact["m2"]) < 0.05


def test_random_model_matches_enumeration():
    J, h = _spin_glass(1, 10)
    model = dense_model_from_numpy(J, h, config=IsingConfig(n_burnin=100, n_sweeps=2,
                                                            n_chains=8), seed=0, device=CPU)
    assert isinstance(model, IsingModel) and np.array_equal(model.J, J)
    _check_moments(model, 1.3)


def test_periodic_chain_matches_enumeration():
    chain = IsingChain(12, J=1.0, seed=2, device=CPU,
                       config=IsingConfig(n_burnin=100, n_sweeps=2, n_chains=8))
    chain.set_coupling(11, 0, 1.0)
    ref = JaxIsingChain(12, J=1.0)
    ref.set_coupling(11, 0, 1.0)
    assert np.array_equal(chain.J, ref.J)
    _check_moments(chain, 1.5)


@pytest.mark.parametrize("shape,periodic", [((3, 5), True), ((3, 3), False), ((1, 7), True)])
def test_odd_grid_falls_back_to_the_dense_engine(shape, periodic):
    grid = IsingGrid(shape, periodic=periodic, seed=3, device=CPU,
                     config=IsingConfig(n_burnin=100, n_sweeps=2, n_chains=8))
    ref = JaxIsingGrid(shape, periodic=periodic, use_pallas=False)
    assert not grid._fast and np.array_equal(grid.J, ref.J)
    _check_moments(grid, 2.0)
    obs = grid.sample_observables(10, temperature=2.0)
    assert obs["magnetization"].shape == (10,) and obs["energy"].shape == (10,)
    state = np.ones(grid.n_spins)
    assert grid.energy(state.reshape(shape)) == ref.energy(state)


def test_non_local_coupling_moves_an_even_grid_to_the_dense_engine():
    grid = IsingGrid((4, 4), periodic=True, seed=4, device=CPU,
                     config=IsingConfig(n_burnin=100, n_sweeps=2, n_chains=8))
    ref = JaxIsingGrid((4, 4), periodic=True, use_pallas=False)
    for g in (grid, ref):
        g.set_coupling(0, 10, 0.7)        # not a neighbour: the dense engine
        g.set_coupling(0, 1, -0.5)        # a neighbour, now in the dense J
    assert not grid._fast and np.array_equal(grid.J, ref.J)
    _check_moments(grid, 2.0)


@pytest.mark.parametrize("call,match", [
    (lambda: IsingGrid((66, 66), device=CPU).set_coupling(0, 100, 1.0), "4096"),
    (lambda: IsingGrid((65, 65), device=CPU), "4096"),
    (lambda: IsingGrid((3, 4), device=CPU, bonds=(np.ones((3, 4)), np.ones((3, 4)))), "even"),
    (lambda: IsingGrid((4, 4), device=CPU, bonds=(np.ones((4, 4)), np.ones((4, 4))))
     .set_coupling(0, 6, 1.0), "mix"),
    (lambda: IsingModel(0, device=CPU), "positive"),
    (lambda: IsingModel(3, device=CPU).set_coupling(1, 1, 1.0), "self"),
    (lambda: IsingModel(3, device=CPU).set_coupling(0, 3, 1.0), "range"),
    (lambda: IsingModel(3, device=CPU).set_external_field(np.ones(2)), "shape"),
])
def test_configuration_errors_of_the_reference(call, match):
    """The dense limit, bonds only on even grids, no mixing of bond planes
    with non-local couplings, and the model's argument checks."""
    with pytest.raises(ConfigurationError, match=match):
        call()


def test_energies_match_the_reference_model():
    J, h = _spin_glass(5, 9)
    ours = IsingModel(9, device=CPU)
    ref = JaxIsingModel(9)
    for m in (ours, ref):
        m.J = J.copy()
        m.set_external_field(h)
    s = np.random.default_rng(6).choice([-1.0, 1.0], (20, 9))
    assert ours.energies(s).dtype == np.float64
    np.testing.assert_allclose(ours.energies(s), ref.energies(s), rtol=0, atol=1e-4)
    assert ours.energy(s[0]) == pytest.approx(ref.energy(s[0]), abs=1e-9)
    with pytest.raises(SamplingError):
        ours.energy(np.ones(8))
    for a, b in zip(ising_to_boltzmann(J, h), jax_ising_to_boltzmann(J, h)):
        np.testing.assert_array_equal(a, np.asarray(b))
    bits = (s[:3] + 1) / 2
    tJ, th = torch.tensor(J), torch.tensor(h)
    np.testing.assert_allclose(DenseIsing(tJ, th)(torch.tensor(s[:3], dtype=torch.float32)),
                               [float(JaxDenseIsing(J, h)(x)) for x in s[:3]], atol=1e-5)
    np.testing.assert_allclose(DenseBoltzmann(tJ, th)(torch.tensor(bits, dtype=torch.float32)),
                               [float(JaxDenseBoltzmann(J, h)(x)) for x in bits], atol=1e-5)
    Jb, hb = ising_to_boltzmann(tJ, th)
    assert isinstance(Jb, torch.Tensor) and torch.equal(Jb, 4.0 * tJ)


def test_bit_model_energies_differ_by_a_constant():
    """ising_to_boltzmann keeps the Gibbs conditionals: E_spin(2b - 1) -
    E_bit(b) is one constant over every state."""
    J, h = _spin_glass(7, 6)
    Jb, hb = ising_to_boltzmann(J, h)
    bits = np.array(list(itertools.product([0.0, 1.0], repeat=6)))
    spins = 2 * bits - 1
    diff = (DenseIsing(torch.tensor(J), torch.tensor(h))(torch.tensor(spins, dtype=torch.float32))
            - DenseBoltzmann(torch.tensor(Jb), torch.tensor(hb))(
                torch.tensor(bits, dtype=torch.float32)))
    assert float(diff.max() - diff.min()) < 1e-4


def test_find_ground_state_of_a_ferromagnetic_chain():
    chain = IsingChain(10, J=1.0, seed=0, device=CPU)
    state, e = chain.find_ground_state(n_steps=300)
    assert e == -9.0 and abs(state.sum()) == 10


def _brute_max_cut(W):
    n = len(W)
    best = 0.0
    for s in itertools.product([-1.0, 1.0], repeat=n - 1):
        s = np.array((1.0,) + s)
        best = max(best, 0.25 * float(np.sum(W * (1.0 - np.outer(s, s)))))
    return best


def _k33():
    W = np.zeros((6, 6), np.float32)
    W[:3, 3:] = 1.0
    return W + W.T


def _g15():
    rng = np.random.default_rng(15)
    W = np.triu((rng.random((15, 15)) < 0.4) * rng.integers(1, 4, (15, 15)), 1)
    return (W + W.T).astype(np.float32)


@pytest.mark.parametrize("W,seed", [(_k33(), 0), (_g15(), 1), (_g15(), torch.Generator()
                                                               .manual_seed(3))],
                         ids=["K33", "G15", "G15-generator"])
def test_optimize_max_cut_reaches_enumeration(W, seed):
    problem = MaxCutProblem(W)
    out = optimize(problem, n_steps=400, seed=seed, device=CPU)
    exact = _brute_max_cut(W)
    assert out["best_objective"] == -exact
    assert problem.cut_value(out["best_solution"]) == exact
    ref = JaxMaxCutProblem(W)
    assert ref.objective(out["best_solution"]) == out["best_objective"]
    J, h = problem.to_ising()
    assert np.array_equal(J, -W) and not h.any() and problem.dimension == len(W)
    assert set(out) == {"best_solution", "best_objective", "time_elapsed", "n_steps"}


def test_optimize_on_the_device_route_reaches_enumeration():
    """A problem above the native route's size (n > 256) anneals on the
    colour sweeps: two disjoint copies of K3,3 inside 300 nodes."""
    W = np.zeros((300, 300), np.float32)
    W[:6, :6] = _k33()
    W[100:106, 100:106] = _k33()
    out = optimize(MaxCutProblem(W), n_steps=200, n_chains=2, seed=5, device=CPU)
    assert out["best_objective"] == -18.0


def test_max_cut_problem_rejects_a_non_square_matrix():
    with pytest.raises(ConfigurationError):
        MaxCutProblem(np.ones((2, 3)))
