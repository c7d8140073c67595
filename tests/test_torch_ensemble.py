"""The port's ensemble sampler and phase-transition scan on the CPU, against
tsu_tpu's (its XLA path, use_pallas=False) and exact enumeration."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tsu_tpu.models.ising import demonstrate_phase_transition as jax_phase  # noqa: E402
from tsu_tpu.models.lattice_sampler import sample_grid_ensemble as jax_ensemble  # noqa: E402
from tsu_tpu.ops.checkerboard import lattice_energy_batch as jax_energy  # noqa: E402
from tsu_tpu.ops.checkerboard import split_checkerboard as jax_split  # noqa: E402
from tsu_tpu.oracle import exact_ising_moments  # noqa: E402
from tsu_tpu_torch import demonstrate_phase_transition  # noqa: E402
from tsu_tpu_torch.interop import lattice_to_planes  # noqa: E402
from tsu_tpu_torch.models.lattice_sampler import sample_grid_ensemble  # noqa: E402
from tsu_tpu_torch.ops.checkerboard import (  # noqa: E402
    lattice_energy_batch,
    merge_checkerboard,
)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _dense_grid_couplings(R, C):
    J = np.zeros((R * C, R * C))
    for r in range(R):
        for c in range(C):
            i = r * C + c
            for j in (r * C + (c + 1) % C, ((r + 1) % R) * C + c):
                J[i, j] = J[j, i] = 1.0
    return J


def _batch_means_se(x, n_batches=30):
    b = np.asarray(x, np.float64)[: len(x) // n_batches * n_batches]
    return b.reshape(n_batches, -1).mean(axis=1).std(ddof=1) / np.sqrt(n_batches)


def test_observable_shapes_and_physics_like_jax():
    """tests/test_ising.py::TestEnsembleSampler::test_observable_shapes_and_physics,
    on the port and on the JAX package: same shapes, same physics."""
    Ts = [1.0, 2.269, 4.0]
    port = sample_grid_ensemble(_gen(0), torch.ones((3, 8, 8)), Ts, n_samples=30,
                                n_burnin=50)
    ref = jax_ensemble(jax.random.key(0), jnp.ones((3, 8, 8)), jnp.asarray(Ts, jnp.float32),
                       n_samples=30, n_burnin=50, use_pallas=False)
    assert set(port) == set(ref) == {"magnetization", "energy"}
    for out in (port, ref):
        m, e = np.asarray(out["magnetization"]), np.asarray(out["energy"])
        assert m.shape == e.shape == (30, 3)
        assert abs(m[:, 0].mean()) > 0.9
        assert abs(m[:, 2].mean()) < 0.4
        assert e[:, 0].mean() < e[:, 2].mean()
    assert port["energy"].dtype == torch.float64


def test_members_at_one_temperature_are_decorrelated():
    out = sample_grid_ensemble(_gen(1), torch.ones((2, 8, 8)), [2.8, 2.8],
                               n_samples=40, n_burnin=30)
    m = out["magnetization"].numpy()
    assert not np.allclose(m[:, 0], m[:, 1])


def test_member_matches_exact_enumeration():
    """8 periodic 4x4 members at T = 2.5: <|m|> and <e> per site within 4
    standard errors (batch means over the member-averaged series)."""
    T = 2.5
    out = sample_grid_ensemble(_gen(2), torch.ones((8, 4, 4)), T, n_samples=1500,
                               n_burnin=50)
    m = out["magnetization"].abs().mean(1).numpy()
    e = out["energy"].mean(1).numpy() / 16
    exact = exact_ising_moments(_dense_grid_couplings(4, 4), np.zeros(16), T)
    assert abs(m.mean() - exact["abs_magnetization"]) < 4 * _batch_means_se(m)
    assert abs(e.mean() - exact["energy"] / 16) < 4 * _batch_means_se(e)


@pytest.mark.parametrize("ensemble", [True, False])
def test_phase_transition_like_jax(ensemble):
    """The phase scan of tests/test_ising.py::TestEnsembleSampler, ensemble and
    per-T loop: the same keys and shapes as the JAX scan, ordered at T = 1.2
    and disordered at T = 3.6."""
    Ts = np.array([1.2, 3.6])
    port = demonstrate_phase_transition(sizes=[8], temperatures=Ts, n_samples=40, seed=0,
                                        ensemble=ensemble, device="cpu")
    ref = jax_phase(sizes=[8], temperatures=Ts, n_samples=40, seed=0, ensemble=ensemble)
    assert port.keys() == ref.keys() == {8}
    assert port[8].keys() == ref[8].keys()
    for k in ref[8]:
        assert np.shape(port[8][k]) == np.shape(ref[8][k]), k
    np.testing.assert_array_equal(port[8]["temperatures"], Ts)
    assert port[8]["magnetization"][0] > 0.9
    assert port[8]["magnetization"][1] < 0.45


def test_interop_carries_a_jax_ensemble():
    """A (B, R, C) ensemble made by JAX crosses through lattice_to_planes and
    gives the same planes, magnetizations and energies on both sides."""
    lats = jnp.where(jax.random.bernoulli(jax.random.key(3), 0.5, (3, 8, 10)), 1.0, -1.0)
    red, black = lattice_to_planes(np.asarray(lats))
    red_j, black_j = jax.vmap(jax_split)(lats)
    np.testing.assert_array_equal(red.numpy(), np.asarray(red_j))
    np.testing.assert_array_equal(black.numpy(), np.asarray(black_j))
    lat = merge_checkerboard(red, black)
    for periodic in (True, False):
        np.testing.assert_array_equal(
            lattice_energy_batch(lat, periodic=periodic).numpy(),
            np.asarray(jax_energy(lats, periodic=periodic), np.float64))
    np.testing.assert_array_equal(lat.double().sum((1, 2)).numpy() / 80,
                                  np.asarray(lats.sum((1, 2)), np.float64) / 80)
