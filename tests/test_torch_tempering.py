"""The port's lattice parallel tempering on the CPU, against tsu_tpu's swap
rule, its swap acceptance and exact enumeration."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tsu_tpu.oracle import exact_ising_moments  # noqa: E402
from tsu_tpu.samplers.tempering import _swap_permutation as jax_swap  # noqa: E402
from tsu_tpu.samplers.tempering import parallel_tempering_lattice as jax_pt  # noqa: E402
from tsu_tpu_torch.ops.checkerboard import (  # noqa: E402
    lattice_energy_batch,
    plane_energy_batch,
    split_checkerboard,
)
from tsu_tpu_torch.samplers import parallel_tempering_lattice  # noqa: E402
from tsu_tpu_torch.samplers.tempering import _swap_permutation  # noqa: E402

LADDER = np.geomspace(1.8, 3.0, 6).astype(np.float32)
_jax_swap = jax.jit(jax_swap, static_argnums=3)   # one compile per R beats eager dispatch


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("periodic,shape,field", [
    (True, (3, 6, 8), 0.0), (False, (3, 6, 8), 0.3), (True, (2, 2, 2), 0.3),
    (False, (2, 4, 2), 0.0)])
def test_plane_energy_is_lattice_energy(periodic, shape, field, dtype):
    """The energy taken from the planes, which tempering, the annealer and the
    ensemble use, equals the stencil energy of the merged lattice, down to
    2-wide lattices whose wrapped bonds count twice."""
    lat = torch.from_numpy(np.where(np.random.default_rng(7).random(shape) < 0.5, 1.0, -1.0))
    red, black = split_checkerboard(lat.to(dtype))
    want = lattice_energy_batch(lat, J=0.8, field=field, periodic=periodic)
    got = plane_energy_batch(red, black, J=0.8, field=field, periodic=periodic)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("R", range(2, 10))
def test_swap_permutation_is_jax_swap(R, offset):
    """JAX's own uniforms handed to the port, integer energies a few units
    apart so that some pairs accept and some refuse."""
    key = jax.random.key(100 * R + offset)
    u = np.array(jax.random.uniform(key, (R,)))
    rng = np.random.default_rng(R + 10 * offset)
    energies = rng.integers(-40, 40, R).astype(np.float32)
    betas = (1.0 / np.linspace(1.5, 3.5, R)).astype(np.float32)
    want = _jax_swap(key, jnp.asarray(energies), jnp.asarray(betas), offset)
    got = _swap_permutation(torch.from_numpy(u), torch.from_numpy(energies).double(),
                            torch.from_numpy(betas), offset)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cold_rung_matches_exact_enumeration():
    """4 rungs from T = 2.0 to 3.0 on the periodic 4x4 lattice: the cold
    rung's <|m|> and <e> per site within 4 standard errors of T = 2.0."""
    cold, info = parallel_tempering_lattice(0, (4, 4), temperatures=np.linspace(2.0, 3.0, 4),
                                            n_samples=1500, swap_interval=1, n_burnin=50)
    m = cold.double().mean((1, 2)).abs().numpy()
    e = lattice_energy_batch(cold).numpy() / 16
    exact = exact_ising_moments(_dense_grid_couplings(4, 4), np.zeros(16), 2.0)
    assert abs(m.mean() - exact["abs_magnetization"]) < 4 * _batch_means_se(m)
    assert abs(e.mean() - exact["energy"] / 16) < 4 * _batch_means_se(e)
    assert info["swap_accepts"] > 0


@pytest.fixture(scope="module")
def both_runs():
    kw = dict(temperatures=LADDER, n_samples=600, swap_interval=1, n_burnin=50)
    port = parallel_tempering_lattice(1, (8, 8), **kw)
    ref = jax_pt(jax.random.key(1), (8, 8), use_pallas=False, **kw)
    return port, ref


def test_swap_acceptance_matches_jax(both_runs):
    """Overall acceptance within 0.05 of the JAX package's on the same 8x8,
    6-rung ladder (about 1,500 attempts each: a binomial SE near 0.013)."""
    (_, port), (_, ref) = both_runs
    assert port["swap_attempts"] == ref["swap_attempts"]
    assert abs(port["swap_acceptance_rate"] - ref["swap_acceptance_rate"]) < 0.05


def test_info_keys_and_shapes_are_jax(both_runs):
    (cold, port), (cold_j, ref) = both_runs
    assert tuple(cold.shape) == cold_j.shape == (600, 8, 8)
    assert port.keys() == ref.keys()
    for k in ref:
        assert np.shape(port[k]) == np.shape(ref[k]), k
    np.testing.assert_array_equal(port["pair_attempts"], ref["pair_attempts"])
    # The last round swapped: the final states carry its energies, permuted.
    final_e = lattice_energy_batch(torch.from_numpy(port["final_states"])).numpy()
    np.testing.assert_array_equal(np.sort(final_e), np.sort(port["energies"][-1]))
