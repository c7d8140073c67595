"""The port's compact layout, neighbour sums, energies and RNG against tsu_tpu.

Inputs are made with numpy from a seed and handed to both packages; the
layout, neighbour sums, energies and fold_seed must agree exactly.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tsu_tpu.energy import lattice_ising_energy as jax_lattice_ising_energy  # noqa: E402
from tsu_tpu.ops import checkerboard as jcb  # noqa: E402
from tsu_tpu.ops.checkerboard_pallas import fold_seed as jax_fold_seed  # noqa: E402
from tsu_tpu.oracle import exact_ising_moments  # noqa: E402
from tsu_tpu_torch.energy import (  # noqa: E402
    bits_to_spins,
    lattice_ising_energy,
    spins_to_bits,
)
from tsu_tpu_torch.ops import checkerboard as tcb  # noqa: E402
from tsu_tpu_torch.rng import fold_seed, philox4x32, philox_words  # noqa: E402

SHAPES = [(8, 8), (12, 16), (6, 10)]


def _lattice(seed, shape):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(shape) < 0.5, 1.0, -1.0).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_split_merge_match_jax(shape):
    lat = _lattice(1, (3,) + shape)
    r_j, b_j = jcb.split_checkerboard(jnp.asarray(lat))
    r_t, b_t = tcb.split_checkerboard(torch.from_numpy(lat))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
    np.testing.assert_array_equal(tcb.merge_checkerboard(r_t, b_t).numpy(), lat)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("update_red", [True, False])
def test_neighbor_sum_half_halo_matches_jax(shape, periodic, update_red):
    other = _lattice(2, (shape[0], shape[1] // 2))
    up_j, down_j = jcb.wrap_halos(jnp.asarray(other), periodic)
    want = jcb.neighbor_sum_half_halo(jnp.asarray(other), up_j, down_j,
                                      update_red, periodic)
    o = torch.from_numpy(other)
    up, down = tcb.wrap_halos(o, periodic)
    got = tcb.neighbor_sum_half_halo(o, up, down, update_red, periodic)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tcb.neighbor_sum_half(o, update_red, periodic).numpy(), np.asarray(want))


@pytest.mark.parametrize("periodic", [True, False])
def test_lattice_energy_matches_jax(periodic):
    lats = _lattice(3, (4, 12, 10))
    want = jcb.lattice_energy_batch(jnp.asarray(lats), J=1.0, field=0.25,
                                    periodic=periodic)
    got = tcb.lattice_energy_batch(torch.from_numpy(lats), J=1.0, field=0.25,
                                   periodic=periodic)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float64))
    for lat in lats:
        assert float(lattice_ising_energy(torch.from_numpy(lat), 1.0, 0.25,
                                          periodic)) == float(
            jax_lattice_ising_energy(jnp.asarray(lat), 1.0, 0.25, periodic))


def test_spin_bit_maps_roundtrip():
    s = torch.from_numpy(_lattice(4, (5, 6)))
    b = spins_to_bits(s)
    assert set(b.unique().tolist()) <= {0.0, 1.0}
    assert torch.equal(bits_to_spins(b), s)


def test_fold_seed_matches_jax():
    values = [0, 1, -1, 7, 2**31 - 1, -(2**31), 123456789, -987654321,
              1_000_033, 2**30]
    for v in values:
        assert fold_seed(v) == int(jax_fold_seed(jnp.int32(v)))
    for a, b in [(0, 0), (5, -3), (-(2**31), 2**31 - 1), (42, 1_000_033)]:
        assert fold_seed(a, b) == int(jax_fold_seed(jnp.int32(a), jnp.int32(b)))


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    cases = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        out = philox4x32(tuple(torch.tensor([c]) for c in ctr), *key)
        assert tuple(int(o) for o in out) == want


def test_philox_words_layout():
    """Site (r, c) holds output c % 4 of the counter (r, c // 4, 0, 0)."""
    words = philox_words(11, 3, 4, 10)
    for r, c in [(0, 0), (1, 5), (3, 9), (2, 7)]:
        out = philox4x32(tuple(torch.tensor([v]) for v in (r, c // 4, 0, 0)), 11, 3)
        assert int(words[r, c]) == int(out[c % 4])


def test_philox_halves_uniform():
    """lo16 and hi16 of ~2^19 site words are uniform over 2^16 values
    (chi-square within 6 standard deviations of its mean)."""
    words = philox_words(fold_seed(2024), 0, 1024, 512).reshape(-1)
    dof = 2**16 - 1
    expected = words.numel() / 2**16
    for half in (words & 0xFFFF, words >> 16):
        counts = torch.bincount(half, minlength=2**16).double()
        chi2 = float(((counts - expected) ** 2 / expected).sum())
        assert abs(chi2 - dof) < 6 * np.sqrt(2 * dof), chi2


def test_philox_neighbouring_counters_and_keys_differ():
    base = philox_words(fold_seed(9), 4, 64, 64)
    assert (base[1:] == base[:-1]).float().mean() < 1e-3
    assert (base[:, 1:] == base[:, :-1]).float().mean() < 1e-3
    for other in (philox_words(fold_seed(10), 4, 64, 64),
                  philox_words(fold_seed(9), 5, 64, 64)):
        assert (other == base).float().mean() < 1e-3


def test_temperature_schedule_matches_per_sweep_calls():
    lat = torch.from_numpy(_lattice(5, (8, 8)))
    red, black = tcb.split_checkerboard(lat)
    Ts = [4.0, 2.0, 0.5]
    g1 = torch.Generator().manual_seed(3)
    r_s, b_s = tcb.checkerboard_sweeps_planes(g1, red, black, torch.tensor(Ts), 3)
    g2 = torch.Generator().manual_seed(3)
    r_m, b_m = red, black
    for T in Ts:
        r_m, b_m = tcb.checkerboard_sweeps_planes(g2, r_m, b_m, T, 1)
    assert torch.equal(r_s, r_m) and torch.equal(b_s, b_m)
    out = tcb.checkerboard_sweeps(torch.Generator().manual_seed(3), lat,
                                  torch.tensor(Ts), 3)
    assert torch.equal(out, tcb.merge_checkerboard(r_s, b_s))


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


def test_sample_lattice_matches_exact_enumeration():
    """The plain heat-bath path on a 4x4 periodic lattice at T=2.5."""
    T = 2.5
    exact = exact_ising_moments(_dense_grid_couplings(4, 4), np.zeros(16), T)
    out = tcb.sample_lattice(torch.Generator().manual_seed(0),
                             torch.ones(4, 4), n_samples=3000, temperature=T,
                             n_burnin=50, periodic=True, collect="observables")
    m, e = out["magnetization"].numpy(), out["energy"].numpy()
    assert abs(np.abs(m).mean() - exact["abs_magnetization"]) < 4 * _batch_means_se(np.abs(m))
    assert abs(e.mean() - exact["energy"]) < 4 * _batch_means_se(e)
    states = tcb.sample_lattice(torch.Generator().manual_seed(0),
                                torch.ones(4, 4), n_samples=5, temperature=T,
                                n_burnin=50, periodic=True)
    assert states.shape == (5, 4, 4)
    assert set(states.unique().tolist()) <= {-1.0, 1.0}
