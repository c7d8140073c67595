"""The plain reference against the port's plain path on the CPU, and the
reference's parts against published values."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.reference import ising, philox, pt_search
from tsu_tpu_torch import IsingGrid
from tsu_tpu_torch.ops.checkerboard_fused import sigmoid_table, sigmoid_table16
from tsu_tpu_torch.rng import fold_seed, philox_words
from tsu_tpu_torch.samplers import pt_ground_state_search

SEEDS = (1, 2**31 + 7, 2**62 - 3)


@pytest.mark.parametrize("counter, key, want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors of Philox4x32-10."""
    got = philox.philox(*(torch.tensor(c, dtype=torch.int64) for c in counter), *key)
    assert [int(g) for g in got] == list(want)


@pytest.mark.parametrize("k0, k1, rows, cols", [(0, 0, 3, 9), (123, 7, 5, 13),
                                                (2**32 - 1, 2**31, 2, 4)])
def test_words_match_port(k0, k1, rows, cols):
    assert torch.equal(philox.words(k0, k1, rows, cols), philox_words(k0, k1, rows, cols))


@pytest.mark.parametrize("components", [(1,), (5, 3), (-7, 2**31), (2**40,), (0, 999, 12)])
def test_fold_matches_port(components):
    assert philox.fold(*components) == fold_seed(*components)
    tensor = philox.fold(*(torch.tensor([c]) for c in components))
    assert int(tensor[0]) == fold_seed(*components)


@pytest.mark.parametrize("n", [1, 10, 100])
def test_threshold_tables_match_port(n):
    temps = torch.full((n,), 2.269)
    assert torch.equal(ising.threshold_table(1.0, temps, 16), sigmoid_table16(1.0, 0.0, temps))
    ladder = torch.from_numpy(np.geomspace(0.4, 2.0, 32).astype(np.float32))
    assert torch.equal(ising.threshold_table(1.0, ladder, 24), sigmoid_table(1.0, 0.0, ladder))


@pytest.mark.parametrize("L", [16, 32])
@pytest.mark.parametrize("seed", SEEDS)
def test_ising_reference_matches_port(L, seed):
    """IsingGrid.sample_observables on the CPU runs the kernels' plain
    versions, which match them bit for bit."""
    prog = IsingGrid((L, L), periodic=True, seed=seed, device="cpu").sample_observables(
        n_samples=12, temperature=2.269)
    ref = ising.sample_observables(seed, (L, L), temperature=2.269, n_samples=12,
                                   n_burnin=100, n_sweeps=10)
    assert ising.gaps(prog, ref) == {"m_gap_spins": 0.0, "e_gap": 0.0}


def pm_bonds(seed: int, L: int):
    g = torch.Generator().manual_seed(seed)
    return (2.0 * torch.randint(0, 2, (2, L, L), generator=g) - 1.0).unbind(0)


@pytest.mark.parametrize("L, n_iters", [(16, 40), (32, 30)])
@pytest.mark.parametrize("seed", SEEDS)
def test_pt_reference_matches_port(L, n_iters, seed):
    Jh, Jv = pm_bonds(seed, L)
    kw = dict(temperatures=np.geomspace(0.4, 2.0, 8), n_iters=n_iters, n_sweeps=1, n_copies=2,
              houdayer_every=10, quench_sweeps=8)
    prog = pt_ground_state_search(seed, Jh, Jv, device="cpu", **kw)
    ref = pt_search.pt_search(seed, Jh, Jv, **kw)
    assert pt_search.gaps(prog, ref) == {"best_e_gap": 0.0, "state_sites_differing": 0.0,
                                         "swap_accepts_gap": 0.0}


def test_cluster_wraps_both_edges():
    q = np.zeros((6, 6), bool)
    q[0, 2] = q[5, 2] = q[3, 0] = q[3, 5] = q[2, 2] = True
    assert pt_search.cluster(q, 2).sum() == 2            # (0, 2) and (5, 2) across the rows' wrap
    assert pt_search.cluster(q, 3 * 6).sum() == 2        # (3, 0) and (3, 5) across the columns'
    assert pt_search.cluster(q, 2 * 6 + 2).sum() == 1
