"""The port's tempering ladder, Houdayer moves and PT ground-state search on
the CPU, against tsu_tpu's and against exact enumeration."""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402
from scipy import ndimage  # noqa: E402

from tsu_tpu.ops.checkerboard_bonds import dense_from_bonds  # noqa: E402
from tsu_tpu.samplers import tempering_ladder as jladder  # noqa: E402
from tsu_tpu_torch.ops.checkerboard import merge_checkerboard, split_checkerboard  # noqa: E402
from tsu_tpu_torch.ops.checkerboard_bonds import lattice_energy_bonds  # noqa: E402
from tsu_tpu_torch.samplers import (  # noqa: E402
    build_tempering_ladder,
    houdayer_move,
    parallel_tempering_bonds,
    predict_swap_acceptance,
    pt_ground_state_search,
)
from tsu_tpu_torch.samplers.tempering_ladder import _ladder_from_stats  # noqa: E402


def _pm1(seed, L):
    rng = np.random.default_rng(seed)
    return (rng.choice([-1.0, 1.0], (L, L)).astype(np.float32),
            rng.choice([-1.0, 1.0], (L, L)).astype(np.float32))


@pytest.mark.parametrize("b1,b2,slope,var", [
    (1.0, 1.0 + 1e-6, 100.0, 400.0), (1.0, 1.05, 100.0, 400.0), (1.0, 1.2, 100.0, 400.0),
    (1.0, 2.0, 100.0, 400.0), (1.0, 1.5, 10.0, 0.0), (0.5, 0.6, 3000.0, 1e5),
    (0.5, 0.4, 10.0, 4.0)])
def test_predict_swap_acceptance_equals_jax(b1, b2, slope, var):
    """scipy on both sides: equal to 1e-12."""
    def U(b):
        return -slope * b

    def V(b):
        return var * (1.0 + 0.1 * b)

    assert predict_swap_acceptance(b1, b2, U, V) == pytest.approx(
        jladder.predict_swap_acceptance(b1, b2, U, V), abs=1e-12)


def test_ladder_from_stats_equals_jax():
    betas = np.geomspace(0.5, 3.0, 8)
    U = -300.0 * np.sqrt(betas)
    V = 900.0 / betas
    kw = dict(beta_min=0.5, beta_max=3.0, target=0.3, max_rungs=64, dbeta_cap=2.5 / 8)
    got, _, capped = _ladder_from_stats(betas, U, V, **kw)
    want, _, capped_j = jladder._ladder_from_stats(betas, U, V, **kw)
    np.testing.assert_array_equal(got, want)
    assert capped == capped_j


@pytest.fixture(scope="module")
def ladder16():
    Jh, Jv = _pm1(7, 16)
    temps, info = build_tempering_ladder(
        2, Jh, Jv, T_min=0.4, T_max=2.0, target_acceptance=0.3, accept_floor=0.2, n_pilot=8,
        pilot_burnin=32, pilot_measure=48, feedback_rounds=2, feedback_iters=64,
        feedback_burnin=16, pad_multiple=8)
    return Jh, Jv, temps, info


def test_ladder_builder_hits_target_acceptance(ladder16):
    Jh, Jv, temps, info = ladder16
    assert not info["capped"]
    assert np.all(np.diff(temps) > 0)
    assert temps[0] == pytest.approx(0.4, rel=1e-5) and temps[-1] == pytest.approx(2.0, rel=1e-5)
    meas = info["measured_pair_acceptance"]
    assert meas is not None and len(meas) == len(temps) - 1
    assert meas.min() >= 0.1
    assert len(info["predicted_acceptance"]) == len(temps) - 1
    _, pt_info = parallel_tempering_bonds(3, Jh, Jv, temperatures=temps, n_samples=64,
                                          n_burnin=16, swap_interval=1)
    assert pt_info["pair_acceptance"].min() >= 0.08
    assert 0.1 <= pt_info["swap_acceptance_rate"] <= 0.9


def test_ladder_info_keys_are_jax(ladder16):
    keys = {"n_rungs", "betas", "pilot_betas", "pilot_energy_mean", "pilot_energy_var",
            "predicted_acceptance", "measured_pair_acceptance", "measured_pair_attempts",
            "feedback_rounds_run", "capped", "target_acceptance", "accept_floor"}
    assert set(ladder16[3]) == keys


def test_ladder_scales_with_system_size():
    counts = {}
    for L in (8, 24):
        Jh, Jv = _pm1(L, L)
        _, info = build_tempering_ladder(
            100 + L, Jh, Jv, T_min=0.5, T_max=2.0, target_acceptance=0.3, n_pilot=8,
            pilot_burnin=32, pilot_measure=48, feedback_rounds=0, pad_multiple=8)
        counts[L] = info["n_rungs"]
    assert counts[24] > counts[8]


def _pair(seed, L):
    s = np.where(np.random.default_rng(seed).random((2, L, L)) < 0.5, 1.0, -1.0)
    r, b = split_checkerboard(torch.from_numpy(s).float())
    return r[0:1], b[0:1], r[1:2], b[1:2]


def _energy(r, b, Jh, Jv, periodic):
    return float(lattice_energy_bonds(merge_checkerboard(r, b), Jh, Jv, periodic=periodic)[0])


@pytest.mark.parametrize("periodic", [True, False])
def test_houdayer_conserves_total_energy_exactly(periodic):
    for trial in range(4):
        Jh, Jv = _pm1(20 + trial, 16)
        r1, b1, r2, b2 = _pair(30 + trial, 16)
        before = _energy(r1, b1, Jh, Jv, periodic) + _energy(r2, b2, Jh, Jv, periodic)
        r1n, b1n, r2n, b2n = houdayer_move(trial, r1, b1, r2, b2, periodic=periodic)
        after = _energy(r1n, b1n, Jh, Jv, periodic) + _energy(r2n, b2n, Jh, Jv, periodic)
        assert after == before
        assert not torch.equal(r1n, r1) or not torch.equal(b1n, b1)


@pytest.mark.parametrize("periodic", [True, False])
def test_houdayer_flips_exactly_one_connected_overlap_component(periodic):
    r1, b1, r2, b2 = _pair(5, 16)
    s1, s2 = merge_checkerboard(r1, b1)[0].numpy(), merge_checkerboard(r2, b2)[0].numpy()
    q_neg = s1 * s2 < 0
    r1n, b1n, r2n, b2n = houdayer_move(7, r1, b1, r2, b2, periodic=periodic)
    flipped = merge_checkerboard(r1n, b1n)[0].numpy() != s1
    assert flipped.any() and not (flipped & ~q_neg).any()
    labels, _ = ndimage.label(q_neg, structure=[[0, 1, 0], [1, 1, 1], [0, 1, 0]])
    if periodic:      # join the labels of components that meet across an edge
        for a, b in [(labels[0], labels[-1]), (labels[:, 0], labels[:, -1])]:
            for x, y in zip(a, b):
                if x and y and x != y:
                    labels[labels == y] = x
    assert len(np.unique(labels[flipped])) == 1
    assert np.array_equal(flipped, labels == labels[flipped][0])
    assert np.array_equal(flipped, merge_checkerboard(r2n, b2n)[0].numpy() != s2)


def test_houdayer_leaves_identical_replicas_alone():
    r1, b1, _, _ = _pair(9, 8)
    out = houdayer_move(1, r1, b1, r1, b1)
    assert all(torch.equal(a, b) for a, b in zip(out, (r1, b1, r1, b1)))


def test_pt_ground_state_search_is_exact_on_an_enumerable_instance():
    Jh, Jv = _pm1(3, 4)
    J = dense_from_bonds(Jh, Jv, periodic=True)
    s = 2.0 * ((np.arange(2**16)[:, None] >> np.arange(16)) & 1) - 1.0
    exact = float((-0.5 * np.einsum("bi,ij,bj->b", s, J, s)).min())
    out = pt_ground_state_search(5, Jh, Jv, temperatures=np.geomspace(0.3, 2.0, 8),
                                 n_iters=150, n_sweeps=1, quench_sweeps=12)
    assert out["best_energy"] == exact
    s_best = out["best_state"]
    e_check = -np.sum(Jh * s_best * np.roll(s_best, -1, 1)) - np.sum(
        Jv * s_best * np.roll(s_best, -1, 0))
    assert e_check == out["best_energy"]


def test_pt_ground_state_search_with_copies_and_houdayer():
    Jh, Jv = _pm1(21, 8)
    kw = dict(temperatures=np.geomspace(0.4, 2.0, 6), n_iters=60, n_sweeps=1, n_copies=2,
              houdayer_every=5, quench_sweeps=6)
    out = pt_ground_state_search(1, Jh, Jv, **kw)
    ref = jladder.pt_ground_state_search(1, Jh, Jv, use_pallas=False, **kw)
    assert out.keys() == ref.keys()
    assert out["houdayer_every"] == 5 and out["n_copies"] == 2 and out["best_energy"] < -64
    np.testing.assert_array_equal(out["pair_attempts"], ref["pair_attempts"])
    assert out["discrete_table_path"] is True
    assert pt_ground_state_search(1, Jh, Jv, **kw)["best_energy"] == out["best_energy"]
    with pytest.raises(NotImplementedError):
        pt_ground_state_search(1, Jh, Jv, checkpoint_path="ck", **kw)
