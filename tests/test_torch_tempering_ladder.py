"""The port's tempering ladder, Houdayer moves and PT ground-state search on
the CPU, against tsu_tpu's and against exact enumeration."""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402
from scipy import ndimage  # noqa: E402

from tsu_tpu.samplers import tempering_ladder as jladder  # noqa: E402
from tsu_tpu_torch.ops.checkerboard import merge_checkerboard, split_checkerboard  # noqa: E402
from tsu_tpu_torch.ops.checkerboard_bonds import (  # noqa: E402
    dense_from_bonds,
    lattice_energy_bonds,
)
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
        feedback_burnin=16, pad_multiple=8, device="cpu")
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
                                          n_burnin=16, swap_interval=1, device="cpu")
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
            pilot_burnin=32, pilot_measure=48, feedback_rounds=0, pad_multiple=8,
            device="cpu")
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
                                 n_iters=150, n_sweeps=1, quench_sweeps=12, device="cpu")
    assert out["best_energy"] == exact
    s_best = out["best_state"]
    e_check = -np.sum(Jh * s_best * np.roll(s_best, -1, 1)) - np.sum(
        Jv * s_best * np.roll(s_best, -1, 0))
    assert e_check == out["best_energy"]


def test_pt_ground_state_search_with_copies_and_houdayer(tmp_path):
    Jh, Jv = _pm1(21, 8)
    kw = dict(temperatures=np.geomspace(0.4, 2.0, 6), n_iters=60, n_sweeps=1, n_copies=2,
              houdayer_every=5, quench_sweeps=6)
    out = pt_ground_state_search(1, Jh, Jv, device="cpu", **kw)
    ref = jladder.pt_ground_state_search(1, Jh, Jv, use_pallas=False, **kw)
    assert out.keys() == ref.keys()
    assert out["houdayer_every"] == 5 and out["n_copies"] == 2 and out["best_energy"] < -64
    np.testing.assert_array_equal(out["pair_attempts"], ref["pair_attempts"])
    assert out["discrete_table_path"] is True
    assert pt_ground_state_search(1, Jh, Jv, device="cpu", **kw)["best_energy"] == out["best_energy"]
    ck = pt_ground_state_search(1, Jh, Jv, checkpoint_path=str(tmp_path / "ck"),
                                checkpoint_every=20, device="cpu", **kw)
    assert ck["best_energy"] == out["best_energy"]
    assert np.array_equal(ck["best_state"], out["best_state"])


def test_pt_ground_state_search_records_a_best_energy_lowered_by_houdayer(monkeypatch):
    """A Houdayer move that lowers one replica is recorded at once, not only
    if the next sweep keeps it: with one iteration, a move at its end and no
    quench, the lowered state is what the search returns. The move is stubbed
    to put the first replica of each pair into the ground state of a gauged
    ferromagnet (±J bonds J_ij = g_i g_j, ground state g, energy -2N)."""
    from tsu_tpu_torch.samplers import tempering_ladder as ladder

    L = 8
    g = np.where(np.random.default_rng(4).random((L, L)) < 0.5, 1.0, -1.0).astype(np.float32)
    Jh, Jv = g * np.roll(g, -1, 1), g * np.roll(g, -1, 0)
    g_red, g_black = split_checkerboard(torch.from_numpy(g))
    moved = []

    def to_ground_state(u, r1, b1, r2, b2, periodic):
        moved.append(r1.shape[0])
        return (g_red.to(r1.dtype).expand_as(r1), g_black.to(b1.dtype).expand_as(b1), r2, b2)

    monkeypatch.setattr(ladder, "_houdayer", to_ground_state)
    out = pt_ground_state_search(2, Jh, Jv, temperatures=[1.5, 2.5], n_iters=1, n_copies=2,
                                 houdayer_every=1, quench_sweeps=0, device="cpu")
    assert moved == [1]
    assert out["best_energy"] == -2 * L * L
    np.testing.assert_array_equal(out["best_state"], g)


@pytest.mark.parametrize("killed_after,n_copies", [(1, 1), (2, 2)])
def test_pt_ground_state_search_killed_and_resumed_equals_uninterrupted(
        tmp_path, monkeypatch, killed_after, n_copies):
    """Mirror of the JAX package's resume test: the search killed after a
    snapshot (chunks of 20 iterations, one snapshot each) and resumed from it
    returns the uninterrupted search's best state and energy, bit for bit."""
    from tsu_tpu_torch.samplers import tempering_ladder as tl

    Jh, Jv = _pm1(9, 8)
    kw = dict(temperatures=np.geomspace(0.4, 2.0, 6), n_iters=60, n_sweeps=1,
              quench_sweeps=6, n_copies=n_copies, houdayer_every=5 if n_copies > 1 else 0,
              device="cpu")
    full = pt_ground_state_search(4, Jh, Jv, **kw)
    path = str(tmp_path / "ck")
    real_save, calls = tl.save_state, []

    def dying_save(*args, **kwargs):
        real_save(*args, **kwargs)
        calls.append(1)
        if len(calls) == killed_after:
            raise RuntimeError("killed")

    monkeypatch.setattr(tl, "save_state", dying_save)
    with pytest.raises(RuntimeError, match="killed"):
        pt_ground_state_search(4, Jh, Jv, checkpoint_path=path, chunk_iters=20, **kw)
    monkeypatch.setattr(tl, "save_state", real_save)
    resumed = pt_ground_state_search(4, Jh, Jv, checkpoint_path=path, chunk_iters=20,
                                     resume=True, **kw)
    assert resumed["best_energy"] == full["best_energy"]
    assert np.array_equal(resumed["best_state"], full["best_state"])
    np.testing.assert_array_equal(resumed["pair_attempts"], full["pair_attempts"])
    assert resumed["swap_acceptance_rate"] == full["swap_acceptance_rate"]


def _checkpoint_resume_pt_kw():
    """examples/checkpoint_resume.py's PT search: 16^2 ±J, 8 rungs."""
    Jh, Jv = _pm1(3, 16)
    return Jh, Jv, dict(temperatures=np.geomspace(0.4, 2.0, 8), n_sweeps=1, device="cpu")


@pytest.mark.parametrize("n_copies", [1, 2])
def test_pt_ground_state_search_killed_short_resumes_to_a_longer_horizon(tmp_path, n_copies):
    """The reference's own pattern: a search of 30 iterations with no quench,
    snapshotted, then resumed with n_iters=90 and the quench, returns the
    uninterrupted 90-iteration search bit for bit (best energy, state and
    swap counts); with two copies Houdayer moves fall on both sides of the
    snapshot."""
    Jh, Jv, kw = _checkpoint_resume_pt_kw()
    kw.update(n_copies=n_copies, houdayer_every=7 if n_copies > 1 else 0)
    full = pt_ground_state_search(3, Jh, Jv, n_iters=90, quench_sweeps=8, **kw)
    path = str(tmp_path / "pt")
    pt_ground_state_search(3, Jh, Jv, n_iters=30, chunk_iters=30, checkpoint_path=path,
                           quench_sweeps=0, **kw)
    resumed = pt_ground_state_search(3, Jh, Jv, n_iters=90, chunk_iters=30,
                                     checkpoint_path=path, resume=True, quench_sweeps=8, **kw)
    assert resumed["best_energy"] == full["best_energy"]
    assert np.array_equal(resumed["best_state"], full["best_state"])
    np.testing.assert_array_equal(resumed["pair_attempts"], full["pair_attempts"])
    assert resumed["swap_acceptance_rate"] == full["swap_acceptance_rate"]
    assert resumed["iters_run"] == 90


def test_pt_ground_state_search_first_iterations_do_not_depend_on_the_horizon(
        tmp_path, monkeypatch):
    """Iteration t draws from (seed, t) alone: the replica and best planes
    snapshotted after 30 iterations are the same in a 30- and a
    90-iteration search (the latter killed at that snapshot)."""
    from tsu_tpu_torch.checkpoint import restore_state
    from tsu_tpu_torch.samplers import tempering_ladder as tl

    Jh, Jv, kw = _checkpoint_resume_pt_kw()
    kw.update(chunk_iters=30, quench_sweeps=0, n_copies=2, houdayer_every=5)
    short, long_ = str(tmp_path / "pt30"), str(tmp_path / "pt90")
    pt_ground_state_search(3, Jh, Jv, n_iters=30, checkpoint_path=short, **kw)
    real_save = tl.save_state

    def dying_save(*args, **kwargs):
        real_save(*args, **kwargs)
        raise RuntimeError("killed")

    monkeypatch.setattr(tl, "save_state", dying_save)
    with pytest.raises(RuntimeError, match="killed"):
        pt_ground_state_search(3, Jh, Jv, n_iters=90, checkpoint_path=long_, **kw)
    planes = {k: torch.zeros(0) for k in ("reds", "blacks", "best_r", "best_b", "best_e")}
    a, b = (restore_state(p, {**planes, "done": 0}) for p in (short, long_))
    assert a["done"] == b["done"] == 30
    for k in planes:
        assert torch.equal(a[k].float(), b[k].float()), k


def test_pt_ground_state_search_refuses_an_old_scheme_snapshot(tmp_path):
    """A snapshot without the stream scheme (written when every draw was made
    up front, so iteration t's stream depended on n_iters) raises on
    resume=True instead of continuing another stream."""
    from tsu_tpu_torch.checkpoint import restore_state, save_state
    from tsu_tpu_torch.config import ConfigurationError

    Jh, Jv, kw = _checkpoint_resume_pt_kw()
    path = str(tmp_path / "pt")
    pt_ground_state_search(3, Jh, Jv, n_iters=10, checkpoint_path=path, quench_sweeps=0, **kw)
    keys = ("reds", "blacks", "best_r", "best_b", "best_e", "acc_p", "att_p")
    old = restore_state(path, {**{k: torch.zeros(0) for k in keys}, "done": 0})
    save_state(path, old)
    with pytest.raises(ConfigurationError, match="stream scheme"):
        pt_ground_state_search(3, Jh, Jv, n_iters=20, checkpoint_path=path, resume=True,
                               quench_sweeps=0, **kw)


def test_reference_example_resumes_to_a_longer_horizon(tmp_path, monkeypatch):
    """Witness: the JAX package's own examples/checkpoint_resume.py, at its
    sizes on the CPU devices, kills both runs short and resumes them long,
    and its two asserts hold: the property the port now keeps."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "ref_checkpoint_resume",
        Path(__file__).resolve().parents[1] / "examples" / "checkpoint_resume.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod.tempfile, "mkdtemp", lambda prefix="": str(tmp_path))
    mod.main()
    assert (tmp_path / "lattice_ck_obs.npz").exists()


def _record_snapshots(monkeypatch):
    """Record the iterations done of every snapshot that the port's and the
    reference's PT search write (both still write them): the port's
    module-level ``save_state``, and ``tsu_tpu.checkpoint.save_state``,
    which the reference imports when it saves."""
    import tsu_tpu.checkpoint as jcheckpoint
    from tsu_tpu_torch.samplers import tempering_ladder as tl

    done = {"port": [], "reference": []}

    def recording(side, save):
        def record(path, state, *args, **kwargs):
            done[side].append(int(state["done"]))
            return save(path, state, *args, **kwargs)
        return record

    monkeypatch.setattr(tl, "save_state", recording("port", tl.save_state))
    monkeypatch.setattr(jcheckpoint, "save_state", recording("reference", jcheckpoint.save_state))
    return done


def _search_both(tmp_path, **kw):
    """The port's and the reference's PT search of one 16^2 ±J instance, 4
    rungs, no quench, each snapshotting to its own file under tmp_path."""
    Jh, Jv = _pm1(12, 16)
    kw.update(temperatures=np.geomspace(0.5, 2.0, 4), n_sweeps=1, quench_sweeps=0)
    port = pt_ground_state_search(7, Jh, Jv, checkpoint_path=str(tmp_path / "port"),
                                  device="cpu", **kw)
    ref = jladder.pt_ground_state_search(7, Jh, Jv, checkpoint_path=str(tmp_path / "ref"),
                                         use_pallas=False, **kw)
    return port, ref


@pytest.mark.parametrize("n_iters,chunk_iters,checkpoint_every,expected", [
    (1000, None, 1, [500, 1000]), (90, 30, 1, [30, 60, 90]), (90, 20, 2, [40, 80, 90]),
    (100, 30, 1, [30, 60, 90, 100]), (50, None, 0, [])])
def test_pt_ground_state_search_snapshots_as_the_reference_does(
        tmp_path, monkeypatch, n_iters, chunk_iters, checkpoint_every, expected):
    """One snapshot every checkpoint_every chunks of chunk_iters iterations
    (500 by default with a checkpoint path) and one after the last, none
    with checkpoint_every 0: the same save_state calls, with the same
    iterations done, as the reference."""
    done = _record_snapshots(monkeypatch)
    port, ref = _search_both(tmp_path, n_iters=n_iters, chunk_iters=chunk_iters,
                             checkpoint_every=checkpoint_every)
    assert done["port"] == done["reference"] == expected
    assert port["iters_run"] == ref["iters_run"] == n_iters


@pytest.mark.parametrize("chunk_iters,expected", [(None, [30, 90]), (30, [30, 60, 90])])
def test_pt_ground_state_search_killed_and_resumed_snapshots_as_the_reference_does(
        tmp_path, monkeypatch, chunk_iters, expected):
    """A search killed at 30 iterations and resumed to 90 counts its chunks
    from where the resumed call starts: the same snapshots as the
    reference's, and a default chunk of min(n_iters, 500) iterations."""
    done = _record_snapshots(monkeypatch)
    _search_both(tmp_path, n_iters=30, chunk_iters=chunk_iters)
    port, ref = _search_both(tmp_path, n_iters=90, chunk_iters=chunk_iters, resume=True)
    assert done["port"] == done["reference"] == expected
    assert port["iters_run"] == ref["iters_run"] == 90


def test_pt_ground_state_search_reports_the_iterations_its_state_holds(tmp_path):
    """A 90-iteration snapshot resumed with n_iters=30 runs nothing and
    returns the 90-iteration state: both report 90, as after the run."""
    port90, ref90 = _search_both(tmp_path, n_iters=90)
    assert port90["iters_run"] == ref90["iters_run"] == 90
    port, ref = _search_both(tmp_path, n_iters=30, resume=True)
    assert port["iters_run"] == ref["iters_run"] == 90
    assert port["best_energy"] == port90["best_energy"]
    assert np.array_equal(port["best_state"], port90["best_state"])
