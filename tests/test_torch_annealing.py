"""The port's lattice annealer on the CPU, against tsu_tpu's schedule and
ground states."""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from tsu_tpu.samplers.annealing import make_schedule as jax_make_schedule  # noqa: E402
from tsu_tpu_torch import IsingGrid  # noqa: E402
from tsu_tpu_torch.ops import checkerboard_fused  # noqa: E402
from tsu_tpu_torch.ops.checkerboard import lattice_energy_batch  # noqa: E402
from tsu_tpu_torch.samplers import anneal_lattice, make_schedule  # noqa: E402


@pytest.mark.parametrize("kind", ["exponential", "linear"])
@pytest.mark.parametrize("T0,T1,n", [(5.0, 0.05, 1000), (3.0, 0.1, 7), (2.0, 2.0, 1)])
def test_schedule_is_jax_schedule_bit_for_bit(kind, T0, T1, n):
    got, want = make_schedule(T0, T1, n, kind), jax_make_schedule(T0, T1, n, kind)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError):
        make_schedule(5.0, 0.05, 10, "geometric")


def test_ferromagnet_reaches_ground_state():
    """tests/test_samplers.py::TestLatticeAnnealing::test_ferromagnet_reaches_ground_state."""
    state, e = anneal_lattice(0, (8, 8), n_steps=400, n_chains=2, device="cpu")
    assert e == -128.0   # periodic 8x8 ferromagnet: E = -2N
    assert state.shape == (8, 8) and abs(float(state.mean())) == 1.0


def test_grid_find_ground_state():
    """tests/test_ising.py::TestIsingGrid::test_ground_state: periodic 6x6,
    E0 = -2 * 36."""
    state, e = IsingGrid((6, 6), periodic=True, seed=0, device="cpu").find_ground_state(n_steps=300)
    assert e == -72.0 and state.shape == (36,)


def test_generator_seed_and_int_seed_draw_alike():
    a = anneal_lattice(torch.Generator().manual_seed(4), (6, 4), n_steps=20, periodic=False,
                       device="cpu")
    b = anneal_lattice(4, (6, 4), n_steps=20, periodic=False, device="cpu")
    assert torch.equal(a[0], b[0]) and a[1] == b[1]
    assert float(lattice_energy_batch(a[0], periodic=False)) == a[1]


def test_runs_exactly_n_steps_sweeps(monkeypatch):
    """25 sweeps with track_every = 10: two full chunks and a remainder of 5,
    counted at the plain version that every sweep of a CPU lattice runs."""
    calls = []
    plain = checkerboard_fused.fused_sweep_batched_reference

    def counting(blacks, tables, keys, **kw):
        calls.append(keys[:, 1].tolist())
        return plain(blacks, tables, keys, **kw)

    monkeypatch.setattr(checkerboard_fused, "fused_sweep_batched_reference", counting)
    anneal_lattice(2, (8, 8), n_steps=25, n_chains=3, track_every=10, device="cpu")
    assert calls == [[g] * 3 for g in range(25)]   # one global sweep counter


def test_zero_steps_return_the_initial_state():
    state, e = anneal_lattice(3, (6, 6), n_steps=0, n_chains=2, device="cpu")
    assert float(lattice_energy_batch(state)) == e
    with pytest.raises(ValueError):
        anneal_lattice(3, (6, 6), n_steps=5, track_every=0, device="cpu")


def test_anneal_spin_glass_resumes_to_more_restarts(tmp_path):
    """A search of 1 restart, snapshotted, resumed with n_restarts=3 equals
    the uninterrupted 3 restarts: restart r draws from the generator state
    after r restarts, which the snapshot carries, whatever n_restarts."""
    from tsu_tpu_torch.samplers import anneal_spin_glass

    rng = np.random.default_rng(5)
    Jh, Jv = (rng.choice([-1.0, 1.0], (8, 8)).astype(np.float32) for _ in range(2))
    kw = dict(n_steps=40, device="cpu")
    full = anneal_spin_glass(2, Jh, Jv, n_restarts=3, **kw)
    path = str(tmp_path / "ck")
    anneal_spin_glass(2, Jh, Jv, n_restarts=1, checkpoint_path=path, **kw)
    resumed = anneal_spin_glass(2, Jh, Jv, n_restarts=3, checkpoint_path=path, resume=True, **kw)
    assert resumed[1] == full[1]
    assert np.array_equal(resumed[0], full[0])
