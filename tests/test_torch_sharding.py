"""The port's device mesh, sharded lattice and replica-sharded tempering on a
mesh of CPU "devices" (one device named several times), against tsu_tpu's
sharded functions on its virtual CPU devices (tests/conftest.py) with the
Pallas kernels in TPU interpret mode.

Injected uniforms, made with numpy from a seed, feed both sides: 24-bit for
the half-sweep (K3), 16-bit for the fused sweep in shard mode (K1). The
planes must agree bit for bit (no site of these seeds falls in K3's 1e-6
band, see tests/test_torch_halfsweep.py). In Philox mode a sharded run must
equal the one-shard run of the same kernel at the same seed, and the
sampler's moments must match exact 4x4 enumeration.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tsu_tpu.ops import checkerboard as jcb  # noqa: E402
from tsu_tpu.oracle import exact_ising_moments  # noqa: E402
from tsu_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from tsu_tpu.parallel.lattice import (  # noqa: E402
    sharded_checkerboard_sweeps as jax_sharded_sweeps,
)
from tsu_tpu.parallel.tempering_sharded import _rung_swap as jax_rung_swap  # noqa: E402
from tsu_tpu_torch import IsingConfig, IsingGrid  # noqa: E402
from tsu_tpu_torch.ops.checkerboard import (  # noqa: E402
    lattice_energy_batch,
    merge_checkerboard,
    split_checkerboard,
)
from tsu_tpu_torch.parallel import (  # noqa: E402
    make_mesh,
    mesh_info,
    parallel_tempering_replica_sharded,
    plan_lattice_mesh,
    sharded_checkerboard_sweeps,
    sharded_lattice_sample,
)
from tsu_tpu_torch.parallel.tempering_sharded import _rung_swap  # noqa: E402

CPU4 = ["cpu"] * 4
T = 2.269


def _planes(seed, R, C):
    rng = np.random.default_rng(seed)
    lat = np.where(rng.random((R, C)) < 0.5, 1.0, -1.0).astype(np.float32)
    return jcb.split_checkerboard(jnp.asarray(lat))


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x, np.float32), dtype=dtype)


def _exact_4x4(T_):
    n = 16
    J = np.zeros((n, n))
    for r in range(4):
        for c in range(4):
            for rr, cc in ((r, (c + 1) % 4), ((r + 1) % 4, c)):
                J[r * 4 + c, rr * 4 + cc] += 1.0
                J[rr * 4 + cc, r * 4 + c] += 1.0
    return exact_ising_moments(J, np.zeros(n), temperature=T_)


# -- the mesh --------------------------------------------------------------


def test_make_mesh_shapes_and_repeated_devices():
    mesh = make_mesh(rows=4, devices=CPU4)
    assert mesh.shape == {"replica": 1, "chains": 1, "row": 4, "col": 1}
    assert mesh_info(mesh) == {"axes": mesh.shape, "n_devices": 4, "platform": "cpu",
                               "n_processes": 1, "n_hosts": 1, "backend": None}
    mesh = make_mesh(replica=2, rows=2, cols=2, devices=["cpu"] * 8)
    assert mesh.devices.shape == (2, 1, 2, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)


def test_too_many_devices_rejected():
    with pytest.raises(ValueError):
        make_mesh(rows=1024, devices=CPU4)


def test_default_devices_are_the_cards(monkeypatch):
    """Without a card the default mesh has no device, so it raises: there is
    no fall-back to the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="have 0"):
        make_mesh(rows=1)


def test_plan_prefers_row_only_sharding():
    mesh = plan_lattice_mesh(8, (4096, 4096), devices=["cpu"] * 8)
    assert mesh.shape["row"] == 8 and mesh.shape["col"] == 1


def test_plan_takes_any_even_shard_height():
    """The reference's rows-per-shard % 8 rule is gone: 16 rows over 8
    devices shard by rows, two rows each, with no warning."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mesh = plan_lattice_mesh(8, (16, 1024), devices=["cpu"] * 8)
    assert mesh.shape["row"] == 8 and mesh.shape["col"] == 1


def test_plan_falls_back_to_columns_with_a_warning():
    """12 rows split in 1 or 2 shards of even height only, so 8 devices
    take 4 columns, loudly."""
    with pytest.warns(RuntimeWarning, match="streaming"):
        mesh = plan_lattice_mesh(8, (12, 1024), devices=["cpu"] * 8)
    assert (mesh.shape["row"], mesh.shape["col"]) == (2, 4)


def test_plan_replica_chains_budget():
    mesh = plan_lattice_mesh(8, (64, 64), replica=2, chains=2, devices=["cpu"] * 8)
    assert mesh.shape["replica"] == 2 and mesh.shape["chains"] == 2
    assert mesh.shape["row"] == 2 and mesh.shape["col"] == 1
    with pytest.raises(ValueError):
        plan_lattice_mesh(8, (64, 64), replica=3, devices=["cpu"] * 8)


# -- sharded sweeps against the JAX package --------------------------------


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("rows,cols", [(4, 1), (2, 2)])
def test_halfsweep_under_sharding_matches_jax(rows, cols, periodic):
    """K3 with 24-bit uniforms under row sharding (rows=4) and in its
    column-halo mode under 2-D sharding (2 x 2)."""
    R = C = 16
    red, black = _planes(0, R, C)
    U = np.random.default_rng(1).integers(0, 1 << 24, (2, 2, R, C // 2), dtype=np.int32)
    col_axis = "col" if cols > 1 else None
    with pltpu.force_tpu_interpret_mode():
        r_j, b_j = jax_sharded_sweeps(
            jax_make_mesh(rows=rows, cols=cols), jax.random.key(9), red, black, T, 2,
            periodic=periodic, use_pallas=True, col_axis=col_axis, uniforms=jnp.asarray(U),
            fused=False)
    mesh = make_mesh(rows=rows, cols=cols, devices=CPU4)
    r_t, b_t = sharded_checkerboard_sweeps(mesh, 9, _t(red), _t(black), T, 2, periodic=periodic,
                                           col_axis=col_axis, uniforms=torch.from_numpy(U),
                                           fused=False)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_fused_under_row_sharding_matches_jax(n_shards, periodic):
    """K1's shard mode with 16-bit uniforms: two-row halos, global row
    offsets and the neighbours' red uniform rows."""
    R = C = 32
    red, black = _planes(7, R, C)
    U = np.random.default_rng(8).integers(0, 1 << 16, (2, 2, R, C // 2), dtype=np.int32)
    with pltpu.force_tpu_interpret_mode():
        r_j, b_j = jax_sharded_sweeps(
            jax_make_mesh(rows=n_shards), jax.random.key(9), red, black, T, 2, J=1.0,
            field=0.1, periodic=periodic, use_pallas=True, uniforms=jnp.asarray(U), fused=True)
    mesh = make_mesh(rows=n_shards, devices=CPU4)
    r_t, b_t = sharded_checkerboard_sweeps(mesh, 9, _t(red), _t(black), T, 2, J=1.0, field=0.1,
                                           periodic=periodic, uniforms=torch.from_numpy(U),
                                           fused=True)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))


@pytest.mark.parametrize("fused", [True, False])
def test_sharded_bf16_matches_f32(fused):
    R = C = 16
    red, black = _planes(10, R, C)
    width = 1 << 16 if fused else 1 << 24
    U = torch.from_numpy(np.random.default_rng(11).integers(0, width, (2, 2, R, C // 2),
                                                            dtype=np.int32))
    mesh = make_mesh(rows=2, devices=CPU4)
    out = {dt: sharded_checkerboard_sweeps(mesh, 12, _t(red, dt), _t(black, dt), 2.5, 2,
                                           uniforms=U, fused=fused)
           for dt in (torch.float32, torch.bfloat16)}
    for a, b in zip(out[torch.float32], out[torch.bfloat16]):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b.float())


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("kernel,rows,cols", [("K1", 4, 1), ("K1", 2, 1), ("K3", 4, 1),
                                              ("K3", 2, 2), ("K3", 1, 4)])
def test_sharded_equals_one_shard_in_philox_mode(kernel, rows, cols, periodic):
    """Draws keyed by global coordinates under one base: the sharded run is
    the one-shard run of the same kernel, bit for bit."""
    R, C = 16, 24
    red, black = (_t(x) for x in _planes(13, R, C))
    kw = dict(periodic=periodic, fused=kernel == "K1")
    one = sharded_checkerboard_sweeps(make_mesh(devices=["cpu"]), 14, red, black, T, 3, **kw)
    got = sharded_checkerboard_sweeps(make_mesh(rows=rows, cols=cols, devices=CPU4), 14, red,
                                      black, T, 3, col_axis="col" if cols > 1 else None, **kw)
    assert torch.equal(one[0], got[0]) and torch.equal(one[1], got[1])
    assert not torch.equal(one[1], black)


@pytest.mark.parametrize("case", ["odd shard height", "fused with columns",
                                  "ragged columns", "uniform shape"])
def test_sharded_sweeps_reject_bad_layouts(case):
    red, black = split_checkerboard(torch.ones(12, 16))
    kw = {}
    mesh = make_mesh(rows=2, devices=CPU4)
    if case == "odd shard height":
        mesh = make_mesh(rows=4, devices=CPU4)
    elif case == "fused with columns":
        mesh, kw = make_mesh(rows=2, cols=2, devices=CPU4), {"col_axis": "col", "fused": True}
    elif case == "ragged columns":
        mesh, kw = make_mesh(rows=1, cols=3, devices=CPU4), {"col_axis": "col"}
    else:
        kw = {"uniforms": torch.zeros(1, 2, 12, 8, dtype=torch.int32)}
    with pytest.raises(ValueError):
        sharded_checkerboard_sweeps(mesh, 0, red, black, 2.0, 2, **kw)


# -- the sampler -------------------------------------------------------------


@pytest.mark.parametrize("rows,cols", [(2, 1), (2, 2)])
def test_sharded_sampler_matches_exact_enumeration_4x4(rows, cols):
    """2-row shards (K1 in shard mode) and 2 x 1-column shards (K3 with
    column halos): every site update needs a halo. ~3 sigma bands at 1500
    samples, as the JAX package's dry run holds its sharded sampler."""
    exact = _exact_4x4(3.0)
    out = sharded_lattice_sample(
        make_mesh(rows=rows, cols=cols, devices=CPU4), 11, torch.ones(4, 4), n_samples=1500,
        temperature=3.0, n_burnin=200, n_sweeps=2, col_axis="col" if cols > 1 else None)
    m_abs = out["magnetization"].abs().numpy()
    e = out["energy"].numpy()
    assert out["magnetization"].dtype == torch.float64 and m_abs.shape == (1500,)
    assert abs(m_abs.mean() - exact["abs_magnetization"]) < 0.05
    assert abs(e.mean() - exact["energy"]) < 1.0


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("rows,cols", [(4, 1), (2, 2)])
def test_sampler_energies_are_those_of_the_merged_planes(rows, cols, periodic):
    """The last sample's energy and magnetization, summed shard by shard
    with halos, equal those of the merged final planes."""
    out = sharded_lattice_sample(
        make_mesh(rows=rows, cols=cols, devices=CPU4), 3, torch.ones(16, 20), n_samples=3,
        temperature=2.5, J=0.7, field=0.2, n_burnin=5, n_sweeps=2, periodic=periodic,
        col_axis="col" if cols > 1 else None)
    lat = merge_checkerboard(*out["final_planes"]).double()
    want = lattice_energy_batch(lat, J=0.7, field=0.2, periodic=periodic)
    assert float(out["energy"][-1]) == float(want)
    assert float(out["magnetization"][-1]) == float(lat.mean())


@pytest.mark.parametrize("rows,cols,killed_after", [(2, 1, 1), (2, 2, 2), (2, 2, None)])
def test_sampler_killed_and_resumed_equals_uninterrupted(tmp_path, monkeypatch, rows, cols,
                                                         killed_after):
    """A run killed after a snapshot and resumed returns the uninterrupted
    run's observables and planes bit for bit; with no snapshot on disk,
    resume runs from the start (no crash window between two files)."""
    from tsu_tpu_torch.parallel import lattice as plat

    mesh = make_mesh(rows=rows, cols=cols, devices=CPU4[:rows * cols])
    lat0 = torch.where(torch.rand((8, 8), generator=torch.Generator().manual_seed(2)) < 0.5,
                       1.0, -1.0)
    kw = dict(n_samples=6, temperature=2.3, n_burnin=3, n_sweeps=2,
              col_axis="col" if cols > 1 else None)
    full = sharded_lattice_sample(mesh, 5, lat0, **kw)
    path = str(tmp_path / "ck")
    if killed_after is not None:
        real_save, calls = plat.save_state, []

        def dying_save(*args, **kwargs):
            real_save(*args, **kwargs)
            calls.append(1)
            if len(calls) == killed_after:
                raise RuntimeError("killed")

        monkeypatch.setattr(plat, "save_state", dying_save)
        with pytest.raises(RuntimeError, match="killed"):
            sharded_lattice_sample(mesh, 5, lat0, checkpoint_path=path, checkpoint_every=2,
                                   **kw)
        monkeypatch.setattr(plat, "save_state", real_save)
    resumed = sharded_lattice_sample(mesh, 5, lat0, checkpoint_path=path, checkpoint_every=2,
                                     resume=True, **kw)
    assert torch.equal(resumed["magnetization"], full["magnetization"])
    assert torch.equal(resumed["energy"], full["energy"])
    for a, b in zip(resumed["final_planes"], full["final_planes"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rows,cols", [(4, 1), (2, 2)])
def test_grid_sample_observables_over_a_mesh(rows, cols):
    mesh = make_mesh(rows=rows, cols=cols, devices=CPU4)
    grid = IsingGrid((16, 16), periodic=True, seed=0, device="cpu",
                     config=IsingConfig(n_burnin=100, n_sweeps=1))
    out = grid.sample_observables(50, temperature=1.2, mesh=mesh)
    assert out["magnetization"].shape == out["energy"].shape == (50,)
    assert np.abs(out["magnetization"]).mean() > 0.9


def test_grid_with_bonds_ignores_the_mesh():
    J = np.ones((8, 8), np.float32)
    cfg = IsingConfig(n_burnin=5, n_sweeps=1)
    a = IsingGrid((8, 8), periodic=True, seed=2, device="cpu", bonds=(J, J), config=cfg)
    b = IsingGrid((8, 8), periodic=True, seed=2, device="cpu", bonds=(J, J), config=cfg)
    out_a = a.sample_observables(4, temperature=2.0, mesh=make_mesh(rows=2, devices=CPU4))
    out_b = b.sample_observables(4, temperature=2.0)
    for k in ("magnetization", "energy"):
        np.testing.assert_array_equal(out_a[k], out_b[k])


# -- replica-sharded tempering ---------------------------------------------


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rung_swap_matches_jax(seed, offset):
    """The same uniforms, energies and rung assignment give the same new
    rungs and accept count as the JAX package's swap."""
    rng = np.random.default_rng(seed)
    R = 7
    energies = rng.normal(0, 8, R).astype(np.float32)
    rungs = rng.permutation(R)
    betas = (1.0 / np.sort(rng.uniform(1.0, 4.0, R))).astype(np.float32)
    key = jax.random.key(seed)
    u = np.asarray(jax.random.uniform(key, (R,)))
    want, acc = jax_rung_swap(key, jnp.asarray(energies), jnp.asarray(rungs), jnp.asarray(betas),
                              offset)
    got, n = _rung_swap(u, energies.astype(np.float64), rungs, betas.astype(np.float64), offset)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert n == int(acc)


def _pt(seed, shape, temps, **kw):
    return parallel_tempering_replica_sharded(make_mesh(replica=4, devices=CPU4), seed, shape,
                                              temps, **kw)


def test_tempering_shapes_and_stats():
    out = _pt(0, (8, 8), np.geomspace(1.5, 5.0, 8), n_samples=60, swap_interval=3,
              n_sweeps=1, n_burnin=20)
    assert out["magnetization"].shape == out["rungs"].shape == (60, 8)
    assert np.all(np.sort(out["rungs"], axis=1) == np.arange(8))
    assert out["swap_accepts"] >= 0 and out["cold_magnetization"].shape == (60,)
    np.testing.assert_array_equal(out["final_rungs"], out["rungs"][-1])


def test_tempering_cold_chain_is_most_ordered():
    out = _pt(1, (12, 12), np.geomspace(1.2, 6.0, 4), n_samples=150, swap_interval=5,
              n_sweeps=2, n_burnin=100)
    hot_idx = out["rungs"].argmax(axis=1)
    hot_m = out["magnetization"][np.arange(len(hot_idx)), hot_idx]
    assert np.abs(out["cold_magnetization"]).mean() > np.abs(hot_m).mean() + 0.2


def test_tempering_swaps_happen_and_replicas_carry_their_energies():
    out = _pt(2, (8, 8), np.geomspace(2.0, 3.5, 4), n_samples=80, swap_interval=2,
              n_sweeps=1, n_burnin=10)
    assert out["swap_accepts"] > 0
    assert (out["rungs"][0] != out["rungs"][-1]).any() or out["swap_accepts"] > 5
    at = np.arange(80)
    np.testing.assert_array_equal(out["cold_energy"], out["energy"][at, out["rungs"].argmin(1)])


def test_tempering_is_the_same_on_any_replica_split():
    """Host randomness is drawn up front and every replica keeps its own
    stream, so one device or four give the same run."""
    kw = dict(n_samples=10, swap_interval=2, n_sweeps=1, n_burnin=4)
    temps = np.geomspace(1.5, 3.0, 8)
    four = _pt(5, (8, 8), temps, **kw)
    one = parallel_tempering_replica_sharded(make_mesh(devices=["cpu"]), 5, (8, 8), temps, **kw)
    for k in ("magnetization", "energy", "rungs"):
        np.testing.assert_array_equal(four[k], one[k])
    assert four["swap_accepts"] == one["swap_accepts"]


def test_tempering_rejects_an_uneven_split():
    with pytest.raises(ValueError):
        _pt(0, (8, 8), [1.0, 2.0, 3.0], n_samples=1, n_burnin=1)
