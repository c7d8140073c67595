"""A lattice drawn on the mesh and sampled shard by shard, on meshes of CPU
"devices": K12's draw (``ops/lattice_draw.py``, its plain version here) and
K11's shard mode (``ops/plane_observables.py:plane_sums``, its plain version)
through ``IsingGrid.sample_observables(..., mesh=..., initial="mesh")`` and
``sharded_lattice_sample``. The same seed gives the same planes and
observables on 1, 2 and 4 row shards, and the benchmark's plain reference
(``perfbench/reference/ising_sharded.py``) replays them, whole and strip by
strip. The default route, a start drawn on the host, is pinned to its
outputs before the mesh draw was added. The kernels run in
tests/test_torch_gpu_sharded.py."""

import pytest
import torch

from perfbench.reference import ising_sharded as reference
from tsu_tpu_torch import IsingConfig, IsingGrid
from tsu_tpu_torch.config import ConfigurationError
from tsu_tpu_torch.ops.checkerboard import lattice_energy_batch, merge_checkerboard
from tsu_tpu_torch.ops.lattice_draw import draw_planes, draw_planes_reference
from tsu_tpu_torch.ops.plane_observables import plane_sums, plane_sums_reference
from tsu_tpu_torch.parallel import make_mesh, sharded_lattice_sample
from tsu_tpu_torch.parallel.lattice import MeshStart
from tsu_tpu_torch.rng import DRAW_TAG, fold_seed, philox_words

T = 2.269
SHAPES = [(32, 32), (64, 128)]
CHAIN = dict(n_burnin=2, n_sweeps=2)


def _mesh(rows):
    return make_mesh(rows=rows, devices=["cpu"] * rows)


def _grid(shape, seed):
    return IsingGrid(shape, periodic=True, seed=seed, device="cpu",
                     config=IsingConfig(temperature=T, **CHAIN))


@pytest.mark.parametrize("shape", SHAPES)
def test_the_mesh_draw_is_one_lattice_for_any_number_of_shards(shape):
    """The start drawn shard by shard is the lattice the whole-lattice draw
    gives, on 1, 2 and 4 row shards, and each site follows its Philox word
    under (fold_seed(base), DRAW_TAG)."""
    R, C = shape
    base = 123_457
    whole = draw_planes(base, R, C // 2, device="cpu")
    words = philox_words(fold_seed(base), DRAW_TAG, R, C // 2)
    assert torch.equal(whole[0].float(), torch.where((words & 0x8000) == 0, 1.0, -1.0))
    assert torch.equal(whole[1].float(), torch.where((words >> 31) == 0, 1.0, -1.0))
    for rows in (1, 2, 4):
        out = sharded_lattice_sample(_mesh(rows), 5, MeshStart(shape, base), n_samples=0,
                                     temperature=T, n_burnin=0, final_planes=True)
        assert all(torch.equal(a, b) for a, b in zip(out["final_planes"], whole))
        band = R // rows
        for (i, _), (red, black) in out["shards"].items():
            want = draw_planes_reference(base, band, C // 2, row0=i * band)
            assert torch.equal(red, want[0]) and torch.equal(black, want[1])


@pytest.mark.parametrize("shape", SHAPES)
def test_the_run_is_the_same_on_1_2_and_4_shards_and_the_reference_replays_it(shape):
    """The observables and the final state of a chain from the mesh draw
    are the same on 1, 2 and 4 row shards, and equal the benchmark
    reference's replay of the whole lattice: its final planes, and the last
    sample's magnetization and energy taken from them in float64."""
    R, C = shape
    seed = 2**33 + 17
    outs = [_grid(shape, seed).sample_observables(3, mesh=_mesh(rows), initial="mesh",
                                                  final_rows=list(range(R)))
            for rows in (1, 2, 4)]
    for out in outs[1:]:
        for key in ("magnetization", "energy"):
            assert (out[key] == outs[0][key]).all()
        for a, b in zip(out["final_rows"], outs[0]["final_rows"]):
            assert (a == b).all()
    n_sweeps = CHAIN["n_burnin"] + 3 * CHAIN["n_sweeps"]
    whole = reference.final_rows(seed, shape, [0], n_rows=R, temperature=T, J=1.0,
                                 n_sweeps=n_sweeps)
    got = outs[0]["final_rows"]
    assert torch.equal(torch.from_numpy(got[0]).to(torch.int8), whole["red"])
    assert torch.equal(torch.from_numpy(got[1]).to(torch.int8), whole["black"])
    lattice = merge_checkerboard(whole["red"], whole["black"]).double()
    assert outs[0]["magnetization"][-1] == float(lattice.sum() / lattice.numel())
    assert outs[0]["energy"][-1] == float(lattice_energy_batch(lattice, J=1.0, field=0.0,
                                                               periodic=True))
    assert reference.observables_invalid(outs[0]["magnetization"], outs[0]["energy"], R * C,
                                         3) == 0


@pytest.mark.parametrize("shape", [(64, 128), (128, 64)])
def test_the_strip_replay_equals_the_whole_replay_at_every_boundary(shape):
    """Strips of 8 rows across each of 4 shard boundaries (row 0 across the
    wrap) and one inside a shard, replayed alone with 2n + 2 rows of margin
    each side, equal the whole lattice's replay there."""
    R, C = shape
    band, n_sweeps, seed = R // 4, 6, 99
    firsts = [(i * band - 4) % R for i in range(4)] + [band // 2]
    assert 8 + 2 * (2 * n_sweeps + 2) < R      # the strips replay alone
    strips = reference.final_rows(seed, shape, firsts, n_rows=8, temperature=T, J=1.0,
                                  n_sweeps=n_sweeps)
    whole = reference.final_rows(seed, shape, [0], n_rows=R, temperature=T, J=1.0,
                                 n_sweeps=n_sweeps)
    assert strips["rows"] == [(f + i) % R for f in firsts for i in range(8)]
    assert torch.equal(strips["red"], whole["red"][strips["rows"]])
    assert torch.equal(strips["black"], whole["black"][strips["rows"]])


def test_the_host_draw_route_is_pinned():
    """Without ``initial``, the mesh route draws its start on the host as
    before: these are the outputs of the route before the mesh draw and
    K11's shard mode were added."""
    out = IsingGrid((16, 20), periodic=True, seed=3, device="cpu",
                    config=IsingConfig(n_burnin=5, n_sweeps=2)).sample_observables(
        4, temperature=2.4, mesh=_mesh(2))
    assert out["magnetization"].tolist() == [-0.0125, 0.06875, 0.05, 0.1625]
    assert out["energy"].tolist() == [-336.0, -368.0, -316.0, -316.0]
    lat0 = torch.where(torch.rand((12, 8), generator=torch.Generator().manual_seed(7)) < 0.5,
                       1.0, -1.0)
    out = sharded_lattice_sample(_mesh(2), 9, lat0, n_samples=3, temperature=2.2, n_burnin=3,
                                 n_sweeps=2, final_planes=True)
    assert out["magnetization"].tolist() == [-0.1875, -0.10416666666666667,
                                             0.020833333333333332]
    assert out["energy"].tolist() == [-128.0, -148.0, -136.0]
    red, black = (p.float().flatten().tolist() for p in out["final_planes"])
    assert red == [1.0] * 12 + [-1.0, 1.0] + [-1.0] * 22 + [1.0] * 12
    assert black == ([1.0] * 11 + [-1.0, -1.0, 1.0, 1.0] + [-1.0] * 18
                     + [1.0, -1.0, -1.0, 1.0, 1.0, -1.0] + [1.0] * 5 + [-1.0] + [1.0] * 3)


def test_final_planes_are_absent_unless_asked():
    kw = dict(n_samples=2, temperature=T, n_burnin=1, n_sweeps=1)
    out = sharded_lattice_sample(_mesh(2), 1, MeshStart((16, 16), 5), **kw)
    assert "final_planes" not in out and "final_rows" not in out
    assert set(out) == {"magnetization", "energy", "shards"}
    asked = sharded_lattice_sample(_mesh(2), 1, MeshStart((16, 16), 5), final_planes=True,
                                   **kw)
    assert torch.equal(merge_checkerboard(*asked["final_planes"]),
                       torch.cat([merge_checkerboard(*out["shards"][i, 0]) for i in (0, 1)]))


def test_the_grid_returns_its_final_shards_only_when_asked():
    """``final_shards=True`` hands back the final state's shards, whose
    rows are the ``final_rows``; without it the answer holds no plane."""
    seed, kw = 2**32 + 3, dict(mesh=_mesh(2), initial="mesh")
    out = _grid((16, 16), seed).sample_observables(2, final_rows=list(range(16)), **kw)
    assert set(out) == {"magnetization", "energy", "final_rows"}
    asked = _grid((16, 16), seed).sample_observables(2, final_shards=True, **kw)
    assert set(asked) == {"magnetization", "energy", "final_shards"}
    for k, plane in enumerate(out["final_rows"]):
        got = torch.cat([asked["final_shards"][i, 0][k] for i in (0, 1)]).float()
        assert torch.equal(got, torch.from_numpy(plane))
    with pytest.raises(ConfigurationError, match="pass mesh="):
        _grid((16, 16), seed).sample_observables(2, final_shards=True)


def test_a_field_set_before_a_nonlocal_coupling_is_kept():
    """A grid moved to the dense engine by a coupling between sites that
    are not neighbours keeps the field set on it before, as the model it
    samples and its energies show."""
    import numpy as np

    grid = IsingGrid((4, 4), periodic=True, seed=1, device="cpu")
    h = np.linspace(-1.0, 1.0, 16, dtype=np.float32)
    grid.set_external_field(h)
    grid.set_coupling(0, 5, 0.3)
    assert not grid._fast and np.array_equal(grid.h, h)
    grid.h[3] = 0.25                       # the field is the grid's own, and writable
    states = np.where(np.random.default_rng(2).random((3, 16)) < 0.5, 1.0, -1.0)
    J = grid.J.astype(np.float64)
    want = -0.5 * np.einsum("bi,ij,bj->b", states, J, states) - states @ grid.h.astype(np.float64)
    assert np.allclose(grid.energies(states), want, rtol=0, atol=1e-9)
    assert J[0, 5] == np.float32(0.3) and J[0, 1] == 1.0


@pytest.mark.parametrize("rows", [1, 2, 4])
@pytest.mark.parametrize("periodic", [True, False])
def test_shard_sums_add_up_to_the_lattice_observables(rows, periodic):
    """K11's shard mode (its plain version): each row shard's spin and bond
    sums, with the black rows around it, add up to the whole lattice's
    float64 magnetization and energy."""
    R, C = 16, 12
    red, black = draw_planes(77, R, C // 2)
    lattice = merge_checkerboard(red, black).double()
    band, total = R // rows, torch.zeros(2, dtype=torch.int64)
    zero = torch.zeros(C // 2, dtype=red.dtype)
    for i in range(rows):
        sl = slice(i * band, (i + 1) * band)
        up = black[(i * band - 1) % R] if periodic or i else zero
        down = black[((i + 1) * band) % R] if periodic or i < rows - 1 else zero
        sums = torch.zeros((3, 2), dtype=torch.int64)
        plane_sums(red[sl], black[sl], up, down, sums, 1, periodic=periodic)
        assert torch.equal(sums[1], plane_sums_reference(red[sl], black[sl], up, down,
                                                         periodic=periodic))
        total += sums[1]
    assert float(total[0].double() / lattice.numel()) == float(lattice.mean())
    assert float(-total[1].double()) == float(lattice_energy_batch(lattice, J=1.0, field=0.0,
                                                                   periodic=periodic))


def test_the_mesh_draw_refuses_what_it_cannot_do(tmp_path):
    grid = _grid((16, 16), 1)
    with pytest.raises(ConfigurationError, match="pass mesh="):
        grid.sample_observables(2, initial="mesh")
    with pytest.raises(ConfigurationError, match="or 'mesh'"):
        grid.sample_observables(2, mesh=_mesh(2), initial="device")
    with pytest.raises(ConfigurationError, match="not snapshotted"):
        sharded_lattice_sample(_mesh(2), 1, MeshStart((16, 16), 5), n_samples=2,
                               temperature=T, checkpoint_path=str(tmp_path / "ck"),
                               checkpoint_every=1)
    with pytest.raises(ValueError, match="R >= 1"):
        draw_planes(1, 0, 4)
    with pytest.raises(ValueError, match="must be 6 values"):
        red, black = draw_planes(1, 4, 6)
        plane_sums(red, black, black[0, :3], black[0], torch.zeros((1, 2), dtype=torch.int64),
                   0)


def test_the_full_size_check_tool_agrees_with_the_run():
    """``tools/sharded_check.py``'s int64 reduction of the final shards,
    block by block, gives the run's last magnetization and energy."""
    from tsu_tpu_torch.tools.sharded_check import check, plain_sums

    line = check((32, 48), 4, 2**32 + 9, n_burnin=2, n_sweeps=2, n_samples=2,
                 devices=["cpu"] * 4)
    assert line["equal"] and line["program"] == line["float64"]
    out = sharded_lattice_sample(_mesh(2), 3, MeshStart((16, 16), 8), n_samples=1,
                                 temperature=T, n_burnin=2, n_sweeps=1, final_planes=True)
    lattice = merge_checkerboard(*out["final_planes"]).double()
    spins, bonds = plain_sums(out["shards"], block=2)
    assert spins == float(lattice.sum())
    assert -bonds == float(lattice_energy_batch(lattice, J=1.0, field=0.0, periodic=True))
