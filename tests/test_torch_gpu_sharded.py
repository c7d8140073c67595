"""The sharded lattice's own kernels on the card: K12, the start drawn shard by
shard (``ops/lattice_draw.py``), against its plain Philox draw, and K11's
shard mode (``ops/plane_observables.py:plane_sums``) against plain int64 and
float64 reductions; a run of four row shards of one card against one shard
and against the same run on the CPU; and a shard plane of more than 2^31
sites, past every int32 offset.

Marked ``gpu``: without CUDA every test skips. On a machine with an NVIDIA
Hopper card and nvcc: ``python -m pytest -m gpu --noconftest
tests/test_torch_gpu_sharded.py``.
"""

import pytest
import torch

from tsu_tpu_torch import IsingConfig, IsingGrid
from tsu_tpu_torch.ops.checkerboard import lattice_energy_batch, merge_checkerboard
from tsu_tpu_torch.ops.lattice_draw import draw_planes, draw_planes_reference
from tsu_tpu_torch.ops.plane_observables import (
    observables_scratch,
    plane_sums,
    plane_sums_reference,
)
from tsu_tpu_torch.parallel import make_mesh, sharded_lattice_sample
from tsu_tpu_torch.parallel.lattice import MeshStart

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R, C2, row0", [(2, 1, 0), (6, 4, 6), (10, 33, 0), (64, 1024, 2),
                                         (4096, 2048, 131070), (2, 131072, 262142)])
def test_k12_equals_the_plain_draw_bit_for_bit(cuda, R, C2, row0, dtype):
    """Vector and site-by-site stores (C2 % 4), ragged last groups, shard
    offsets up to the cell's last row."""
    before = draw_planes.launches
    got = draw_planes(2**31 - 3, R, C2, row0=row0, device=cuda, dtype=dtype)
    want = draw_planes_reference(2**31 - 3, R, C2, row0=row0, dtype=dtype)
    torch.cuda.synchronize()
    assert draw_planes.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g.cpu(), w)


def _halos(black, i, n, periodic):
    """The black rows above and below row shard i of n of ``black``."""
    R = black.shape[0]
    band = R // n
    zero = torch.zeros_like(black[0])
    up = black[(i * band - 1) % R] if periodic or i else zero
    down = black[((i + 1) * band) % R] if periodic or i < n - 1 else zero
    return up.contiguous(), down.contiguous()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("R, C2", [(16, 6), (64, 33), (512, 1024)])
def test_k11_shard_mode_equals_the_plain_sums(cuda, R, C2, periodic, dtype):
    """Each of 4 row shards' int64 sums, written into its row, equal the
    plain version's, and the four add up to the whole lattice's float64
    magnetization and energy."""
    red, black = draw_planes(11, R, C2, dtype=dtype)
    lattice = merge_checkerboard(red, black).double()
    total = torch.zeros(2, dtype=torch.int64)
    band = R // 4
    for i in range(4):
        sl = slice(i * band, (i + 1) * band)
        up, down = _halos(black, i, 4, periodic)
        sums = torch.zeros((3, 2), dtype=torch.int64, device=cuda)
        r, b = red[sl].contiguous().to(cuda), black[sl].contiguous().to(cuda)
        scratch = observables_scratch(r.shape, cuda)
        for row in (2, 0):          # one scratch, launch after launch
            plane_sums(r, b, up.to(cuda), down.to(cuda), sums, row, scratch, periodic=periodic)
        want = plane_sums_reference(red[sl], black[sl], up, down, periodic=periodic)
        assert torch.equal(sums[0].cpu(), want) and torch.equal(sums[2].cpu(), want)
        total += want
    assert float(total[0].double() / lattice.numel()) == float(lattice.mean())
    assert float(-total[1].double()) == float(lattice_energy_batch(lattice, J=1.0, field=0.0,
                                                                   periodic=periodic))


@pytest.mark.parametrize("shape", [(256, 512), (64, 66)])
def test_four_shards_of_one_card_equal_one_shard_and_the_cpu(cuda, shape):
    """The chain from the mesh draw on 4 row shards of one card equals the
    1-shard run bit for bit, and the 4-shard CPU run in its final planes,
    its energies and its spin sums (the card forms m = spin / N by a
    product with 1 / N, one ulp off the CPU's quotient where N is no power
    of two), and the final sample's m and E are those of a plain float64
    reduction of the final planes."""
    kw = dict(n_samples=3, temperature=2.269, n_burnin=3, n_sweeps=2, final_planes=True)
    start = MeshStart(shape, 4242)
    n_sites = shape[0] * shape[1]
    launches = plane_sums.launches
    four = sharded_lattice_sample(make_mesh(rows=4, devices=[cuda] * 4), 7, start, **kw)
    assert plane_sums.launches == launches + 12
    one = sharded_lattice_sample(make_mesh(rows=1, devices=[cuda]), 7, start, **kw)
    cpu = sharded_lattice_sample(make_mesh(rows=4, devices=["cpu"] * 4), 7, start, **kw)
    assert torch.equal(four["magnetization"], one["magnetization"])
    assert torch.equal((four["magnetization"] * n_sites).round(),
                       (cpu["magnetization"] * n_sites).round())
    for other in (one, cpu):
        assert torch.equal(four["energy"], other["energy"])
        for a, b in zip(four["final_planes"], other["final_planes"]):
            assert torch.equal(a.cpu(), b.cpu())
    lattice = merge_checkerboard(*four["final_planes"]).double().cpu()
    assert float(four["magnetization"][-1] * n_sites) == pytest.approx(float(lattice.sum()),
                                                                       abs=1e-6)
    assert float(four["energy"][-1]) == float(lattice_energy_batch(lattice, J=1.0, field=0.0,
                                                                   periodic=True))


def test_the_entry_on_a_card_mesh_equals_the_cpu_mesh(cuda):
    def run(devices):
        grid = IsingGrid((128, 256), periodic=True, seed=2**40 + 3, device=devices[0],
                         config=IsingConfig(n_burnin=4, n_sweeps=3))
        return grid.sample_observables(3, temperature=2.269, initial="mesh",
                                       mesh=make_mesh(rows=4, devices=devices),
                                       final_rows=[0, 31, 32, 127])
    got, want = run([cuda] * 4), run(["cpu"] * 4)
    for key in ("magnetization", "energy"):
        assert (got[key] == want[key]).all()
    for a, b in zip(got["final_rows"], want["final_rows"]):
        assert (a == b).all()


def _block_sums(red, black, up, down, periodic, rows=1024):
    """plane_sums_reference of a shard, taken in blocks of rows on its
    device: the plain int64 reduction, in pieces that fit beside it."""
    R = red.shape[0]
    total = torch.zeros(2, dtype=torch.int64, device=red.device)
    for a in range(0, R, rows):
        b = min(a + rows, R)
        total += plane_sums_reference(red[a:b], black[a:b], black[a - 1] if a else up,
                                      black[b] if b < R else down, periodic=periodic)
    return total


def test_a_shard_plane_above_2_31_sites(cuda):
    """Two shards of 16,400 x 131,072 compact sites (2.15e9 a plane, past
    2^31) on one card: K12 equals the plain draw at every row, and K11's
    shard mode equals the plain int64 reduction taken in blocks."""
    R, C2, base = 16_400, 131_072, 987_654_321
    assert R * C2 > 2**31
    shards = [draw_planes(base, R, C2, row0=i * R, device=cuda) for i in range(2)]
    for i, (red, black) in enumerate(shards):
        for a in range(0, R, 2048):
            b = min(a + 2048, R)
            want = draw_planes_reference(base, b - a, C2, row0=i * R + a, device=cuda)
            assert torch.equal(red[a:b], want[0]) and torch.equal(black[a:b], want[1]), (i, a)
    for i, (red, black) in enumerate(shards):
        up, down = shards[1 - i][1][-1].contiguous(), shards[1 - i][1][0].contiguous()
        sums = torch.zeros((1, 2), dtype=torch.int64, device=cuda)
        plane_sums(red, black, up, down, sums, 0, observables_scratch(red.shape, cuda))
        assert torch.equal(sums[0], _block_sums(red, black, up, down, True)), i
