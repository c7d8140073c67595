"""The observables of a lattice's compact planes (K11,
``ops/plane_observables.py``) on the CPU: the wrapper's checks, which raise
before anything is built; the integer sums K11 takes, which give the merge
route's float64 magnetization and energy bit for bit; and the CPU route of
``IsingGrid.sample_observables``, which stays the merge and never counts a
sample of K11. The kernel itself runs in tests/test_torch_gpu.py."""

import pytest
import torch

from tsu_tpu_torch import IsingGrid, profiling
from tsu_tpu_torch.models import ising
from tsu_tpu_torch.ops import plane_observables as k11
from tsu_tpu_torch.ops.checkerboard import (
    lattice_energy_batch,
    merge_checkerboard,
    neighbor_sum_half,
    split_checkerboard,
)


def _planes(shape, seed=0, dtype=torch.bfloat16):
    lat = torch.where(torch.rand(shape, generator=torch.Generator().manual_seed(seed)) < 0.5,
                      1.0, -1.0)
    return [p.to(dtype).contiguous() for p in split_checkerboard(lat)]


@pytest.fixture
def no_build(monkeypatch):
    def refuse(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(k11, "library", refuse)


def _launch(red, black, **kw):
    m = torch.zeros(4, dtype=torch.float64)
    k11.plane_observables(red, black, m, m.clone(), 0, k11.observables_scratch((8, 6), "cpu"),
                          J=1.0, **kw)


@pytest.mark.parametrize("case, match", [
    ("float16", "float32 or bfloat16"),
    ("dtypes differ", "float32 or bfloat16 alike"),
    ("odd rows", "even R"),
    ("one row", "even R"),
    ("shapes differ", "one .* shape"),
    ("flat", "one .* shape"),
    ("on the cpu", "CUDA device"),
])
def test_checks_raise_before_any_build(no_build, case, match):
    """Wrong dtype, an odd number of rows (a plane of R x C/2 takes the
    lattice's rows as they are: K1's planes have an even number), planes
    that do not match, and planes off the card each raise ValueError
    before the library is built."""
    red, black = _planes((8, 12))
    if case == "float16":
        red, black = red.half(), black.half()
    elif case == "dtypes differ":
        black = black.float()
    elif case == "odd rows":
        red, black = red[:7].contiguous(), black[:7].contiguous()
    elif case == "one row":
        red, black = red[:1].contiguous(), black[:1].contiguous()
    elif case == "shapes differ":
        black = black[:, :4].contiguous()
    elif case == "flat":
        red, black = red.reshape(-1), black.reshape(-1)
    with pytest.raises(ValueError, match=match):
        _launch(red, black)


@pytest.mark.parametrize("shape, want", [((2, 1), 1), ((4096, 2048), 512), ((1024, 2048), 128),
                                         ((8192, 4096), 1024), ((3, 64, 64), 1)])
def test_blocks_and_scratch_follow_the_planes(shape, want):
    """A block for each 16,384 compact sites of a lattice, at least one and
    at most MAX_BLOCKS; the scratch holds two partial sums a block and a
    ticket a lattice, all zero."""
    *batch, R, C2 = shape
    assert k11.blocks(R, C2) == want
    scratch = k11.observables_scratch(shape, "cpu")
    B = batch[0] if batch else 1
    assert scratch.dtype == torch.int64 and scratch.numel() == B * (2 * want + 1)
    assert int(scratch.abs().sum()) == 0


def _integer_route(red, black, J, field, periodic):
    """K11's arithmetic: the spin sum and the bond sum (red times its black
    neighbour sum, wrapped or open) as integers, then m and e in float64 in
    the kernel's order."""
    r, b = red.to(torch.int64), black.to(torch.int64)
    spin = int(r.sum() + b.sum())
    bond = int((r * neighbor_sum_half(b, True, periodic)).sum())
    n = 2 * red.numel()
    return spin / n, (-J) * float(bond) - field * float(spin)


@pytest.mark.parametrize("shape", [(2, 2), (6, 10), (64, 64), (130, 250)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "open"])
@pytest.mark.parametrize("J, field", [(1.0, 0.0), (0.7, 0.3), (-1.3, -0.45)])
def test_integer_sums_give_the_merge_routes_float64(shape, periodic, J, field):
    """The two integer sums of the planes, turned into m = spin / N and
    e = (-J) bond - field spin, equal the merged lattice's float64
    magnetization and lattice_energy_batch bit for bit, with a coupling
    and a field that round."""
    red, black = _planes(shape, seed=shape[0])
    m, e = _integer_route(red, black, J, field, periodic)
    lattice = merge_checkerboard(red, black).float()
    want_m = lattice.to(torch.float64).sum() / lattice.numel()
    want_e = lattice_energy_batch(lattice, J=J, field=field, periodic=periodic)
    assert m == float(want_m) and e == float(want_e)


def test_sample_observables_on_the_cpu_take_the_merge_route(monkeypatch):
    """On the CPU every sample goes through the merge and
    lattice_energy_batch, K11 is never launched, and
    ``observables.fused_samples`` is never counted."""
    energy, calls = ising.lattice_energy_batch, []

    def spy(*a, **k):
        calls.append(1)
        return energy(*a, **k)

    monkeypatch.setattr(ising, "lattice_energy_batch", spy)
    before = k11.plane_observables.launches
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = IsingGrid((16, 16), periodic=True, seed=3, device="cpu").sample_observables(
            n_samples=5, temperature=2.269)
    assert len(calls) == 5 and out["energy"].shape == (5,)
    assert k11.plane_observables.launches == before
    assert "observables.fused_samples" not in profiling.counters()
    assert profiling.counters()["host_syncs"] > 0
