"""The cell ``ferro-sharded-4chip`` through the harness on a CPU mesh at a
small size: a sound run is correct, the control and faults of the program
underneath a whole run read incorrect, and the readers of the sharded
path's kernels and spans read what a trace holds, or nothing."""

from __future__ import annotations

import copy

import pytest
import torch

from perfbench import run
from perfbench.trace import Trace

CELL = "ferro-sharded-4chip"


def toy() -> run.Cell:
    """The cell at a size the CPU runs in a second: a 64 x 128 lattice on
    4 row shards of the CPU, 2 + 2 x 2 sweeps a call, all else as
    committed."""
    cell = copy.deepcopy(run.find_cell(run.ROOT, CELL))
    cell.config.update({"shape": [64, 128], "n_burnin": 2, "n_sweeps": 2})
    cell.mix.update({"call": {"n_samples": 2}})
    return cell


def driver_of(cell: run.Cell):
    return run.load_module(run.HERE / "traffic" / f"{cell.mix['driver']}.py").Driver(
        cell.config, cell.mix, torch.device("cpu"))


def test_the_cells_work_and_rows_are_the_configurations():
    driver = driver_of(run.find_cell(run.ROOT, CELL))
    assert driver.work() == {"sweeps": 50, "lattices": 1, "sites": 262144 * 262144}
    assert driver.first_rows == [262140, 65532, 131068, 196604, 32768]
    assert len(driver.rows) == 40 and driver.rows[:5] == [262140, 262141, 262142, 262143, 0]


def test_sound_run_is_correct():
    result = run.measure(toy(), 2**31 + 5, 0.2, False, "cpu", require_card=False)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"site_updates_per_s", "setup_s"}
    assert all(v["value"] == 0 for v in result["compared"].values())


@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_control_fails_the_check(seed):
    cell = toy()
    driver = driver_of(cell)
    inputs = driver.inputs(run.call_seed(seed, 0))
    ref = driver.reference(inputs)
    control = driver.compare(driver.as_output(
        driver.reference(inputs, bits=cell.config["control_bits"])), ref)
    assert control["strip_sites_differing"] > 0, control
    assert all(v == 0 for v in driver.compare(driver.call(inputs), ref).values())


def halos_from_the_shard_itself(monkeypatch):
    """Each shard's two-row black halos wrapped from its own edges, as if
    it were a lattice alone: wrong at every shard boundary."""
    from tsu_tpu_torch.parallel import lattice

    monkeypatch.setattr(lattice, "_halo_exchange2", lambda planes, periodic, grid=None: (
        [[p[-2:] for p in row] for row in planes], [[p[:2] for p in row] for row in planes]))


def spin_sum_off_by_one(monkeypatch):
    """The first shard's spin sum of each call's first sample one too high:
    that sample's magnetization has the wrong parity."""
    from tsu_tpu_torch.ops import plane_observables

    sums, seen = plane_observables.plane_sums_reference, []

    def off(*a, **k):
        seen.append(1)
        return sums(*a, **k) + torch.tensor([int(len(seen) % 8 == 1), 0])
    monkeypatch.setattr(plane_observables, "plane_sums_reference", off)


def start_drawn_from_the_sweep_stream(monkeypatch):
    """The start drawn under the run's first sweep key, (fold_seed(base),
    0), in place of the draw's own tag."""
    from tsu_tpu_torch.ops import lattice_draw

    key = lattice_draw.draw_key
    monkeypatch.setattr(lattice_draw, "draw_key", lambda base: (key(base)[0], 0))


def bond_sums_rounded_to_multiples_of_8(monkeypatch):
    """Every shard's bond sum rounded down to a multiple of 8, as a float32
    total rounds the cell's bond sum of ~9e10 to a multiple of 8192: each
    energy stays a multiple of 4 in [-2N, 2N], and only the plain sums of
    the final planes tell."""
    from tsu_tpu_torch.ops import plane_observables

    sums = plane_observables.plane_sums_reference
    monkeypatch.setattr(plane_observables, "plane_sums_reference", lambda *a, **k: (
        sums(*a, **k) // torch.tensor([1, 8]) * torch.tensor([1, 8])))


def one_shards_sums_left_out(monkeypatch):
    """The last shard's sums left out of the cross-card add."""
    from tsu_tpu_torch.parallel import lattice

    copy, seen = lattice._copy, []

    def drop(t, device, counter=None):
        if t.dtype == torch.int64 and t.dim() == 2:
            seen.append(1)
            if len(seen) % 4 == 0:
                return torch.zeros_like(t)
        return copy(t, device, counter)
    monkeypatch.setattr(lattice, "_copy", drop)


FAULTS = [halos_from_the_shard_itself, spin_sum_off_by_one, start_drawn_from_the_sweep_stream,
          bond_sums_rounded_to_multiples_of_8, one_shards_sums_left_out]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_fault_reads_incorrect(fault, monkeypatch):
    fault(monkeypatch)
    result = run.measure(toy(), 2**31 + 5, 0.2, False, "cpu", require_card=False)
    assert not result["correct"], (fault.__name__, result["compared"])


def test_a_rounded_total_passes_the_validity_check_and_fails_the_sums(monkeypatch):
    bond_sums_rounded_to_multiples_of_8(monkeypatch)
    result = run.measure(toy(), 2**31 + 5, 0.2, False, "cpu", require_card=False)
    compared = {k: v["value"] for k, v in result["compared"].items()}
    assert compared["observables_invalid"] == 0 and compared["strip_sites_differing"] == 0
    assert compared["final_sample_differing"] > 0 and not result["correct"]


@pytest.mark.parametrize("rows,block", [(1, 8192), (2, 2), (4, 4)])
def test_lattice_sums_are_the_lattices(rows, block):
    """The plain sums of row shards, block by block, equal the spin and
    bond sums of the whole lattice they hold."""
    from perfbench.reference import ising, ising_sharded

    R, C = 16, 24
    gen = torch.Generator().manual_seed(rows)
    lattice = torch.where(torch.rand((R, C), generator=gen) < 0.5, 1, -1).to(torch.int8)
    red, black = (p.to(torch.bfloat16) for p in ising_sharded.compact(lattice, torch.arange(R)))
    band = R // rows
    shards = [(red[i * band:(i + 1) * band], black[i * band:(i + 1) * band])
              for i in range(rows)]
    spins, bonds = ising_sharded.lattice_sums(shards, block=block)
    m, e = ising.observables(lattice, 1.0)
    assert spins == int(lattice.sum()) and spins / lattice.numel() == float(m)
    assert -float(bonds) == float(e)


# -- the readers --------------------------------------------------------------

H100 = "NVIDIA H100 80GB HBM3"


def read(name: str, device=(), host=(), calls: int = 2):
    r = run.Run(run.find_cell(run.ROOT, CELL), H100, starts=[float(i) for i in range(calls)],
                ends=[float(i + 1) for i in range(calls)])
    r.work = {"sweeps": 50, "lattices": 1, "sites": 262144 * 262144}
    r.trace = Trace(0.0, 1e6 * calls, device=list(device), host=list(host))
    return run.load_module(run.HERE / "metrics" / f"{name}.py").read(r)


def kernels(name: str, us: float, n: int = 4):
    """n kernel events of ``name`` that take ``us`` microseconds in all."""
    return [(10.0 * k, 10.0 * k + us / n, f"void (anonymous namespace)::{name}<bf16>(...)",
             "kernel") for k in range(n)]


def test_the_roofline_readers_read_their_kernels_only():
    sites = 262144 * 262144
    # Two calls of 50 sweeps at 3 B a site over 3.35 TB/s, in 123 ms of K1 a
    # sweep summed over the cards.
    sweep = kernels("fused_sweep_shard_kernel", 2 * 50 * 123e3) + kernels("lattice_draw_kernel", 9)
    assert read("sweep_roofline_pct.sharded", sweep) == pytest.approx(
        100 * 2 * 50 * 3 * sites / 3.35e12 / (2 * 50 * 123e-3))
    draw = kernels("lattice_draw_kernel", 2 * 20e3)
    assert read("draw_roofline_pct.sharded", draw) == pytest.approx(
        100 * 2 * 2 * sites / 3.35e12 / 40e-3)
    sums = kernels("plane_sums_kernel", 2 * 3 * 50e3) + kernels("plane_observables_kernel", 7)
    assert read("observables_roofline_pct.sharded", sums) == pytest.approx(
        100 * 2 * 3 * 2 * sites / 3.35e12 / 300e-3)
    for name in ("sweep_roofline_pct.sharded", "draw_roofline_pct.sharded",
                 "observables_roofline_pct.sharded"):
        assert read(name, kernels("fused_sweep_kernel", 5.0)) is None


def test_halo_ms_per_sweep():
    device = kernels("fused_sweep_shard_kernel", 10.0)
    halos = [(100.0 * k, 100.0 * k + 40.0, "sharded.halo") for k in range(20)]
    assert read("halo_ms_per_sweep", device, halos + [(0.0, 5e5, "sharded.sweeps")]) == \
        pytest.approx(20 * 0.040 / 100)
    assert read("halo_ms_per_sweep", device) is None
    assert read("halo_ms_per_sweep", (), halos) is None
    # The exchanges of the samples' bond sums are not the sweeps'.
    samples = [(5000.0 + 100.0 * k, 5000.0 + 100.0 * k + 60.0, "sharded.observables")
               for k in range(3)]
    theirs = [(5010.0 + 100.0 * k, 5010.0 + 100.0 * k + 30.0, "sharded.halo") for k in range(3)]
    assert read("halo_ms_per_sweep", device, halos + samples + theirs) == \
        pytest.approx(20 * 0.040 / 100)
