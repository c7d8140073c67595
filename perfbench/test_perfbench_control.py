"""The correctness check against its control and against a broken timed
path, on toy copies of the cells on the CPU.

The control is the reference at the next precision below the one the
configuration states (``control_bits``) put in the program's place; each
fault breaks the program underneath a whole run of the harness, whose check
has to read ``correct`` false.
"""

from __future__ import annotations

import pytest
import torch

from perfbench import run
from perfbench.conftest import toy


def driver_of(cell: run.Cell):
    return run.load_module(run.HERE / "traffic" / f"{cell.mix['driver']}.py").Driver(
        cell.config, cell.mix, torch.device("cpu"))


@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_control_fails_the_check(toy_cell, seed):
    cell = toy_cell
    if cell.name == "ea256-pt-houdayer":
        # A cut to 16 bits moves a site's decision once in ~10^5 updates: a
        # toy lattice needs more of them than the toy cell runs.
        cell.config.update({"shape": [32, 32], "n_iters": 200})
    driver = driver_of(cell)
    inputs = driver.inputs(run.call_seed(seed, 0))
    ref = driver.reference(inputs)
    control = driver.as_output(driver.reference(inputs, bits=cell.config["control_bits"]))
    got = driver.compare(control, ref)
    assert any(got[k] > limit for k, limit in cell.spec["limits"].items()), got
    assert all(v == 0 for v in driver.compare(driver.call(inputs), ref).values())


def unchanged_sweeps(monkeypatch, cell):
    """A sweep that returns its state unchanged."""
    if cell.name == "ferro4096-observables":
        monkeypatch.setattr("tsu_tpu_torch.models.lattice_sampler.fused_sweeps",
                            lambda seed, red, black, *a, **k: (red, black))
    else:
        monkeypatch.setattr("tsu_tpu_torch.samplers.tempering._BondPlaneOps.sweep_keyed",
                            lambda self, reds, blacks, keys, modes: (reds, blacks))


def half_the_batch(monkeypatch, cell):
    """Half of the replicas left out of every sweep (the PT batch)."""
    from tsu_tpu_torch.samplers.tempering import _BondPlaneOps

    sweep = _BondPlaneOps.sweep_keyed

    def first_half(self, reds, blacks, keys, modes):
        h = reds.shape[0] // 2
        r, b = sweep(self, reds[:h], blacks[:h], keys[..., :h, :],
                     {n: m[..., :h, :] for n, m in modes.items()})
        return torch.cat([r, reds[h:]]), torch.cat([b, blacks[h:]])
    monkeypatch.setattr(_BondPlaneOps, "sweep_keyed", first_half)


def altered_answer(monkeypatch, cell):
    """An answer altered where it is produced: every seventh sample's
    energy, or the search's returned energy, off by 4."""
    if cell.name == "ferro4096-observables":
        from tsu_tpu_torch.models import ising

        energy = ising.lattice_energy_batch
        calls = []

        def off_once(*a, **k):
            calls.append(1)
            return energy(*a, **k) + (4.0 if len(calls) % 7 == 0 else 0.0)
        monkeypatch.setattr(ising, "lattice_energy_batch", off_once)
    else:
        from tsu_tpu_torch.samplers import tempering_ladder

        search = tempering_ladder.pt_ground_state_search

        def off(*a, **k):
            out = search(*a, **k)
            return {**out, "best_energy": out["best_energy"] + 4.0}
        monkeypatch.setattr("tsu_tpu_torch.samplers.pt_ground_state_search", off)


def skipped_houdayer(monkeypatch, cell):
    """The Houdayer move returns its replicas unchanged."""
    monkeypatch.setattr("tsu_tpu_torch.samplers.tempering_ladder._houdayer",
                        lambda u, r1, b1, r2, b2, periodic: (r1, b1, r2, b2))


FAULTS = {"ferro4096-observables": (unchanged_sweeps, altered_answer),
          "ea256-pt-houdayer": (unchanged_sweeps, half_the_batch, altered_answer,
                                skipped_houdayer)}


def test_sound_run_is_correct(toy_cell):
    result = run.measure(toy_cell, 2**31 + 5, 0.2, False, "cpu", require_card=False)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1


@pytest.mark.parametrize("name, fault", [(name, fault) for name, faults in FAULTS.items()
                                         for fault in faults],
                         ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_fault_reads_incorrect(name, fault, monkeypatch):
    cell = toy(name)
    fault(monkeypatch, cell)
    result = run.measure(cell, 2**31 + 5, 0.2, False, "cpu", require_card=False)
    assert not result["correct"], (fault.__name__, result["compared"])


@pytest.mark.gpu
def test_toy_cells_correct_on_card(toy_cell, card):
    """The harness end to end on the card's kernels, at the toy size."""
    result = run.measure(toy_cell, 2**31 + 9, 0.5, False, card)
    assert result["correct"], result["compared"]
