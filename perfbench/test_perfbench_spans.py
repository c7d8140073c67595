"""The six readers of the program's own spans and counters, on hand-made
runs: each reads its span's host or device time or its counter over the
cell's calls, samples or iterations; reads nothing (None) when nothing of
its name was recorded, when the window drove no device, in the other cell,
and from a program without counters; and reads 0 from a zero count."""

from __future__ import annotations

import pytest

from perfbench import run as harness
from perfbench.trace import Trace
from tsu_tpu_torch import profiling

FERRO, PT = "ferro4096-observables", "ea256-pt-houdayer"
KERNEL = [(0.0, 5.0, "fused_sweep_kernel", "kernel")]


def read(name: str, cell: str, host=(), device=KERNEL, calls: int = 2):
    r = harness.Run(harness.find_cell(harness.ROOT, cell), "NVIDIA H100 80GB HBM3",
                    starts=[float(i) for i in range(calls)],
                    ends=[float(i + 1) for i in range(calls)])
    r.trace = Trace(0.0, 1e6 * calls, device=list(device), host=list(host))
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(r)


@pytest.fixture
def program(monkeypatch):
    """The program's counters and device spans, as a test sets them."""
    state = {"counters": {}, "device": {}}
    monkeypatch.setattr(profiling, "counters", lambda: dict(state["counters"]))
    monkeypatch.setattr(profiling, "span_device_ms",
                        lambda name: state["device"].get(name, (0, 0.0)))
    return state


def test_observables_device_ms_per_sample(program):
    n = harness.find_cell(harness.ROOT, FERRO).mix["call"]["n_samples"]
    assert read("observables_device_ms_per_sample", FERRO) is None
    program["device"]["ising.observables"] = (2 * n, 2.0 * n * 1.04)
    assert read("observables_device_ms_per_sample", FERRO) == pytest.approx(1.04)
    assert read("observables_device_ms_per_sample", FERRO, device=()) is None
    assert read("observables_device_ms_per_sample", PT) is None


def test_initial_draw_ms_per_call():
    spans = [(0.0, 130e3, "ising.initial_draw"), (1e6, 1e6 + 150e3, "ising.initial_draw"),
             (0.0, 2e6, "ising.sample_observables")]
    assert read("initial_draw_ms_per_call", FERRO, host=spans) == pytest.approx(140.0)
    assert read("initial_draw_ms_per_call", FERRO, host=spans[2:]) is None
    assert read("initial_draw_ms_per_call", FERRO, host=spans, device=()) is None
    assert read("initial_draw_ms_per_call", PT, host=spans[2:]) is None


def test_host_syncs_per_sample(program):
    n = harness.find_cell(harness.ROOT, FERRO).mix["call"]["n_samples"]
    assert read("host_syncs_per_sample", FERRO) is None
    program["counters"]["host_syncs"] = 2 * (n + 4)
    assert read("host_syncs_per_sample", FERRO) == pytest.approx((n + 4) / n)
    assert read("host_syncs_per_sample", PT) is None
    program["counters"]["host_syncs"] = 0
    assert read("host_syncs_per_sample", FERRO) == 0


def test_houdayer_ms_per_move():
    spans = [(0.0, 250e3, "pt.houdayer"), (3e5, 6e5, "pt.houdayer"),
             (1e5, 2e5, "houdayer.grow_block")]
    assert read("houdayer_ms_per_move.host_bound", PT, host=spans) == pytest.approx(275.0)
    assert read("houdayer_ms_per_move.host_bound", PT, host=spans[2:]) is None
    assert read("houdayer_ms_per_move.host_bound", FERRO, host=[(0.0, 1e3, "ising.readout")]) \
        is None


def test_growth_steps_per_move(program):
    assert read("growth_steps_per_move.host_bound", PT) is None
    program["counters"].update({"houdayer.moves": 100, "houdayer.growth_steps": 36_800})
    assert read("growth_steps_per_move.host_bound", PT) == pytest.approx(368.0)
    program["counters"]["houdayer.growth_steps"] = 0
    assert read("growth_steps_per_move.host_bound", PT) == 0
    program["counters"]["houdayer.moves"] = 0
    assert read("growth_steps_per_move.host_bound", PT) is None


def test_host_syncs_per_iter(program):
    n_iters = harness.find_cell(harness.ROOT, PT).config["n_iters"]
    assert read("host_syncs_per_iter.host_bound", PT, calls=1) is None
    program["counters"]["host_syncs"] = 3 * n_iters
    assert read("host_syncs_per_iter.host_bound", PT, calls=1) == pytest.approx(3.0)
    assert read("host_syncs_per_iter.host_bound", FERRO, calls=1) is None
    program["counters"]["host_syncs"] = 0
    assert read("host_syncs_per_iter.host_bound", PT, calls=1) == 0


@pytest.mark.parametrize("name", ["observables_device_ms_per_sample", "host_syncs_per_sample",
                                  "growth_steps_per_move.host_bound",
                                  "host_syncs_per_iter.host_bound"])
def test_a_program_without_counters_reads_nothing(name, monkeypatch):
    """A program older than its spans and counters (the parent of the
    change that added them) reads nothing, and raises nothing."""
    monkeypatch.delattr(profiling, "counters")
    monkeypatch.delattr(profiling, "span_device_ms")
    assert read(name, PT if name.endswith("host_bound") else FERRO) is None
