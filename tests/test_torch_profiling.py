"""The spans and counters of ``tsu_tpu_torch.profiling`` on the two paths
the benchmark runs, on the CPU.

Without a profiler session, ``annotate`` is one shared null context and
``count`` adds nothing. Under ``torch.profiler.profile``,
``IsingGrid.sample_observables`` and ``pt_ground_state_search`` record
their spans nested under one root span a call, count their Houdayer moves
and growth steps, and count ``host_syncs`` at each site where the host
would wait for the card; the answers are the same bits with tracing on and
off.
"""

import numpy as np
import pytest
import torch

from tsu_tpu_torch import IsingGrid, profiling
from tsu_tpu_torch.ops.houdayer_kernel import GROWTH_CHECK
from tsu_tpu_torch.samplers import pt_ground_state_search
from tsu_tpu_torch.samplers.tempering_ladder import DRAW_ITERS

N_SAMPLES = 3
PT = dict(temperatures=np.geomspace(0.4, 2.0, 4), n_copies=2, houdayer_every=2, n_iters=6,
          quench_sweeps=4)
ROOTS = {"ising.sample_observables", "pt.search"}


def observables():
    grid = IsingGrid((16, 16), periodic=True, seed=3, device="cpu")
    return grid.sample_observables(n_samples=N_SAMPLES, temperature=2.269)


def bonds():
    bits = torch.randint(0, 2, (2, 16, 16), generator=torch.Generator().manual_seed(5))
    return 2.0 * bits - 1.0


def search():
    Jh, Jv = bonds()
    return pt_ground_state_search(7, Jh, Jv, device="cpu", **PT)


def traced(entry):
    """(the entry's answer, its spans as (name, start, end), the counters)
    under the profiler, from cleared counters."""
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = entry()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name.split(".")[0] in ("ising", "lattice", "pt", "bonds", "houdayer")]
    return out, spans, profiling.counters()


def names(spans) -> dict:
    out = {}
    for name, _, _ in spans:
        out[name] = out.get(name, 0) + 1
    return out


def assert_nested_under_one_root(spans):
    roots = [s for s in spans if s[0] in ROOTS]
    assert len(roots) == 1
    _, start, end = roots[0]
    assert all(start <= s <= e <= end for _, s, e in spans)


def test_off_annotate_is_one_null_object_and_count_adds_nothing():
    profiling.reset()
    first = profiling.annotate("ising.observables")
    assert profiling.annotate("pt.search", torch.device("cpu")) is first
    with first:
        profiling.count("host_syncs", 5)
    observables()
    assert profiling.counters() == {}
    assert profiling.span_device_ms("ising.observables") == (0, 0.0)


def test_on_under_trace_and_reset_clears(tmp_path):
    profiling.reset()
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("region"):
            profiling.count("host_syncs", 2)
            profiling.count("host_syncs")
    assert profiling.counters() == {"host_syncs": 3}
    profiling.reset()
    assert profiling.counters() == {}


def test_sample_observables_spans_and_host_syncs():
    _, spans, counts = traced(observables)
    assert names(spans) == {"ising.sample_observables": 1, "ising.initial_draw": 1,
                            "lattice.sweeps": N_SAMPLES + 1, "ising.observables": N_SAMPLES,
                            "ising.readout": 1}
    assert_nested_under_one_root(spans)
    # The copy in of the initial draw, one table copied in a fused_sweeps
    # call (burn-in and each sample block), and the two series read back.
    assert counts == {"host_syncs": 1 + (N_SAMPLES + 1) + 2}
    # On the CPU no span records timing events.
    assert profiling.span_device_ms("ising.observables") == (0, 0.0)


def test_pt_search_spans_moves_and_host_syncs(monkeypatch):
    equal = torch.equal
    tests = []

    def counting_equal(a, b):
        tests.append(None)
        return equal(a, b)

    monkeypatch.setattr(torch, "equal", counting_equal)
    _, spans, counts = traced(search)
    moves = PT["n_iters"] // PT["houdayer_every"]
    blocks = names(spans)["houdayer.grow_block"]
    assert names(spans) == {"pt.search": 1, "pt.draws": 1, "pt.best": PT["n_iters"],
                            "pt.swap": PT["n_iters"], "pt.houdayer": moves,
                            "houdayer.grow_block": blocks, "pt.quench": 1, "pt.readout": 1,
                            "bonds.sweeps": PT["n_iters"] + PT["quench_sweeps"]}
    assert_nested_under_one_root(spans)
    assert counts["houdayer.moves"] == moves == 3
    assert counts["houdayer.growth_steps"] == GROWTH_CHECK * blocks
    # Set-up: both bond planes from host memory, their two +-1 checks, the
    # field, the two checks of each colour's codes, the tables, the betas,
    # the initial planes and the Houdayer slots; a block of draws: the
    # stream ids' and the keys' fold; each torch.equal of the growth; the
    # quench: its tables and its keys' fold; the four reads at the end.
    draws = -(-PT["n_iters"] // DRAW_ITERS)
    assert counts["host_syncs"] == (2 + 2 + 1 + 4 + 1 + 1 + 1 + 1) + 2 * draws + len(tests) \
        + 2 + 4


@pytest.mark.parametrize("entry", [observables, search], ids=["observables", "pt_search"])
def test_tracing_on_and_off_give_the_same_bits(entry):
    off = entry()
    on, _, _ = traced(entry)
    assert off.keys() == on.keys()
    for key in off:
        assert np.array_equal(np.asarray(off[key]), np.asarray(on[key])), key


class _Event:
    """The parts of a profiler event (``_KinetoEvent``) that busy time reads."""

    def __init__(self, start, end, cuda=True, annotation=False):
        self.start, self.end, self.cuda, self.annotation = start, end, cuda, annotation

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.end - self.start

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self.cuda else DeviceType.CPU

    def is_user_annotation(self):
        return self.annotation


def test_profile_paths_busy_time_counts_overlapping_work_once():
    from tsu_tpu_torch.tools.profile_paths import busy_ms_of

    events = [_Event(0, 10), _Event(5, 15), _Event(6, 8), _Event(20, 30),
              _Event(0, 100, cuda=False), _Event(0, 100, annotation=True)]
    assert busy_ms_of(events) == pytest.approx(25 / 1e6)
    assert busy_ms_of([]) == 0
