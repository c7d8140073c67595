"""halo_ms_per_sweep (program span): host milliseconds of the program's
``sharded.halo`` spans (each halo exchange of the sharded lattice: the
neighbour shards' edge rows sliced and copied between cards) that the
sweeps make, over the window's sweeps. The exchanges inside a
``sharded.observables`` span, one a sample for its bond sums, are left
out."""

from perfbench import spans


def read(run):
    if spans.host_ms(run, "sharded.halo") is None or not run.calls:
        return None
    samples = [(s, e) for s, e, op in run.trace.host if op == "sharded.observables"]
    ms = sum((e - s) / 1e3 for s, e, op in run.trace.host if op == "sharded.halo"
             and not any(a <= s and e <= b for a, b in samples))
    return ms / (run.calls * run.work["sweeps"])
