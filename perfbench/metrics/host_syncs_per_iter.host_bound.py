"""host_syncs_per_iter.host_bound (program counter): the program's
``host_syncs`` counter in the traced window over the window's PT
iterations: the points a search waits for the card (reads of device
tensors, each fixed-point test of a Houdayer growth among them, and copies
in from pageable memory). It moves site_updates_per_s.host_bound."""

from perfbench import spans


def read(run):
    n_iters = spans.params(run).get("n_iters")
    syncs = spans.counter(run, "host_syncs")
    if not n_iters or syncs is None:
        return None
    return syncs / (run.calls * n_iters)
