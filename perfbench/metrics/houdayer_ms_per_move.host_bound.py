"""houdayer_ms_per_move.host_bound (program span): host milliseconds of the
program's ``pt.houdayer`` spans (a batched Houdayer move: the cluster
growth, the flips and the moved slots' best-state tracking) in the traced
window, over their count. It moves site_updates_per_s.host_bound, the rate
of the cells whose calls the host's launch path bounds."""

from perfbench import spans


def read(run):
    got = spans.host_ms(run, "pt.houdayer")
    return None if got is None else got[1] / got[0]
