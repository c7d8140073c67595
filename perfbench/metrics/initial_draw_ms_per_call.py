"""initial_draw_ms_per_call (program span): host milliseconds of the
program's ``ising.initial_draw`` spans (the lattice's uniforms drawn on the
CPU, their +-1 map and the copy in) in the traced window, over its calls."""

from perfbench import spans


def read(run):
    got = spans.host_ms(run, "ising.initial_draw")
    return None if got is None else got[1] / run.calls
