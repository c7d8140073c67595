"""growth_steps_per_move.host_bound (program counter): the program's
``houdayer.growth_steps`` over its ``houdayer.moves`` in the traced window:
the cluster-growth steps a batched Houdayer move launches, each a few
dozen kernels. It moves site_updates_per_s.host_bound."""

from perfbench import spans


def read(run):
    moves = spans.counter(run, "houdayer.moves")
    if not moves:
        return None
    return (spans.counter(run, "houdayer.growth_steps") or 0) / moves
