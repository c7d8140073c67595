"""site_updates_per_s (host clock): sites x sweeps x lattices of every call
in the window, the one still running at the deadline included, over the
window's seconds on the host clock, from its first call's start to its last
call's end."""


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    w = run.work
    return run.calls * w["sites"] * w["sweeps"] * w["lattices"] / run.window_s
