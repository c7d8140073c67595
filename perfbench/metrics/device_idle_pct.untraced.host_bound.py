"""device_idle_pct.untraced.host_bound (device trace and host clock):
100 x (1 - the device's busy seconds in the traced calls / the host
seconds of the same calls run just before without the profiler). The
profiler's cost falls on every host launch, so a launch-bound call reads
more idle under it than it has; this share leaves that cost out."""


def read(run):
    t = run.trace
    if t is None or not t.device or not run.untraced:
        return None
    return 100.0 * (1.0 - t.busy_s / sum(run.untraced))
