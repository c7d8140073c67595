"""launch_calls_per_sweep (device trace): the host's launch calls the
profiler saw in the traced window (kernels, and a CUDA graph as one call)
over the sweeps the window did. Nothing to read when the profiler saw fewer
launches than the port's own launch counters counted in the window: it then
misses launches."""


def read(run):
    t = run.trace
    if t is None or not t.launches or t.launches < run.port_launches:
        return None
    return t.launches / (run.calls * run.work["sweeps"])
