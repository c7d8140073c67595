"""device_idle_pct (device trace): 100 x (1 - the union of the kernel,
memcpy and memset intervals / the traced window's wall). Nothing to read
without device events."""


def read(run):
    t = run.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
