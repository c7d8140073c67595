"""copy_ms_per_call (device trace): device milliseconds of the host-to-device
and device-to-host copies in the traced window, over its calls."""


def read(run):
    t = run.trace
    if t is None or not t.device or not run.calls:
        return None
    us = sum(e - s for s, e, name, cat in t.device
             if cat == "gpu_memcpy" and ("HtoD" in name or "DtoH" in name))
    return us / 1e3 / run.calls
