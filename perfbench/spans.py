"""What the program's own spans and counters hold in a traced window, for
the per-layer metrics that read inside ``tsu_tpu_torch``.

The program's spans (``tsu_tpu_torch.profiling.annotate``) are
``record_function`` annotations, so the window's host events
(``run.trace.host``) hold them on the device trace's clock. Its counters
and the device times of its device spans live in
``tsu_tpu_torch.profiling``. Tracing is on in the program only while a
profiler runs, which in a run is the traced window alone, so both hold the
window's calls. Every function here reads nothing (None) from a window that
drove no device, as the other device-trace metrics do, or from a program
that has no such span or counter.
"""

from __future__ import annotations


def _on_card(run) -> bool:
    return run.trace is not None and bool(run.trace.device) and run.calls > 0


def _profiling():
    from tsu_tpu_torch import profiling

    return profiling


def params(run) -> dict:
    """A call's settings: the configuration's, then the mix's."""
    return {**run.cell.config, **run.cell.mix.get("call", {})}


def host_ms(run, name: str):
    """(count, total host milliseconds) of the spans ``name`` in the
    window, or None without one."""
    if not _on_card(run):
        return None
    times = [(end - start) / 1e3 for start, end, op in run.trace.host if op == name]
    return (len(times), sum(times)) if times else None


def counter(run, name: str):
    """The program's counter ``name`` in the window, or None when nothing
    was counted under that name."""
    counters = getattr(_profiling(), "counters", None)
    if not _on_card(run) or counters is None:
        return None
    return counters().get(name)


def device_ms(run, name: str):
    """(count, total device milliseconds) of the device spans ``name`` in
    the window, from their CUDA events, or None without one."""
    span_device_ms = getattr(_profiling(), "span_device_ms", None)
    if not _on_card(run) or span_device_ms is None:
        return None
    spans, ms = span_device_ms(name)
    return (spans, ms) if spans else None
