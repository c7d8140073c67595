"""The traced window: torch.profiler around whole calls, reduced to what the
per-layer readers and the result's breakdown need.

The profiler's handling follows ``tsu_tpu_torch/tools/profile_paths.py``
(CPU and CUDA activities, the launch calls of ``tools/timing.py``), with one
repair: device time is the union of the kernel, memcpy and memset intervals
on the timeline, not a sum of self times, which counts overlapping work
twice. The profiler's events are read in memory; nothing is written.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import torch

# The host's launch calls: kernels, and a CUDA graph as one call each.
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
                "cudaGraphLaunch")
WINDOW = "perfbench.window"
TOP = 10


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total


def gaps(intervals, start: float, end: float):
    """The (start, end) stretches of [start, end] that no interval covers."""
    out, reach = [], start
    for s, e in sorted(intervals):
        if s > reach:
            out.append((reach, s))
        reach = max(reach, e)
    if reach < end:
        out.append((reach, end))
    return out


@dataclass
class Trace:
    """One traced window: its span on the host, the device's intervals
    (start, end, name, category) clipped to it, the host's launch calls in
    it, and the host ops of the window's thread (start, end, name)."""

    start: float
    end: float
    device: list = field(default_factory=list)
    launches: int = 0
    host: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return union_us((s, e) for s, e, _, _ in self.device) / 1e6

    def kernels_us(self, patterns) -> tuple:
        """(count, total us) of the kernels whose name holds any of
        ``patterns``."""
        hits = [e - s for s, e, name, cat in self.device
                if cat == "kernel" and any(p in name for p in patterns)]
        return len(hits), sum(hits)

    def idle_by_host_op(self) -> dict:
        """Idle device seconds, by the innermost host op running at the
        middle of each idle stretch."""
        idle = defaultdict(float)
        ops = sorted(self.host, key=lambda op: (op[0], -op[1]))   # a parent before its child
        stack, j = [], 0
        for s, e in gaps([(s, e) for s, e, _, _ in self.device], self.start, self.end):
            mid = 0.5 * (s + e)
            while j < len(ops) and ops[j][0] <= mid:
                while stack and stack[-1][1] < ops[j][0]:
                    stack.pop()
                stack.append(ops[j])
                j += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            idle[stack[-1][2] if stack else "host, outside any op"] += (e - s) / 1e6
        return idle

    def breakdown(self) -> dict:
        by_name = defaultdict(float)
        for s, e, name, _ in self.device:
            by_name[name[:120]] += (e - s) / 1e6
        idle = self.idle_by_host_op()
        return {"device_ops": sorted(([k, v] for k, v in by_name.items()),
                                     key=lambda kv: -kv[1])[:TOP],
                "idle_gaps": sorted(([k[:120], v] for k, v in idle.items()),
                                    key=lambda kv: -kv[1])[:TOP]}


def device_kind(name: str) -> str:
    """The category of a device event that is not an annotation."""
    return ("gpu_memcpy" if name.startswith("Memcpy") else
            "gpu_memset" if name.startswith("Memset") else "kernel")


def reduce_events(events) -> Trace:
    """A :class:`Trace` from the profiler's events (``_KinetoEvent``s).
    Device events are the CUDA ones that are not annotations; host ops are
    the CPU ones (operators, annotations and runtime calls) of the window's
    thread."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    rows = []
    for e in events:
        s = e.start_ns() / 1e3
        on_device = e.device_type() == cuda
        rows.append((on_device, e.is_user_annotation(), e.name(), s, s + e.duration_ns() / 1e3,
                     None if on_device else e.start_thread_id()))
    spans = [r for r in rows if not r[0] and r[1] and r[2] == WINDOW]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    _, _, _, start, end, tid = spans[0]
    trace = Trace(start, end)
    for on_device, annotation, name, s, t, thread in rows:
        if t < start or s > end:
            continue
        if on_device:
            if not annotation:
                trace.device.append((max(s, start), min(t, end), name, device_kind(name)))
        elif thread == tid and not (annotation and name == WINDOW):
            trace.launches += name in LAUNCH_CALLS
            trace.host.append((s, t, name))
    return trace


class Profiler:
    """The profiler (Kineto, CPU and, on the card, CUDA activities) over a
    window that :meth:`stop` closes. Its events are read as they are, with
    no export and no event tree."""

    def __init__(self, device: torch.device):
        from torch.autograd.profiler import profile

        self.device = device
        self.prof = profile(use_kineto=True,
                            use_device="cuda" if device.type == "cuda" else None)
        self.span = torch.profiler.record_function(WINDOW)

    def start(self):
        self.prof.__enter__()
        self.span.__enter__()

    def stop(self) -> Trace:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        return reduce_events(self.prof.kineto_results.events())
