"""Timing helpers of the measurement tools and ``chip_smoke.py``.

On the card every time is the device's: CUDA events around work queued on
the current stream. ``graph_ms`` replays the launches from one CUDA graph,
for kernels that take less device time than the host's launch path, where
launches one by one would time the host. On the CPU (the tools' ``--device
cpu``) ``unit_ms`` falls to the host clock, and its times are the CPU's.
"""

from __future__ import annotations

import subprocess
import time

import torch


def card() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (the first card)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0].strip()


def event_ms(fn, n: int) -> float:
    """Device ms per unit of ``fn(n)``, which queues n units of work: CUDA
    events before and after, synchronised."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn(n)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n: int) -> float:
    """Device ms per launch of ``fn(n)``'s n kernel launches, captured in one
    CUDA graph and replayed, so that they run back to back. ``fn`` must not
    copy host memory to the card (a capture refuses it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(2)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn(n)
    graph.replay()
    return event_ms(lambda _: graph.replay(), n)


def synchronize(device: torch.device):
    """Wait for the card's queued work; nothing to wait for on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_ms(fn, n: int) -> float:
    """Host-clock ms per unit of ``fn(n)``, for work on the CPU."""
    t0 = time.perf_counter()
    fn(n)
    return (time.perf_counter() - t0) * 1e3 / n


def unit_ms(fn, n: int, device: torch.device, graph: bool = False) -> float:
    """ms per unit of ``fn(n)`` on ``device``: from a CUDA graph (``graph``)
    or CUDA events on the card, the host clock on the CPU."""
    if device.type != "cuda":
        return host_ms(fn, n)
    return graph_ms(fn, n) if graph else event_ms(fn, n)


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
                "cudaGraphLaunch")


def host_launches(fn) -> int:
    """The host's launch calls (kernels, and CUDA graphs, each one call)
    while ``fn()`` runs, counted by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key in LAUNCH_CALLS)
