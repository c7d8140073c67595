"""Profiling and tracing hooks.

Counterpart of ``tsu_tpu/profiling.py`` on ``torch.profiler``: ``trace``
records the host and (with CUDA) the card around a block and writes a
Chrome trace (open it in Perfetto or chrome://tracing), ``annotate`` names
a region of it, and ``Timer`` is a wall-clock span that waits for the card
before it reads the clock. JAX's compilation cache has no counterpart here:
the port compiles its CUDA sources once into ``build/``.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def _default_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "tsu_tpu_torch_trace")


@contextlib.contextmanager
def trace(dir: Optional[str] = None) -> Iterator[profile]:
    """Profile a block and write its Chrome trace to ``dir``/trace.json
    (default under the temporary directory):

        with profiling.trace("traces") as prof:
            samples = grid.sample(100)

    The host is always recorded, the card when CUDA is available; the
    profiler is yielded (``prof.key_averages()`` has the sums by kernel)."""
    dir = dir or _default_dir()
    os.makedirs(dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region inside a trace (``torch.profiler.record_function``)."""
    with record_function(name):
        yield


class Timer:
    """Wall-clock span; with CUDA, the card is synchronised on entry and on
    exit, so the span covers the device work queued inside it."""

    def __init__(self):
        self.elapsed = 0.0

    def __enter__(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.elapsed = time.perf_counter() - self._t0
        return False
