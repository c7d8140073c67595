"""Profiling and tracing hooks.

Counterpart of ``tsu_tpu/profiling.py`` on ``torch.profiler``: ``trace``
records the host and (with CUDA) the card around a block and writes a
Chrome trace (open it in Perfetto or chrome://tracing), ``annotate`` names
a region of it, and ``Timer`` is a wall-clock span that waits for the card
before it reads the clock. JAX's compilation cache has no counterpart here:
the port compiles its CUDA sources once into ``build/``.

Tracing is on exactly while a torch profiler session is active (``trace``,
``torch.profiler.profile`` or ``torch.autograd.profiler.profile``); there is
no other switch. While it is off, ``annotate`` returns one shared null
context and ``count`` adds nothing, so the spans and counters inside the
port's entry points cost one bool check each. While it is on, a span is a
``record_function`` on the profiler's timeline, nested under the spans open
on the calling thread (an entry point's root span holds every span of its
call), and ``count`` adds to a named counter, such as ``host_syncs``: the
points where the host waits for the card (reads of a device tensor, and
copies in from pageable host memory without ``non_blocking``), counted at
the site on any device. Counters and the device times of spans stay in
memory until ``reset``.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import Counter, defaultdict
from typing import Dict, Iterator, Optional, Tuple

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


_OFF = contextlib.nullcontext()
_counts: Counter = Counter()
_event_pairs: Dict[str, list] = defaultdict(list)


class _Span:
    """``annotate``'s span while tracing is on."""

    __slots__ = ("name", "stream", "_region", "_start")

    def __init__(self, name: str, stream):
        self.name, self.stream = name, stream

    def __enter__(self):
        self._region = record_function(self.name)
        self._region.__enter__()
        if self.stream is not None:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            _event_pairs[self.name].append((self._start, end))
        self._region.__exit__(*exc)
        return False


def annotate(name: str, device: Optional[torch.device] = None):
    """A named region inside a trace (``torch.profiler.record_function``),
    recorded only while tracing is on. With a CUDA ``device``, the span
    also records a pair of timing events on that device's current stream,
    which :func:`span_device_ms` reads."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    on_card = device is not None and device.type == "cuda"
    return _Span(name, torch.cuda.current_stream(device) if on_card else None)


def tracing() -> bool:
    """Whether tracing is on: a torch profiler session is active."""
    return torch.autograd.profiler._is_profiler_enabled


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if torch.autograd.profiler._is_profiler_enabled:
        _counts[name] += n


def counters() -> Dict[str, int]:
    """A snapshot of the counters."""
    return dict(_counts)


def span_device_ms(name: str) -> Tuple[int, float]:
    """(spans, total device milliseconds) of the spans ``name`` that
    recorded timing events; waits for the card."""
    pairs = _event_pairs.get(name, [])
    total = 0.0
    for start, end in pairs:
        end.synchronize()
        total += start.elapsed_time(end)
    return len(pairs), total


def reset() -> None:
    """Clear the counters and the spans' timing events."""
    _counts.clear()
    _event_pairs.clear()


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
