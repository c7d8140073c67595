"""Run one cell of the tsu_tpu_torch benchmark once and print its result.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many NVIDIA cards as the
cell asks for. Every part is found by name: the cell in ``BENCHMARK.json``
and ``perfbench/workloads/<cell>.json``, its configuration in
``perfbench/configs/<config>.json``, its traffic mix in
``perfbench/traffic/<traffic>.json``, the mix's entry driver in
``perfbench/traffic/<driver>.py`` and each metric's reader in
``perfbench/metrics/<metric>.py``.

A run times back-to-back calls of the entry (one client, a closed loop),
each with a seed of its own drawn from ``--seed``, until ``--seconds`` have
passed, and takes in the call still running then. ``--trace 1`` runs the
mix's first ``trace_calls`` calls once untimed by the profiler, on the host
clock, and then again under torch.profiler, and reports the per-layer
metrics. A per-layer metric whose entry lists the cell by name has to read
something: a run where it reads nothing fails. After the window, calls drawn
from the seed are held against the plain reference in
``perfbench/reference/``. The last line of standard output is one JSON
object; the compared numbers, each beside its limit, close both it and
standard error.
"""

from __future__ import annotations

import os
import time

_T_IMPORT = time.monotonic()

import argparse
import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "tsu_tpu"}
CHECK_TAG, WARMUP_TAG = 2**32, 2**32 + 1   # streams apart from the calls'


def process_age_s() -> float:
    """Seconds since this process started, from /proc; since this module
    was imported where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T_IMPORT


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them (the first
    card), or why they could not be read."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=30).stdout.splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi unreadable: {exc!r}"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import the Python file ``path`` under a name of its own."""
    name = "perfbench_part_" + "".join(ch if ch.isalnum() else "_" for ch in
                                       str(path.relative_to(HERE)))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def call_seed(seed: int, i: int) -> int:
    """The seed of call ``i`` of a run with ``seed``: 62 bits."""
    a, b = np.random.SeedSequence([seed % 2**64, i]).generate_state(2, np.uint32)
    return (int(a) << 30) ^ int(b)


@dataclass
class Cell:
    """What the files of one cell say."""

    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    spec: dict           # perfbench/workloads/<cell>.json
    config: dict         # perfbench/configs/<config>.json
    mix: dict            # perfbench/traffic/<traffic>.json
    end_to_end: list     # BENCHMARK.json's metrics that this cell reports
    per_layer: list


def find_cell(root: Path, name: str) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"perfbench: no workload {name!r} in BENCHMARK.json")
    entry = entries[0]

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    here = root / "perfbench"
    return Cell(name, entry, load_json(here / "workloads" / f"{name}.json"),
                load_json(here / "configs" / f"{entry['config']}.json"),
                load_json(here / "traffic" / f"{entry['traffic']}.json"),
                mine(bench["end_to_end"]), mine(bench["per_layer"]))


@dataclass
class Run:
    """What a metric's reader reads: the cell, the host clock's records and,
    in a traced run, the reduced trace."""

    cell: Cell
    device_kind: str
    setup_s: float = 0.0
    starts: list = field(default_factory=list)    # host seconds, window start 0
    ends: list = field(default_factory=list)
    work: dict = field(default_factory=dict)      # one call's work (driver.work())
    trace: object = None                          # perfbench.trace.Trace
    untraced: list = field(default_factory=list)  # host seconds of the traced calls, untraced
    port_launches: int = 0                        # the port's launch counters, window

    @property
    def calls(self) -> int:
        return len(self.ends)

    @property
    def window_s(self) -> float:
        return self.ends[-1] if self.ends else 0.0


def port_launch_count() -> int:
    """The sum of the port's own launch counters (a ``launches`` attribute on
    its kernel wrappers), over the modules loaded."""
    seen, total = set(), 0
    for name, module in list(sys.modules.items()):
        if name.split(".")[0] != "tsu_tpu_torch" or module is None:
            continue
        for obj in vars(module).values():
            if callable(obj) and isinstance(getattr(obj, "launches", None), int) \
                    and id(obj) not in seen:
                seen.add(id(obj))
                total += obj.launches
    return total


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def read_metrics(run: Run, metrics: list) -> dict:
    """Each metric's reader's value, with its unit. A metric whose reader
    finds nothing to read is left out, unless its ``workloads`` name this
    cell: then the run fails, since a kernel renamed or a counter lost
    would otherwise drop the metric from the record unseen."""
    out = {}
    for m in metrics:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        elif run.cell.name in m.get("workloads", []):
            raise SystemExit(f"perfbench: {m['name']} read nothing in {run.cell.name}, "
                             "which it lists; no result")
    return out


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device, *,
            require_card: bool = True) -> dict:
    """One run of ``cell``; returns the result object. ``device`` and
    ``require_card`` let a test drive a run on the CPU."""
    import torch

    chips = int(cell.entry["chips"])
    if require_card and not (torch.cuda.is_available() and torch.cuda.device_count() >= chips):
        raise SystemExit(f"perfbench: the cell needs {chips} CUDA card(s); "
                         f"torch.cuda.is_available() is {torch.cuda.is_available()}")
    device = torch.device(device)
    on_card = device.type == "cuda"
    driver = load_module(HERE / "traffic" / f"{cell.mix['driver']}.py").Driver(
        cell.config, cell.mix, device)
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    stages = {"torch and the CUDA context": process_age_s()}
    run = Run(cell, kind, work=driver.work())

    driver.call(driver.inputs(call_seed(seed, WARMUP_TAG), warmup=True))
    sync()
    run.setup_s = process_age_s()
    stages["the port's import and libraries, and the warm-up call"] = (
        run.setup_s - stages["torch and the CUDA context"])
    print("perfbench: setup " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items()),
          file=sys.stderr)

    outputs, failed = [], 0
    if trace:
        # The traced calls on the host clock first, undilated by the profiler.
        for i in range(cell.mix["trace_calls"]):
            t = time.perf_counter()
            driver.call(driver.inputs(call_seed(seed, i)))
            sync()
            run.untraced.append(time.perf_counter() - t)
    launches0 = port_launch_count()
    profiler = None
    if trace:
        from perfbench.trace import Profiler
        profiler = Profiler(device)
        profiler.start()
    t0 = time.perf_counter()
    while True:
        i = len(outputs)
        run.starts.append(time.perf_counter() - t0)
        try:
            outputs.append(driver.call(driver.inputs(call_seed(seed, i))))
        except Exception as exc:   # a call that fails ends the window and the run's correctness
            print(f"perfbench: call {i} failed: {exc!r}", file=sys.stderr)
            failed += 1
            run.starts.pop()
            break
        sync()
        run.ends.append(time.perf_counter() - t0)
        if (len(outputs) >= cell.mix["trace_calls"]) if trace else (run.ends[-1] >= seconds):
            break
    run.port_launches = port_launch_count() - launches0
    if profiler is not None:
        t_trace = time.perf_counter()
        run.trace = profiler.stop()
        print(f"perfbench: trace read in {time.perf_counter() - t_trace:.3f} s: "
              f"{len(run.trace.device)} device events, {run.trace.launches} launch calls "
              f"(the port's counters: {run.port_launches})", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    compared = {}
    if outputs:
        rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, CHECK_TAG]))
        picks = rng.choice(len(outputs), size=min(cell.mix["check_calls"], len(outputs)),
                           replace=False)
        if on_card:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        for i in sorted(int(p) for p in picks):
            inputs = driver.inputs(call_seed(seed, i))
            for k, v in driver.compare(outputs[i], driver.reference(inputs)).items():
                compared[k] = max(v, compared.get(k, v))
        durations = np.subtract(run.ends, run.starts).round(3).tolist()
        print(f"perfbench: setup {run.setup_s:.3f} s; {len(outputs)} calls in "
              f"{run.window_s:.3f} s, each {durations} s"
              + (f" (untraced {np.round(run.untraced, 3).tolist()} s)" if trace else "")
              + f"; the reference of call(s) {sorted(int(p) for p in picks)} took "
              f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    if on_card:
        print(f"perfbench: card {card()}", file=sys.stderr)
    limits = cell.spec["limits"]
    correct = (failed == 0 and bool(outputs) and set(compared) == set(limits)
               and all(compared[k] <= limits[k] for k in limits))

    result = {"correct": correct, "attempted": len(outputs) + failed, "failed": failed,
              "metrics": read_metrics(run, cell.per_layer if trace else cell.end_to_end),
              "device": {"platform": "gpu" if on_card else "cpu", "kind": kind,
                         "count": chips if on_card else 0, "memory_peak_bytes": int(peak)}}
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["compared"] = {k: {"value": compared.get(k), "limit": limits[k]} for k in limits}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = find_cell(ROOT, args.workload)
    # Build and kernel caches stay inside the checkout, at fixed paths.
    os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH", str(ROOT / "build" / "torch_kernels"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    result = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
