"""Benchmark orchestrator.

Counterpart of ``tsu_tpu/benchmarks/runner.py``: runs the four suites
(sampling, optimization, ML, comparison) on ``device`` (default the card),
prints a summary, writes ``benchmark_results.json`` and
``benchmark_report.txt`` in the reference's layout, and records the
topology of the run (the torch devices, the torch and CUDA versions, the
card's name and power limit, and the multi-process runtime's processes,
hosts and process-group backend). ``routes`` keeps each suite's row routes,
printed beside the rows.

CLI: python -m tsu_tpu_torch.benchmarks.runner [--quick] [--seed N]
     [--output-dir DIR] [--no-save] [--resume] [--device DEV]
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import time
from typing import Optional

import torch

from tsu_tpu_torch.config import resolve_device


class BenchmarkRunner:
    """Run all benchmark suites and persist results."""

    def __init__(self, seed: int = 0, output_dir: str = "visual_output", device=None):
        self.seed = seed
        self.output_dir = output_dir
        self.device = resolve_device(device)
        self.all_results = {}
        self.routes = {}

    def _topology(self) -> dict:
        from tsu_tpu_torch.parallel import distributed
        from tsu_tpu_torch.tools.timing import card

        on_card = self.device.type == "cuda"
        return {
            "backend": self.device.type,
            "n_devices": torch.cuda.device_count() if on_card else 1,
            "device_kind": torch.cuda.get_device_name(self.device) if on_card else "cpu",
            "card": card() if on_card else None,
            "n_hosts": distributed.n_hosts(),
            "n_processes": distributed.world_size(),
            "dist_backend": distributed.backend(),
            "python": platform.python_version(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
        }

    def run_all(self, quick: bool = False, save_results: bool = True,
                resume: bool = False) -> dict:
        """Run every suite. ``resume=True`` skips suites already recorded in
        ``<output_dir>/benchmark_partial.json`` (written after each suite
        completes, removed on success), so a run cut short restarts at the
        suite boundary."""
        from tsu_tpu_torch.benchmarks.comparison import ComparisonBenchmark
        from tsu_tpu_torch.benchmarks.ml import MLBenchmark
        from tsu_tpu_torch.benchmarks.optimization import OptimizationBenchmark
        from tsu_tpu_torch.benchmarks.sampling import SamplingBenchmark

        t_start = time.perf_counter()
        print(f"tsu_tpu_torch benchmark suite ({'quick' if quick else 'full'} mode)")
        print(f"topology: {self._topology()}")
        print("=" * 64)

        partial_path = os.path.join(self.output_dir, "benchmark_partial.json")
        suites = {}
        resumed = False
        if resume and os.path.exists(partial_path):
            with open(partial_path) as f:
                part = json.load(f)
            if part.get("seed") == self.seed and part.get("quick") == quick:
                suites = part.get("suites", {})
                resumed = bool(suites)
                print(f"resuming past completed suites: {sorted(suites)}")
            else:
                print("partial file is from a different seed/mode; ignoring")

        dev = self.device
        suite_defs = [
            ("sampling", "sampling quality",
             lambda: SamplingBenchmark(seed=self.seed, device=dev), "run_all_benchmarks"),
            ("optimization", "optimization",
             lambda: OptimizationBenchmark(seed=self.seed, device=dev), "run_all_benchmarks"),
            ("ml", "ML / BNN calibration",
             lambda: MLBenchmark(seed=self.seed, device=dev), "run_all_benchmarks"),
            ("comparison", "method comparisons",
             lambda: ComparisonBenchmark(seed=self.seed, device=dev), "run_all_comparisons"),
        ]
        for i, (name, title, make, method) in enumerate(suite_defs):
            if name in suites:
                continue
            print(f"\n[{i + 1}/{len(suite_defs)}] {title} ...")
            t_suite = time.perf_counter()
            suite = make()
            suites[name] = [r.summary() for r in getattr(suite, method)(quick)]
            self.routes[name] = dict(suite.routes)
            for row in suites[name]:
                print("  ", row)
            print(f"  routes: {self.routes[name]}")
            print(f"  [{name}: {time.perf_counter() - t_suite:.1f}s wall]")
            if save_results:
                os.makedirs(self.output_dir, exist_ok=True)
                with open(partial_path, "w") as f:
                    json.dump({"seed": self.seed, "quick": quick, "suites": suites}, f,
                              default=str)

        if save_results and os.path.exists(partial_path):
            os.remove(partial_path)

        self.all_results = {
            "topology": self._topology(),
            "seed": self.seed,
            "quick": quick,
            # A resumed run's wall covers only the suites it re-ran.
            "total_time_s": round(time.perf_counter() - t_start, 2),
            "resumed_run": resumed,
            "suites": suites,
        }
        print("\n" + "=" * 64)
        print(f"total: {self.all_results['total_time_s']:.1f}s")

        if save_results:
            self._save_results()
        return self.all_results

    def _save_results(self):
        os.makedirs(self.output_dir, exist_ok=True)
        json_path = os.path.join(self.output_dir, "benchmark_results.json")
        with open(json_path, "w") as f:
            json.dump(self.all_results, f, indent=2, default=str)
        txt_path = os.path.join(self.output_dir, "benchmark_report.txt")
        with open(txt_path, "w") as f:
            f.write("tsu_tpu_torch benchmark report\n")
            f.write(f"topology: {self.all_results['topology']}\n\n")
            for suite, rows in self.all_results["suites"].items():
                f.write(f"## {suite}\n")
                for row in rows:
                    f.write(f"  {row}\n")
                f.write("\n")
        print(f"saved: {json_path}, {txt_path}")


def main(argv: Optional[list] = None):
    parser = argparse.ArgumentParser(description="tsu_tpu_torch benchmark runner")
    parser.add_argument("--quick", action="store_true", help="reduced sizes")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output-dir", default="visual_output")
    parser.add_argument("--no-save", action="store_true")
    parser.add_argument("--resume", action="store_true",
                        help="skip suites recorded in benchmark_partial.json")
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args(argv)
    runner = BenchmarkRunner(seed=args.seed, output_dir=args.output_dir, device=args.device)
    runner.run_all(quick=args.quick, save_results=not args.no_save, resume=args.resume)


if __name__ == "__main__":
    main()
