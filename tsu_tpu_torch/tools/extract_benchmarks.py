"""Summarise the port's benchmark outputs into a new Markdown file.

Counterpart of ``scripts/extract_benchmarks.py``, on the port's outputs:
the runner's ``benchmark_results.json`` (``python -m
tsu_tpu_torch.benchmarks.runner --output-dir DIR``) and any
``scaling_*.json`` beside it (``benchmarks.scaling --output-dir DIR``,
``tools.pod_scaling DIR``). The summary names the card and its power limit
from the run's topology, beside the device count, the processes and hosts,
the seed and the mode, then each suite's rows as a table and each scaling
file's efficiencies.

    python -m tsu_tpu_torch.tools.extract_benchmarks DIR OUT.md

``OUT.md`` must be a new file: the tool refuses to overwrite one, so it
never writes the JAX package's ``BENCHMARK_SUMMARY.md`` or README block.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from datetime import date


def _table(rows: list) -> list:
    keys = list(dict.fromkeys(k for row in rows for k in row))
    lines = ["| " + " | ".join(keys) + " |", "|" + "---|" * len(keys)]
    lines += ["| " + " | ".join(str(row.get(k, "")) for k in keys) + " |" for row in rows]
    return lines


def render(results: dict, scaling: dict) -> str:
    """The summary of a runner's ``results`` and the ``scaling`` files
    (name -> content)."""
    topo = results.get("topology", {})
    card = topo.get("card") or f"no card ({topo.get('backend')})"
    lines = [f"# Benchmark summary of tsu_tpu_torch ({date.today().isoformat()})", "",
             f"Card: {card}; device kind {topo.get('device_kind')}, {topo.get('n_devices')} "
             f"device(s), {topo.get('n_processes', 1)} process(es) on {topo.get('n_hosts')} "
             f"host(s); torch {topo.get('torch')}, CUDA {topo.get('cuda')}.", "",
             f"## Suite results (seed {results.get('seed')}, "
             f"{'quick' if results.get('quick') else 'full'} mode, "
             f"{results.get('total_time_s')} s"
             f"{', a resumed run: the wall covers the re-run suites only' if results.get('resumed_run') else ''})",
             ""]
    for suite, rows in results.get("suites", {}).items():
        lines += [f"### {suite}", ""] + (_table(rows) if rows else []) + [""]
    for name, d in scaling.items():
        t = d.get("topology", {})
        lines += [f"### scaling ({name}; {t.get('n_devices')} device(s), backend "
                  f"{t.get('backend', t.get('platform'))}, card {t.get('card')})", ""]
        for row in ("chains", "bnn_dp", "lattice"):
            r = d.get(row)
            if r is not None:
                lines.append(f"- {row}: efficiency={r.get('efficiency')} "
                             f"(ideal: {r.get('ideal', 'n/a')})")
        lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="summarise the port's benchmark outputs")
    parser.add_argument("results_dir", help="the runner's --output-dir")
    parser.add_argument("out", help="a new Markdown file")
    args = parser.parse_args(argv)
    with open(os.path.join(args.results_dir, "benchmark_results.json")) as f:
        results = json.load(f)
    scaling = {}
    for path in sorted(glob.glob(os.path.join(args.results_dir, "scaling_*.json"))):
        with open(path) as f:
            scaling[os.path.basename(path)] = json.load(f)
    text = render(results, scaling)
    with open(args.out, "x") as f:
        f.write(text + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
