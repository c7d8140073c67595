"""The control of a cell's correctness check, and the program's readings
beside it: the numbers that the cell's limits are set from.

    python3 -m perfbench.control --workload <cell> --seeds <n> [<n> ...] [--program]

For each seed, the first call of a run with that seed is made again from
its inputs, and the plain reference is run twice on them: at the precision
that the configuration states, and as the control, the same reference with
its heat-bath uniforms and thresholds cut to the next precision below
(``control_bits`` in the configuration). The control stands in the
program's place and is compared by the cell's own comparison; it has to
fail. ``--program`` also runs the program's call and prints its numbers.
One JSON line per seed, then one with the largest of each number.
"""

from __future__ import annotations

import argparse
import json
import sys

from perfbench.run import HERE, ROOT, call_seed, find_cell, load_module


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    cell = find_cell(ROOT, args.workload)
    device = torch.device(args.device)
    driver = load_module(HERE / "traffic" / f"{cell.mix['driver']}.py").Driver(
        cell.config, cell.mix, device)
    worst = {}
    for seed in args.seeds:
        inputs = driver.inputs(call_seed(seed, 0))
        ref = driver.reference(inputs)
        line = {"seed": seed, "limits": cell.spec["limits"],
                "control": driver.compare(driver.as_output(
                    driver.reference(inputs, bits=cell.config["control_bits"])), ref)}
        if args.program:
            line["program"] = driver.compare(driver.call(inputs), ref)
        for side in ("control", "program"):
            for k, v in line.get(side, {}).items():
                worst.setdefault(side, {})[k] = max(v, worst.get(side, {}).get(k, v))
        print(json.dumps(line), flush=True)
    print(json.dumps({"largest": worst, "card": torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
