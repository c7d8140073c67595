"""The extrapolation row's calibration over suite seeds.

Run from the repository root:

    python3 -m tsu_tpu_torch.tools.ml_seed_spread [--seeds 8] [--epochs 2000]
        [--device cpu]

Runs the ML suite's extrapolation row (``benchmarks/ml.py``: 8 anchored
members of a (1, 32, 32, 1) net on 80 points, ``--epochs`` steps) at suite
seeds 0 .. ``--seeds`` - 1 and prints each seed's 95% coverage and
uncertainty ratio, and how many seeds fall in the row's band (coverage in
[0.88, 1], ratio > 5). The row is one seed of an estimator whose coverage
on 200 test points moves with the seed and with the order of float sums
(relu units), so this says how often the band holds. The last line is one
JSON object with every number; the default device is the card.
"""

from __future__ import annotations

import argparse
import json
import sys

from tsu_tpu_torch.benchmarks.ml import MLBenchmark
from tsu_tpu_torch.config import resolve_device

BAND = (0.88, 1.0)      # tests/test_ml.py's extrapolation coverage band
RATIO = 5.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=2000)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = []
    for seed in range(args.seeds):
        r = MLBenchmark(seed=seed, device=dev).benchmark_extrapolation(n_epochs=args.epochs)
        row = r.summary()
        rows.append({"seed": seed, "coverage_95": row["coverage_95"],
                     "uncertainty_ratio": row["uncertainty_ratio"]})
        print(f"seed {seed}: coverage {row['coverage_95']}, ratio {row['uncertainty_ratio']}",
              flush=True)
    in_band = sum(BAND[0] <= r["coverage_95"] <= BAND[1] and r["uncertainty_ratio"] > RATIO
                  for r in rows)
    print(json.dumps({"device": str(dev), "epochs": args.epochs, "rows": rows,
                      "in_band": in_band, "seeds": args.seeds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
