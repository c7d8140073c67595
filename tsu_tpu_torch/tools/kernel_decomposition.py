"""Attribute the fused sweep's time on the card to its parts.

Run from the repository root on a machine with a card:

    python3 -m tsu_tpu_torch.tools.kernel_decomposition [--size 4096] [--sweeps 500]
        [--device cpu]

Times K1, the fused heat-bath sweep, and its three decomposition variants
(``tsu_tpu_torch/ops/kernel_decomposition.py``: ``nomath``, ``prng_grouped``,
``prng_only``) on an all-ones bf16 lattice, each as ``--sweeps`` chained
launches captured in one CUDA graph and replayed (a variant may take less
device time than the host's launch path), with CUDA events. For each it
prints flips/s and ms per sweep; then the share of K1's time that each part
removed accounts for: the select chain, shuffles, warp-edge batch and second
colour (K1 - nomath), the black reads (nomath - prng_grouped), the redraws of
the strips' halo rows (prng_grouped - prng_only), and the floor of Philox,
threshold and plane writes (prng_only). The last line is one JSON object with every number. It
needs a card and writes no file.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.ops.checkerboard import split_checkerboard
from tsu_tpu_torch.ops.checkerboard_fused import fused_sweep, sigmoid_table16
from tsu_tpu_torch.ops.kernel_decomposition import decomposition_sweep
from tsu_tpu_torch.tools.timing import card, unit_ms

VARIANTS = ("baseline", "nomath", "prng_grouped", "prng_only")
PARTS = {   # share of K1's time: (slower variant, faster variant)
    "select chain, shuffles, edges and second colour": ("baseline", "nomath"),
    "black reads": ("nomath", "prng_grouped"),
    "halo row redraws": ("prng_grouped", "prng_only"),
    "floor: Philox, threshold, plane writes": ("prng_only", None),
}


def chain(variant: str, black: torch.Tensor, table: torch.Tensor):
    """fn(n): n chained sweeps of ``variant`` from ``black`` (baseline is K1),
    sweep k under the key (fold_seed(1), k)."""
    def go(n):
        b = black
        for k in range(n):
            if variant == "baseline":
                _, b = fused_sweep(b, table, seed=1, sweep=k)
            else:
                _, b = decomposition_sweep(variant, b, seed=1, sweep=k)
    return go


def run(size: int = 4096, sweeps: int = 500, device=None) -> dict:
    """Time every variant at size^2 bf16, periodic; returns the numbers."""
    dev = resolve_device(device)
    black = split_checkerboard(torch.ones((size, size), dtype=torch.bfloat16))[1].to(dev)
    table = sigmoid_table16(1.0, 0.0, 2.269).to(dev)
    ms = {v: unit_ms(chain(v, black, table), sweeps, dev, graph=True) for v in VARIANTS}
    shares = {part: (ms[a] - (ms[b] if b else 0.0)) / ms["baseline"]
              for part, (a, b) in PARTS.items()}
    return {"device": card() if dev.type == "cuda" else "cpu", "size": size, "sweeps": sweeps,
            "dtype": "bf16",
            "ms_per_sweep": ms,
            "flips_per_s": {v: size * size / (t * 1e-3) for v, t in ms.items()},
            "share_of_baseline": shares}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--sweeps", type=int, default=500)
    ap.add_argument("--device", default=None, help="cpu for the plain versions; default the card")
    args = ap.parse_args(argv)
    out = run(args.size, args.sweeps, args.device)
    print(out["device"])
    for v in VARIANTS:
        print(f"{v:14s} {args.size}^2 bf16: {out['flips_per_s'][v]:.4e} flips/s, "
              f"{out['ms_per_sweep'][v]:.6f} ms/sweep ({args.sweeps} sweeps, one CUDA graph)")
    for part, share in out["share_of_baseline"].items():
        print(f"share of K1's time, {part}: {share:.4f}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
