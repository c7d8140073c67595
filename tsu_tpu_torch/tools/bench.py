"""Headline benchmark: Ising spin flips per second on one card.

Run from the repository root on a machine with a card:

    python3 -m tsu_tpu_torch.tools.bench [--size 4096] [--device cpu]

Prints one JSON line, last, with the keys of the JAX package's bench.py:
``metric`` (``ising_spin_flips_per_s_per_chip_<size>x<size>``), ``value`` and
``unit`` (flips/s of K1, the fused sweep, through ``fused_sweeps``: bf16
planes from all-ones, T = 2.269, ``--sweeps`` 5,000 sweeps a call),
``vs_baseline`` (value / 4.4e5, the reference emulator's throughput,
BASELINE.md) and ``ea_bond_flips_per_s`` (K4, the bond half-sweep, in its
discrete packed mode on +-1 bonds drawn from seed 42 with a CPU
``torch.Generator``, T = 1.2, ``--ea-sweeps`` 1,000 sweeps a call). Each
rate is the median of ``--trials`` trials of ``--calls`` calls after one
warm-up call, timed with CUDA events; an earlier line prints each trial,
the min and the max. It runs on the card and raises without one, unless
``--device cpu`` asks for the plain versions (whose rates are the CPU's). It
writes no file.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.ops.checkerboard import split_checkerboard
from tsu_tpu_torch.ops.checkerboard_bonds import color_bond_weights, pack_bond_codes
from tsu_tpu_torch.ops.checkerboard_bonds_kernel import checkerboard_sweeps_bonds_kernel
from tsu_tpu_torch.ops.checkerboard_fused import fused_sweeps
from tsu_tpu_torch.tools.kernel_bench import throughput
from tsu_tpu_torch.tools.timing import card

REFERENCE_FLIPS_PER_S = 4.4e5   # BASELINE.md: the reference software's throughput


def ea_codes(size: int, device) -> dict:
    """Packed codes of +-1 bonds (Jh, Jv) drawn from seed 42, periodic."""
    gen = torch.Generator().manual_seed(42)
    Jh, Jv = (torch.where(torch.rand((size, size), generator=gen) < 0.5, 1.0, -1.0)
              for _ in range(2))
    return pack_bond_codes(color_bond_weights(Jh.to(device), Jv.to(device), 0.0, True))


def trials(step, size, per_call, calls, n_trials, device, log, what) -> float:
    """Median flips/s over n_trials trials of ``calls`` calls; logs each."""
    rates = [size * size / throughput(step, size, torch.bfloat16, calls, per_call, device)
             for _ in range(n_trials)]
    log(f"{what}: trials {rates} flips/s; min {min(rates):.6e}, max {max(rates):.6e}, "
        f"median {float(np.median(rates)):.6e}")
    return float(np.median(rates))


def headline_rate(size: int = 4096, sweeps: int = 5000, calls: int = 3, n_trials: int = 3,
                  device=None, log=print) -> float:
    """The headline: K1's flips/s at size^2 through ``fused_sweeps``, the
    median of n_trials trials of ``calls`` calls of ``sweeps`` sweeps."""
    def fused_step(red, black, i, n, T):
        return fused_sweeps(1 + i * 7919, red, black, T, n)

    return trials(fused_step, size, sweeps, calls, n_trials, resolve_device(device), log,
                  f"K1 fused_sweeps {size}^2 bf16, {sweeps} sweeps/call")


def run(size: int = 4096, sweeps: int = 5000, ea_sweeps: int = 1000, calls: int = 3,
        n_trials: int = 3, device=None, log=print) -> dict:
    """The benchmark's JSON object."""
    device = resolve_device(device)
    log(card() if device.type == "cuda" else "cpu")
    value = headline_rate(size, sweeps, calls, n_trials, device, log)
    codes = ea_codes(size, device)

    def bond_step(red, black, i, n, T):
        return checkerboard_sweeps_bonds_kernel(1 + i, red, black, codes, 1.2, n, periodic=True,
                                                discrete=True, pure=True)

    ea = trials(bond_step, size, ea_sweeps, calls, n_trials, device, log,
                f"K4 discrete packed +-1 {size}^2 bf16, T=1.2, {ea_sweeps} sweeps/call")
    return {"metric": f"ising_spin_flips_per_s_per_chip_{size}x{size}", "value": value,
            "unit": "flips/s", "vs_baseline": value / REFERENCE_FLIPS_PER_S,
            "ea_bond_flips_per_s": ea}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--sweeps", type=int, default=5000)
    ap.add_argument("--ea-sweeps", type=int, default=1000)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default=None, help="cpu for the plain versions; default the card")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.size, args.sweeps, args.ea_sweeps, args.calls, args.trials,
                         args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
