"""Throughput and a correctness probe of the checkerboard sweep paths.

Run from the repository root:

    python3 -m tsu_tpu_torch.tools.kernel_bench [fused|resident|plain|all]
        [--size 4096] [--sweeps 500] [--iters 3] [--dtype bf16|f32] [--check]
        [--device cpu]

Rows: ``fused``, K1 (one launch per sweep) through ``fused_sweeps``;
``resident``, K6 (``--sweeps`` sweeps in one launch) through
``resident_sweeps``; ``plain(10/call)``, the generator-driven plain path
``checkerboard_sweeps_planes`` at 10 sweeps a call in float32, a yardstick
and not a path the port takes. Each row runs a warm-up call and then
``--iters`` timed calls from an all-ones size^2 lattice at T = 2.269, timed
on the card with CUDA events, and prints flips/s and ms per sweep.
``--check`` first prints <|m|> and <e> per site of each row at 128^2,
T = 2.5: 200 burn-in sweeps, then 400 samples 2 sweeps apart, with batch-means
standard errors. The last line is one JSON object with every number. It runs
on the card and raises without one, unless ``--device cpu`` asks for the
plain versions (whose times are then the CPU's, not the card's).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.ops.checkerboard import (
    checkerboard_sweeps_planes,
    plane_energy_batch,
    split_checkerboard,
)
from tsu_tpu_torch.ops.checkerboard_fused import fused_sweeps
from tsu_tpu_torch.ops.checkerboard_resident import resident_sweeps
from tsu_tpu_torch.tools.timing import card, synchronize, unit_ms

T_BENCH = 2.269
CHECK = dict(size=128, T=2.5, burn_in=200, n_samples=400, thin=2)
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def steps(which: str, dtype: torch.dtype, sweeps: int, device: torch.device) -> dict:
    """name -> (step(red, black, i, n, T) running n sweeps, sweeps per
    timed call, plane dtype)."""
    gen = torch.Generator(device=device).manual_seed(0)
    rows = {}
    if which in ("fused", "all"):
        rows["fused"] = (lambda r, b, i, n, T: fused_sweeps(1 + i * 7919, r, b, T, n),
                         sweeps, dtype)
    if which in ("resident", "all"):
        rows["resident"] = (lambda r, b, i, n, T: resident_sweeps(1 + i * 7919, r, b, T, n),
                            sweeps, dtype)
    if which in ("plain", "all"):
        rows["plain(10/call)"] = (
            lambda r, b, i, n, T: checkerboard_sweeps_planes(gen, r, b, T, n),
            10, torch.float32)
    return rows


def throughput(step, size: int, dtype, n_iters: int, per_call: int, device) -> float:
    """Seconds per sweep of n_iters calls of per_call sweeps after a warm-up
    call; CUDA events on the card, the host clock on the CPU."""
    planes = [p.to(device) for p in split_checkerboard(torch.ones((size, size), dtype=dtype))]
    planes[:] = step(*planes, 0, per_call, T_BENCH)
    synchronize(device)

    def calls(n):
        for i in range(1, n + 1):
            planes[:] = step(*planes, i, per_call, T_BENCH)
    return unit_ms(calls, n_iters, device) * 1e-3 / per_call


def batch_means(x: np.ndarray, n_batches: int = 20):
    b = x[: len(x) // n_batches * n_batches].reshape(n_batches, -1).mean(axis=1)
    return float(b.mean()), float(b.std(ddof=1) / np.sqrt(n_batches))


def moments(step, dtype, device, size=CHECK["size"], T=CHECK["T"], burn_in=CHECK["burn_in"],
            n_samples=CHECK["n_samples"], thin=CHECK["thin"]) -> dict:
    """<|m|> and <e> per site with their standard errors, from an all-ones
    start."""
    red, black = (p.to(device) for p in split_checkerboard(torch.ones((size, size), dtype=dtype)))
    red, black = step(red, black, 0, burn_in, T)
    ms, es = [], []
    for i in range(n_samples):
        red, black = step(red, black, 1 + i, thin, T)
        ms.append((red.float().sum() + black.float().sum()) / (size * size))
        es.append(plane_energy_batch(red.float(), black.float()) / (size * size))
    m, se_m = batch_means(torch.stack(ms).abs().double().cpu().numpy())
    e, se_e = batch_means(torch.stack(es).cpu().numpy())
    return {"abs_m": m, "se_abs_m": se_m, "e": e, "se_e": se_e}


def run(which: str = "all", size: int = 4096, sweeps: int = 500, iters: int = 3,
        dtype: str = "bf16", check: bool = False, device=None, log=print) -> dict:
    """Measure the rows; returns {"device", "size", "dtype", "rows", "check"}."""
    device = resolve_device(device)
    rows = steps(which, DTYPES[dtype], sweeps, device)
    if not rows:
        raise ValueError(f"which must be fused, resident, plain or all, got {which!r}")
    out = {"device": card() if device.type == "cuda" else "cpu", "size": size, "dtype": dtype,
           "rows": {}, "check": {}}
    log(out["device"])
    for name, (step, per_call, dt) in rows.items():
        if check:
            c = out["check"][name] = moments(step, dt, device)
            log(f"{name:16s} {CHECK['size']}^2 T={CHECK['T']}: <|m|>={c['abs_m']:.4f} "
                f"+- {c['se_abs_m']:.4f} <e>={c['e']:.4f} +- {c['se_e']:.4f}")
        s = throughput(step, size, dt, iters, per_call, device)
        out["rows"][name] = {"flips_per_s": size * size / s, "ms_per_sweep": s * 1e3,
                             "sweeps_per_call": per_call}
        log(f"{name:16s} {size}x{size} {'f32' if dt == torch.float32 else 'bf16'}: "
            f"{size * size / s:.4e} flips/s, {s * 1e3:.6f} ms/sweep ({iters} calls of "
            f"{per_call} sweeps)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="all",
                    choices=["fused", "resident", "plain", "all"])
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--sweeps", type=int, default=500)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--device", default=None, help="cpu for the plain versions; default the card")
    args = ap.parse_args(argv)
    out = run(args.which, args.size, args.sweeps, args.iters, args.dtype, args.check, args.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
