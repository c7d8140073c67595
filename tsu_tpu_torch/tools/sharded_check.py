"""Hold a sharded lattice's observables against a plain int64 reduction of
its final planes, at any size, outside any timed window.

    python -m tsu_tpu_torch.tools.sharded_check --shape 262144 262144 --rows 4 \\
        --seed 2147483901 [--n-burnin 20 --n-sweeps 10 --n-samples 3] [--device cpu]

runs the chain of ``IsingGrid(shape, periodic=True, seed=seed)
.sample_observables(n_samples, temperature, mesh=make_mesh(rows=rows),
initial="mesh")`` (the same generator draws, the same stream) through
``sharded_lattice_sample``, keeps the final shards where they lie, and
sums each shard's spins and bonds again with plain PyTorch in int64 (K11's
plain version), a block of rows at a time beside the shard on its device,
the black rows around a block from its neighbours. The last sample's
magnetization and energy must equal m = spin / N and E = -J bond, formed
in float64 from those sums, bit for bit.
Prints one JSON line: both pairs, whether they are equal, the seconds of
the run and of the check, each card's peak memory and the card's name.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from tsu_tpu_torch.ops.plane_observables import plane_sums_reference
from tsu_tpu_torch.parallel import make_mesh, sharded_lattice_sample
from tsu_tpu_torch.parallel.lattice import MeshStart
from tsu_tpu_torch.rng import as_generator

BLOCK_ROWS = 1024


def plain_sums(shards: dict, periodic: bool = True, block: int = BLOCK_ROWS) -> tuple:
    """(spin sum, bond sum), Python ints, of row shards {(i, 0): (red,
    black)}: K11's plain version (``plane_sums_reference``, int64) over each
    shard's rows a block at a time on its own device, the black rows around
    a block from its neighbours. ``block`` is even, so that a block's first
    row is a red row of even parity, as the neighbour sum takes it."""
    n = len(shards)
    totals = []
    for i in range(n):
        red, black = shards[i, 0]
        above, below = shards[(i - 1) % n, 0][1][-1], shards[(i + 1) % n, 0][1][0]
        if not periodic:
            above = torch.zeros_like(above) if i == 0 else above
            below = torch.zeros_like(below) if i == n - 1 else below
        R = red.shape[0]
        total = torch.zeros(2, dtype=torch.int64, device=red.device)
        for a in range(0, R, block):
            b = min(a + block, R)
            total += plane_sums_reference(red[a:b], black[a:b],
                                          black[a - 1] if a else above.to(red.device),
                                          black[b] if b < R else below.to(red.device),
                                          periodic=periodic)
        totals.append(total)
    spins, bonds = (sum(v) for v in zip(*(t.tolist() for t in totals)))
    return spins, bonds


def check(shape, rows: int, seed: int, *, n_burnin: int, n_sweeps: int, n_samples: int,
          temperature: float = 2.269, J: float = 1.0, devices=None) -> dict:
    """Run the chain and check its last sample; returns the JSON line's
    fields."""
    mesh = make_mesh(rows=rows, devices=devices)
    gen = as_generator(seed)
    start = MeshStart(tuple(shape), int(torch.randint(0, 2**31 - 1, (), generator=gen)))
    t = time.perf_counter()
    out = sharded_lattice_sample(mesh, gen, start, n_samples=n_samples, temperature=temperature,
                                 J=J, n_burnin=n_burnin, n_sweeps=n_sweeps)
    cards = sorted({d for d in mesh.devices.flat if d.type == "cuda"}, key=str)
    for d in cards:
        torch.cuda.synchronize(d)
    run_s = time.perf_counter() - t
    t = time.perf_counter()
    spins, bonds = plain_sums(out["shards"])
    check_s = time.perf_counter() - t
    n_sites = shape[0] * shape[1]
    want = (spins / n_sites, -J * float(bonds))
    got = (float(out["magnetization"][-1]), float(out["energy"][-1]))
    return {"shape": list(shape), "rows": rows, "seed": seed, "program": got, "float64": want,
            "equal": got == want, "spin_sum": spins, "bond_sum": bonds, "run_s": run_s,
            "check_s": check_s, "devices": [str(d) for d in mesh.devices.flat],
            "peak_bytes": {str(d): torch.cuda.max_memory_allocated(d) for d in cards}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", type=int, nargs=2, default=[262144, 262144])
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--n-burnin", type=int, default=20)
    ap.add_argument("--n-sweeps", type=int, default=10)
    ap.add_argument("--n-samples", type=int, default=3)
    ap.add_argument("--device", default=None, help="cpu: the plain versions on CPU shards")
    args = ap.parse_args(argv)
    devices = None if args.device is None else [args.device] * args.rows
    line = check(args.shape, args.rows, args.seed, n_burnin=args.n_burnin,
                 n_sweeps=args.n_sweeps, n_samples=args.n_samples, devices=devices)
    if torch.cuda.is_available() and args.device != "cpu":
        from tsu_tpu_torch.tools.timing import card

        line["card"] = card()
    print(json.dumps(line))
    return 0 if line["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
