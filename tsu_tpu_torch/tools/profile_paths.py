"""Profile the port's lattice and spin-glass paths on one NVIDIA GPU with
torch.profiler.

Run from the repository root on a machine with a card:

    python3 -m tsu_tpu_torch.tools.profile_paths [--out DIR]

Each path runs at the size ``chip_smoke.py`` drives it (phases 5, 9 and
13), once to warm up and once under the profiler. For each path it prints
the wall time, the device busy time and idle share, the count and device
time of the port's kernels, the host's kernel launches and their host time,
and the operations with the most device time. Busy time sums only the
events whose ``device_type`` is CUDA: ``key_averages()`` lists a kernel's
time a second time under the CPU operation that launched it. Then it times the host path of one batched
launch: wrapper calls on one 2x2 lattice, whose kernel the card finishes at
once, on the host clock. ``--out DIR`` writes the profiler's tables to
DIR/profile_paths.txt. The last line is one JSON object with every number
printed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from tsu_tpu_torch import IsingGrid, demonstrate_phase_transition
from tsu_tpu_torch.ops.checkerboard_fused import fused_sweeps_keyed, sigmoid_table16
from tsu_tpu_torch.rng import sweep_keys
from tsu_tpu_torch.samplers import (
    build_tempering_ladder,
    parallel_tempering_bonds,
    parallel_tempering_lattice,
    pt_ground_state_search,
)

GRID = (4096, 4096)        # the README quick start and the ground-state search
SCAN = (16, 1024)          # the phase scan: 16 temperatures x 1024^2
PT = (64, 256, 256)        # tempering: 64 rungs x 256^2
TOP = 8                    # device operations listed per path
KERNEL_NAMES = ("fused_sweep", "bond_halfsweep")


def _ladder_search(Jh, Jv, dev):
    """The spin_glass_ea row at reduced depth: a ladder over T 0.3-2.0,
    then 500 iterations of 2 copies with Houdayer moves."""
    gen = torch.Generator().manual_seed(1)
    temps, _ = build_tempering_ladder(gen, Jh, Jv, T_min=0.3, T_max=2.0, target_acceptance=0.3,
                                      accept_floor=0.2, feedback_iters=128, feedback_burnin=32,
                                      device=dev)
    return pt_ground_state_search(gen, Jh, Jv, temperatures=temps, n_iters=500, n_copies=2,
                                  houdayer_every=10, quench_sweeps=64, device=dev)


def paths(dev) -> dict:
    B, L = SCAN
    rng = np.random.default_rng(0)
    gauss = rng.normal(size=(2, *GRID)).astype(np.float32)
    pm1 = rng.choice([-1.0, 1.0], (2, *GRID)).astype(np.float32)
    pm1_pt = rng.choice([-1.0, 1.0], (2, *PT[1:])).astype(np.float32)
    return {
        "sample": lambda: IsingGrid(GRID, periodic=True, seed=0, device=dev).sample(
            n_samples=4, temperature=2.269),
        "phase scan": lambda: demonstrate_phase_transition(
            sizes=[L], temperatures=np.linspace(1.5, 3.5, B), n_samples=64, seed=0,
            device=dev),
        "ground state": lambda: IsingGrid(GRID, periodic=True, seed=0, device=dev)
        .find_ground_state(n_steps=1000),
        "tempering": lambda: parallel_tempering_lattice(
            0, PT[1:], temperatures=np.geomspace(1.8, 3.0, PT[0]), n_samples=200,
            swap_interval=10, n_burnin=100, device=dev),
        "spin-glass sample": lambda: IsingGrid(GRID, periodic=True, seed=0, device=dev,
                                               bonds=gauss).sample_observables(4, temperature=1.0),
        "spin-glass anneal": lambda: IsingGrid(GRID, periodic=True, seed=0, device=dev,
                                               bonds=pm1).find_ground_state(n_steps=3000),
        "bond tempering": lambda: parallel_tempering_bonds(
            0, *pm1_pt, temperatures=np.geomspace(1.2, 2.0, PT[0]), n_samples=200,
            swap_interval=10, n_burnin=100, device=dev),
        "ladder + search": lambda: _ladder_search(*pm1_pt, dev),
    }


def profile_path(fn, tables: list) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    launch = [e for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel")]
    tables.append(events.table(sort_by="self_device_time_total", row_limit=40))
    return {
        "wall_ms": wall_ms,
        "busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "kernels": {e.key: {"count": e.count, "ms": e.self_device_time_total / 1e3}
                    for e in device if any(k in e.key for k in KERNEL_NAMES)},
        "host_launches": sum(e.count for e in launch),
        "host_launch_ms": sum(e.cpu_time_total for e in launch) / 1e3,
        "top_device_ops": [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                           for e in device[:TOP]],
    }


def host_launch_us(dev, n: int = 2000) -> float:
    """Host time of one batched-sweep wrapper call at a size the card
    finishes at once."""
    planes = torch.ones((1, 2, 1), dtype=torch.bfloat16, device=dev)
    tables = sigmoid_table16(1.0, 0.0, torch.tensor([2.0])).to(dev)
    keys = sweep_keys([1], np.arange(n)[:, None]).to(dev)
    fused_sweeps_keyed(planes, planes, tables, keys[:10])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused_sweeps_keyed(planes, planes, tables, keys)
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the profiler's full tables")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_paths: torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0].strip()
    print(card, flush=True)

    result, tables = {"card": card, "paths": {}}, []
    for name, fn in paths(dev).items():
        r = result["paths"][name] = profile_path(fn, tables)
        kern = ", ".join(f"{k} {v['count']} x {v['ms'] / v['count'] * 1e3:.1f} us"
                         for k, v in r["kernels"].items())
        print(f"{name}: wall {r['wall_ms']:.1f} ms, device busy {r['busy_ms']:.1f} ms "
              f"(idle {r['idle_share']:.1%}); {kern}; {r['host_launches']} host launches, "
              f"{r['host_launch_ms']:.1f} ms in them", flush=True)
        for key, count, ms in r["top_device_ops"]:
            print(f"    {ms:9.3f} ms  {count:6d}  {key}")
    result["host_launch_us"] = host_launch_us(dev)
    print(f"host path of one batched launch: {result['host_launch_us']:.2f} us")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_paths.txt"), "w") as f:
            for name, table in zip(result["paths"], tables):
                f.write(f"== {name}\n{table}\n")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
