"""Run the sharded entry points on every rank of a process group and save
what each rank returns, to hold it against the one-process run at the same
seed (``tests/test_torch_multihost.py`` on the CPU, ``chip_smoke.py`` phase
41 on the card).

Under torchrun, one process per rank:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m tsu_tpu_torch.tools.multiprocess_check OUT_DIR CASES.json [--device cpu]

or one process per rank started by hand, with a file rendezvous:

    python -m tsu_tpu_torch.tools.multiprocess_check OUT_DIR CASES.json \\
        --device cpu --init-method file:///tmp/rdzv --rank R --world-size N

``CASES.json`` is a list of cases, each a dict with a ``name``, a ``kind``
and its settings (:func:`run_case`); inputs are made with numpy from each
case's ``seed``. Rank r writes ``OUT_DIR/rank<r>.pt``: per case its output,
its host seconds (synchronised), the launches of K1, K2 and K3 it made and
its exchanges (calls, messages and bytes sent, and the calls of each
(messages, bytes) size). :func:`run_case` also runs
a case in one process (no runtime), which is the reference.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import time

import numpy as np
import torch

from tsu_tpu_torch.parallel import distributed

class Stopped(Exception):
    """A run stopped on purpose right after its first snapshot."""


def kernel_counts() -> dict:
    from tsu_tpu_torch.ops.checkerboard_fused import fused_sweep, fused_sweep_batched
    from tsu_tpu_torch.ops.checkerboard_kernel import halfsweep

    return {"K1": fused_sweep.launches, "K2": fused_sweep_batched.launches,
            "K3": halfsweep.launches}


def exchange_counts(sizes: collections.Counter) -> dict:
    """Calls, messages and bytes sent of exchanges counted by size."""
    return {"calls": sum(sizes.values()), "messages": sum(m * n for (m, _), n in sizes.items()),
            "bytes": sum(b * n for (_, b), n in sizes.items()), "sizes": sizes}


def mesh_of(spec: dict, device):
    """The case's mesh: across processes over the ranks (``ranks`` places
    several entries on one rank; default one entry per rank), in one process
    every entry on ``device``."""
    from tsu_tpu_torch.parallel import make_mesh

    axes = {k: spec.get(k, 1) for k in ("replica", "chains", "rows", "cols")}
    if distributed.initialized():
        return make_mesh(**axes, ranks=spec.get("ranks"))
    return make_mesh(**axes, devices=[device] * int(np.prod(list(axes.values()))))


def lattice(seed: int, shape) -> torch.Tensor:
    """A random ±1 float32 lattice made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.where(rng.random(shape) < 0.5, 1.0, -1.0).astype(np.float32))


@contextlib.contextmanager
def stopped_after_first_snapshot():
    """Within the block a sharded sample stops, on every rank alike, right
    after its first snapshot is written and every rank has met."""
    from tsu_tpu_torch.parallel import lattice as lat

    real = lat._snapshot

    def stopping(*args, **kwargs):
        real(*args, **kwargs)
        raise Stopped

    lat._snapshot = stopping
    try:
        yield
    finally:
        lat._snapshot = real


def _sweeps(case, device):
    from tsu_tpu_torch.ops.checkerboard import split_checkerboard
    from tsu_tpu_torch.parallel import sharded_checkerboard_sweeps

    R, C = case["shape"]
    dtype = getattr(torch, case.get("dtype", "float32"))
    red, black = (x.to(device, dtype).contiguous()
                  for x in split_checkerboard(lattice(case["seed"], (R, C))))
    uniforms = None
    if case.get("uniform_bits"):
        rng = np.random.default_rng(case["seed"] + 1)
        uniforms = torch.from_numpy(rng.integers(
            0, 1 << case["uniform_bits"], (case["n_sweeps"], 2, R, C // 2), dtype=np.int32))
    return sharded_checkerboard_sweeps(
        mesh_of(case["mesh"], device), case["seed"], red, black, case.get("temperature", 2.269),
        case["n_sweeps"], J=case.get("J", 1.0), field=case.get("field", 0.0),
        periodic=case.get("periodic", True),
        col_axis="col" if case["mesh"].get("cols", 1) > 1 else None, uniforms=uniforms,
        fused=case.get("fused"))


def _sample(case, device):
    from tsu_tpu_torch.parallel import sharded_lattice_sample

    ck = case.get("checkpoint", {})
    run = lambda: sharded_lattice_sample(   # noqa: E731
        mesh_of(case["mesh"], device), case["seed"], lattice(case["seed"], case["shape"]),
        n_samples=case["n_samples"], temperature=case.get("temperature", 2.269),
        n_burnin=case["n_burnin"], n_sweeps=case["n_sweeps"],
        periodic=case.get("periodic", True),
        col_axis="col" if case["mesh"].get("cols", 1) > 1 else None, fused=case.get("fused"),
        checkpoint_path=ck.get("path"), checkpoint_every=ck.get("every", 0),
        resume=ck.get("resume", False), final_planes=True)
    if not ck.get("stop_after_first"):
        out = run()
        out.pop("shards")
        return out
    with stopped_after_first_snapshot():
        try:
            run()
        except Stopped:
            return "stopped"
    raise RuntimeError(f"{case['name']}: the run took no snapshot")


def _grid(case, device):
    from tsu_tpu_torch import IsingConfig, IsingGrid

    grid = IsingGrid(tuple(case["shape"]), periodic=True, seed=case["seed"], device=device,
                     config=IsingConfig(n_burnin=case["n_burnin"], n_sweeps=case["n_sweeps"]))
    return grid.sample_observables(case["n_samples"], temperature=case.get("temperature", 2.269),
                                   mesh=mesh_of(case["mesh"], device))


def _tempering(case, device):
    from tsu_tpu_torch.parallel import parallel_tempering_replica_sharded

    lo, hi, n = case["temperatures"]
    return parallel_tempering_replica_sharded(
        mesh_of(case["mesh"], device), case["seed"], tuple(case["shape"]),
        np.geomspace(lo, hi, n), n_samples=case["n_samples"],
        swap_interval=case["swap_interval"], n_burnin=case["n_burnin"])


def _smc(case, device):
    from tsu_tpu_torch.energy import Quadratic
    from tsu_tpu_torch.parallel import annealed_smc_sharded

    P, dim = case["particles"]
    parts = 3.0 * np.random.default_rng(case["seed"]).standard_normal((P, dim))
    run = lambda: annealed_smc_sharded(   # noqa: E731
        mesh_of(case["mesh"], device), case["seed"], parts.astype(np.float32),
        energy_fn=Quadratic(0.0, 1.0), n_steps=case.get("n_steps", 50))
    if not (case.get("count_host_launches") and torch.device(device).type == "cuda"
            and distributed.rank() == 0):
        return run()
    from tsu_tpu_torch.tools.timing import host_launches

    box = {}
    n = host_launches(lambda: box.update(out=run()))
    return {**box["out"], "host_launches": n}


def _info(case, device):
    from tsu_tpu_torch.benchmarks import BenchmarkRunner
    from tsu_tpu_torch.parallel import make_mesh, mesh_info, multihost_initialize

    try:
        multihost_initialize(device=device)
        twice = "no error"
    except RuntimeError as e:
        twice = f"RuntimeError: {e}"
    return {"mesh_info": mesh_info(make_mesh(rows=distributed.world_size())),
            "topology": BenchmarkRunner(device=device)._topology(), "twice": twice}


def _pod_scaling(case, device):
    from tsu_tpu_torch.tools import pod_scaling

    return pod_scaling.run(case.get("out_dir"), case["rows_per_device"], case["cols"],
                           chains_per_device=case["chains_per_device"],
                           n_sweeps=case.get("n_sweeps"))


KINDS = {"sweeps": _sweeps, "sample": _sample, "grid": _grid, "tempering": _tempering,
         "smc": _smc, "info": _info, "pod_scaling": _pod_scaling}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_case(case: dict, device) -> dict:
    """One case on this process: {"out", "seconds", "launches", "exchange"};
    in one process (no runtime) the reference run."""
    k0, x0 = kernel_counts(), collections.Counter(distributed.exchange.sizes)
    _sync(device)
    t0 = time.perf_counter()
    out = KINDS[case["kind"]](case, device)
    _sync(device)
    seconds = time.perf_counter() - t0
    k1 = kernel_counts()
    return {"out": out, "seconds": seconds, "launches": {k: k1[k] - k0[k] for k in k1},
            "exchange": exchange_counts(distributed.exchange.sizes - x0)}


def main(argv=None):
    parser = argparse.ArgumentParser(description="the sharded entry points on every rank")
    parser.add_argument("out_dir")
    parser.add_argument("cases", help="a JSON file: a list of cases")
    parser.add_argument("--device", default=None, help="default: this rank's card")
    parser.add_argument("--init-method", default=None, help="default: torchrun's environment")
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--world-size", type=int, default=None)
    args = parser.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)
    rt = distributed.initialize(init_method=args.init_method, rank=args.rank,
                                world_size=args.world_size, device=args.device)
    with open(args.cases) as f:
        cases = json.load(f)
    results = {"backend": rt.backend, "world_size": rt.world_size, "device": str(rt.device)}
    for case in cases:
        results[case["name"]] = run_case(case, rt.device)
    distributed.barrier()
    os.makedirs(args.out_dir, exist_ok=True)
    torch.save(results, os.path.join(args.out_dir, f"rank{rt.rank}.pt"))
    distributed.shutdown()


if __name__ == "__main__":
    main()
