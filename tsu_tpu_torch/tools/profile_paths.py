"""Profile the port's lattice and spin-glass paths on one NVIDIA GPU with
torch.profiler.

Run from the repository root on a machine with a card:

    python3 -m tsu_tpu_torch.tools.profile_paths [--out DIR] [--only NAME ...]

Each path runs at the size ``chip_smoke.py`` drives it (phases 5, 9, 13, 17,
22, 26, 27, 31 and 34), once to warm up and once under the profiler; the
dense sample reuses its model, and the continuous samplers and the BNN fits
their cached step loops, so the profiled call replays the CUDA graphs
captured by the warm-up. For each path it prints
the wall time, the device busy time and idle share, the count and device
time of the port's kernels, the host's launch calls (kernels, and CUDA
graphs, one call each) and their host time,
and the operations with the most device time. Busy time sums only the
events whose ``device_type`` is CUDA: ``key_averages()`` lists a kernel's
time a second time under the CPU operation that launched it. Then it times
the host path of one launch on the host clock, at a 2x2 lattice whose kernel
the card finishes at once: a batched sweep (``fused_sweeps_keyed``), one
``fused_sweep`` wrapper call, and one sweep of ``fused_sweeps``, which sets up
its launches once per call. ``--out DIR`` writes the profiler's tables to
DIR/profile_paths.txt; ``--only`` profiles the paths named (for instance
``"sharded sample 2 x 2"``) and nothing else. With the continuous quick
start it also times that path without the profiler, replayed from its
graphs and eager. The last line is one JSON object with every number
printed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from tsu_tpu_torch import (
    AnchoredEnsembleRegressor,
    BayesianRegressor,
    BNNPosterior,
    Quadratic,
    IsingConfig,
    IsingGrid,
    IsingModel,
    ThermalSamplingUnit,
    TSUConfig,
    demonstrate_phase_transition,
    sample_mala,
)
from tsu_tpu_torch.ops.checkerboard import split_checkerboard
from tsu_tpu_torch.ops.checkerboard_bonds_kernel import checkerboard_sweeps_bonds_kernel
from tsu_tpu_torch.ops.sparse_ising import maxcut_sparse
from tsu_tpu_torch.ops.checkerboard_fused import (
    fused_sweep,
    fused_sweeps,
    fused_sweeps_keyed,
    sigmoid_table16,
)
from tsu_tpu_torch.parallel import make_mesh, parallel_tempering_replica_sharded
from tsu_tpu_torch.rng import sweep_keys
from tsu_tpu_torch.samplers.langevin import run_langevin
from tsu_tpu_torch.samplers.loop import Draws
from tsu_tpu_torch.tools.bench import ea_codes
from tsu_tpu_torch.tools.timing import LAUNCH_CALLS, card
from tsu_tpu_torch.samplers import (
    build_tempering_ladder,
    parallel_tempering_bonds,
    parallel_tempering_lattice,
    pt_ground_state_search,
)

GRID = (4096, 4096)        # the README quick start and the ground-state search
SCAN = (16, 1024)          # the phase scan: 16 temperatures x 1024^2
PT = (64, 256, 256)        # tempering: 64 rungs x 256^2
DENSE = (4096, 8, 64)      # the dense sample: 4,096-spin SK, 8 chains, 64 samples
SPARSE = (100_000, 500_000, 2000)   # maxcut_sparse at the suite's size: nodes, edges, steps
QUICK = (16, 10_000)       # README.md's continuous quick start: chains, samples
# The full-Bayes row of tsu_tpu/benchmarks/ml.py:163-178: a (1, 32, 32, 1)
# BNN posterior over 100 points, MALA with 16 chains, step 1e-3, 3,000
# burn-in and 32 draws a chain.
FULL_BAYES = {"sizes": (1, 32, 32, 1), "n_train": 100, "chains": 16, "step": 1e-3,
              "burnin": 3000, "draws": 32}
TOP = 8                    # device operations listed per path
KERNEL_NAMES = ("fused_sweep", "bond_halfsweep", "halfsweep_kernel")


def _ladder_search(Jh, Jv, dev):
    """The spin_glass_ea row at reduced depth: a ladder over T 0.3-2.0,
    then 500 iterations of 2 copies with Houdayer moves."""
    gen = torch.Generator().manual_seed(1)
    temps, _ = build_tempering_ladder(gen, Jh, Jv, T_min=0.3, T_max=2.0, target_acceptance=0.3,
                                      accept_floor=0.2, feedback_iters=128, feedback_burnin=32,
                                      device=dev)
    return pt_ground_state_search(gen, Jh, Jv, temperatures=temps, n_iters=500, n_copies=2,
                                  houdayer_every=10, quench_sweeps=64, device=dev)


def sk_couplings(n: int, seed: int = 0) -> np.ndarray:
    """A Sherrington-Kirkpatrick instance: J_ij = ±1/sqrt(n) from ``seed``,
    symmetric, zero diagonal (every pair couples, so n colours)."""
    rng = np.random.default_rng(seed)
    A = np.triu(rng.choice([-1.0, 1.0], (n, n)), 1) / np.sqrt(n)
    return (A + A.T).astype(np.float32)


def suite_graph(n_nodes: int, n_edges: int, seed: int = 3):
    """The edges of the optimization suite's sparse MAX-CUT row, drawn as it
    draws them: uniform endpoints, self-loops dropped, unit weights."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n_nodes, (n_edges, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    return edges, np.ones(len(edges))


def full_bayes_posterior(seed: int = 0) -> BNNPosterior:
    """The full-Bayes row's posterior: x ~ U(-1, 1), y = sin(3x) + 0.1 N(0, 1)
    from ``np.random.default_rng(seed)``, as the row draws them, and a
    (1, 32, 32, 1) MLP (1,153 parameters) at prior 1 and noise 0.1."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (FULL_BAYES["n_train"], 1)).astype(np.float32)
    y = (np.sin(3 * x) + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
    return BNNPosterior(x, y, FULL_BAYES["sizes"])


def bnn_start(post: BNNPosterior, chains: int, seed: int = 0) -> torch.Tensor:
    """(chains, dim) starts theta ~ 0.1 N(0, 1) from ``seed``."""
    return 0.1 * torch.randn((chains, post.dim), generator=torch.Generator().manual_seed(seed))


def ml_rows_data(seed: int = 0):
    """The ML suite's sinusoid split (100 points, ``default_rng(seed)``) and
    its extrapolation split (80 points of x^3 + 0.05 N from ``seed + 2``),
    as ``tsu_tpu_torch/benchmarks/ml.py`` draws them."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (100, 1)).astype(np.float32)
    y = (np.sin(3 * x) + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
    rng = np.random.default_rng(seed + 2)
    xe = rng.uniform(-1, 1, (80, 1)).astype(np.float32)
    ye = (xe**3 + 0.05 * rng.normal(size=xe.shape)).astype(np.float32)
    return (x, y), (xe, ye)


def _dense_model(dev) -> IsingModel:
    n, chains, _ = DENSE
    model = IsingModel(n, config=IsingConfig(n_chains=chains), seed=0, device=dev)
    model.J = sk_couplings(n)
    return model


def paths(dev) -> dict:
    B, L = SCAN
    rng = np.random.default_rng(0)
    gauss = rng.normal(size=(2, *GRID)).astype(np.float32)
    pm1 = rng.choice([-1.0, 1.0], (2, *GRID)).astype(np.float32)
    pm1_pt = rng.choice([-1.0, 1.0], (2, *PT[1:])).astype(np.float32)
    red, black = (x.to(dev) for x in split_checkerboard(torch.ones(GRID, dtype=torch.bfloat16)))
    codes = ea_codes(GRID[0], dev)
    dense = _dense_model(dev)
    edges, weights = suite_graph(*SPARSE[:2])
    post = full_bayes_posterior()
    (x, y), (xe, ye) = ml_rows_data()
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
        # One call of each row of tools.bench (chip_smoke phase 17). The
        # resident kernel's cooperative launch is left out: in a profiler
        # window that held one, key_averages() listed no device event at all.
        # The sharded paths, four shards on one card (phase 22).
        "sharded sample 4 x 1": lambda: IsingGrid(GRID, periodic=True, seed=0, device=dev)
        .sample_observables(4, temperature=2.269, mesh=make_mesh(rows=4, devices=[dev] * 4)),
        "sharded sample 2 x 2": lambda: IsingGrid(GRID, periodic=True, seed=0, device=dev)
        .sample_observables(4, temperature=2.269,
                            mesh=make_mesh(rows=2, cols=2, devices=[dev] * 4)),
        "replica-sharded tempering": lambda: parallel_tempering_replica_sharded(
            make_mesh(replica=4, devices=[dev] * 4), 0, PT[1:], np.geomspace(1.8, 3.0, PT[0]),
            n_samples=200, swap_interval=10, n_burnin=100),
        "bench K1 call": lambda: fused_sweeps(1, red, black, 2.269, 5000),
        "bench EA call": lambda: checkerboard_sweeps_bonds_kernel(
            1, red, black, codes, 1.2, 1000, discrete=True, pure=True),
        # Slice 4 (phases 26 and 27): the dense sample on graphed colour
        # sweeps, and the sparse MAX-CUT anneal at the suite's size.
        "dense sample 4096": lambda: dense.sample(DENSE[2]),
        "maxcut sparse 100k": lambda: maxcut_sparse(0, SPARSE[0], edges, weights,
                                                    n_steps=SPARSE[2], device=dev),
        # Slice 5 (phase 31): the README's continuous quick start (62,600
        # BAOAB steps of 16 chains) and MALA on the full-Bayes row's
        # 1,153-parameter BNN posterior (16 chains, 3,000 burn-in, 32 draws).
        "continuous quick start": lambda: ThermalSamplingUnit(
            TSUConfig(n_chains=QUICK[0]), seed=0, device=dev).sample_gaussian(0.0, 1.0, QUICK[1]),
        "mala bnn 1153": lambda: sample_mala(
            0, bnn_start(post, FULL_BAYES["chains"]), energy_fn=post, n_samples=FULL_BAYES["draws"],
            step_size=FULL_BAYES["step"], n_burnin=FULL_BAYES["burnin"], device=dev),
        # Slice 6 (phase 34): the ML suite's sinusoid fit (800 full-batch
        # ELBO steps of a (1, 32, 32, 1) BNN, n_mc 3) and its extrapolation
        # row's anchored ensemble (8 members, 2,000 steps).
        "bnn fit sinusoid 800": lambda: BayesianRegressor(1, [32, 32], seed=0, device=dev).fit(
            x, y, n_epochs=800, batch_size=100, learning_rate=0.01, kl_weight=0.1),
        "anchored ensemble 2000": lambda: AnchoredEnsembleRegressor(
            1, [32, 32], n_members=8, seed=0, device=dev).fit(xe, ye, n_epochs=2000,
                                                             learning_rate=0.01),
    }


def profile_path(fn, tables: list) -> dict:
    """One warm-up call of ``fn``, then :func:`profile_once`."""
    fn()
    torch.cuda.synchronize()
    return profile_once(fn, tables)


def profile_once(fn, tables: list) -> dict:
    """One call of ``fn`` under the profiler: wall, device busy and idle,
    the port's kernels, host launch calls and the top device operations;
    the profiler's table is appended to ``tables``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    launch = [e for e in events if e.key in LAUNCH_CALLS]
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


def quick_start_walls(dev) -> dict:
    """Host-clock seconds of the README's continuous quick start replayed
    from its cached graphs, and of the same Langevin run eager (the unit's
    call of ``run_langevin`` with ``graph=False``: 16 chains, 100 burn-in
    steps, 625 samples 100 steps apart, curvature 1 at the start)."""
    chains, n = QUICK
    out = {}
    for route in ("graph", "eager"):
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if route == "graph":
            ThermalSamplingUnit(TSUConfig(n_chains=chains), seed=0, device=dev).sample_gaussian(
                0.0, 1.0, n)
        else:
            run_langevin(Draws(gen), 0.1 * torch.randn((chains, 1), generator=gen, device=dev),
                         energy_fn=Quadratic(0.0, 1.0), n_samples=-(-n // chains), dt=0.01,
                         n_burnin=100, n_steps=100, graph=False)
        torch.cuda.synchronize()
        out[route] = time.perf_counter() - t0
    return out


def _host_us(run, n: int) -> float:
    """Host-clock us per unit of ``run(n)``, after a warm-up of 10."""
    run(10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(n)
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def host_launch_us(dev, n: int = 2000) -> dict:
    """Host time of one launch at a size the card finishes at once: a
    batched sweep, a ``fused_sweep`` wrapper call, and a sweep of
    ``fused_sweeps`` (the headline's loop)."""
    planes = torch.ones((1, 2, 1), dtype=torch.bfloat16, device=dev)
    tables = sigmoid_table16(1.0, 0.0, torch.tensor([2.0])).to(dev)
    keys = sweep_keys([1], np.arange(n)[:, None]).to(dev)
    table = tables[0].contiguous()

    def wrapper(m):
        for k in range(m):
            fused_sweep(planes[0], table, seed=1, sweep=k)
    return {"batched": _host_us(lambda m: fused_sweeps_keyed(planes, planes, tables, keys[:m]), n),
            "fused_sweep": _host_us(wrapper, n),
            "fused_sweeps": _host_us(lambda m: fused_sweeps(1, planes[0], planes[0], 2.0, m), n)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the profiler's full tables")
    ap.add_argument("--only", nargs="*", help="the paths to profile (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_paths: torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    card_name = card()
    print(card_name, flush=True)

    result, tables = {"card": card_name, "paths": {}}, []
    for name, fn in paths(dev).items():
        if args.only and name not in args.only:
            continue
        r = result["paths"][name] = profile_path(fn, tables)
        kern = ", ".join(f"{k} {v['count']} x {v['ms'] / v['count'] * 1e3:.1f} us"
                         for k, v in r["kernels"].items())
        print(f"{name}: wall {r['wall_ms']:.1f} ms, device busy {r['busy_ms']:.1f} ms "
              f"(idle {r['idle_share']:.1%}); {kern}; {r['host_launches']} host launches, "
              f"{r['host_launch_ms']:.1f} ms in them", flush=True)
        for key, count, ms in r["top_device_ops"]:
            print(f"    {ms:9.3f} ms  {count:6d}  {key}")
    if "continuous quick start" in result["paths"]:
        w = result["quick_start_walls_s"] = quick_start_walls(dev)
        print(f"continuous quick start without the profiler: graphed {w['graph']:.3f} s, eager "
              f"{w['eager']:.3f} s", flush=True)
    result["host_launch_us"] = host_launch_us(dev)
    h = result["host_launch_us"]
    print(f"host path of one launch: batched {h['batched']:.2f} us, fused_sweep "
          f"{h['fused_sweep']:.2f} us, a sweep of fused_sweeps {h['fused_sweeps']:.2f} us")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_paths.txt"), "w") as f:
            for name, table in zip(result["paths"], tables):
                f.write(f"== {name}\n{table}\n")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
