"""Scaling-efficiency measurements across device meshes.

Counterpart of ``tsu_tpu/benchmarks/scaling.py``. Each workload runs on (a)
the first device and (b) every device of the mesh (``devices``, default
every visible card), with efficiency = throughput_all / (throughput_one x
n_devices):

  * chains: independent Langevin chains, one shard per device;
  * bnn_dp: BNN ELBO training, the batch split over the devices and the
    gradients averaged on the first (``models/ml.py:train_step``);
  * lattice: one lattice row-sharded with halo exchange, K1 in shard mode
    on the card;
  * lattice_matched: the sharded path on a one-device mesh at the
    headline's size and depth.

A mesh may repeat a device (``[cuda:0] * 4``): its shards then share one
card, which checks the mechanics but measures no scaling, so efficiency is
null there, as on the reference's virtual mesh of one host.

After ``parallel.multihost_initialize`` the chains and lattice rows run
over the global mesh, one shard per rank, each row timed between barriers
(every rank calls them; ``tools/pod_scaling.py`` runs them under
``torchrun``). Ranks that share a card (one host, one device) count as a
repeated device: no efficiency is claimed on one card.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.energy import Quadratic
from tsu_tpu_torch.parallel import distributed
from tsu_tpu_torch.parallel.mesh import make_mesh
from tsu_tpu_torch.samplers.langevin import sample_langevin


def _devices(devices: Optional[Sequence]) -> list:
    if devices is None:
        resolve_device(None)
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [resolve_device(d) for d in devices]


def _sync(devs):
    for d in set(devs):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _shared_host(devs) -> bool:
    """True when the mesh repeats a device: its shards share one card (or
    the CPU), so n_devices x one device is no ideal. Across processes
    ``devs`` are the ranks' (host, device) placements."""
    return len(set(devs)) < len(devs)


def _timed_over_ranks(n_active: int, run) -> float:
    """Seconds of ``run(i)`` (a warm-up i = 0, then the timed i = 1) on the
    first ``n_active`` ranks, the others waiting; every rank meets before
    and after each call."""
    active = distributed.rank() < n_active
    distributed.barrier()
    if active:
        run(0)
    distributed.barrier()
    t0 = time.perf_counter()
    if active:
        run(1)
    distributed.barrier()
    return time.perf_counter() - t0


def _efficiency(single_tput: float, all_tput: float, devs) -> dict:
    """Weak-scaling efficiency with the ideal stated per topology."""
    n_dev = len(devs)
    if n_dev <= 1:
        return {"efficiency": 1.0, "ideal": "single_device"}
    ratios = {
        "aggregate_vs_single_device": all_tput / single_tput,
        "aggregate_vs_ndev_x_single": all_tput / (single_tput * n_dev),
    }
    if _shared_host(devs):
        return {
            "efficiency": None,
            "ideal": "not measurable on a mesh that repeats a device (its shards share "
                     "one card); see ratios",
            **ratios,
        }
    return {
        "efficiency": ratios["aggregate_vs_ndev_x_single"],
        "ideal": "n_devices x single_device, constant per-device work "
                 "(weak scaling, distinct cards)",
        **ratios,
    }


def measure_chains_scaling(dim: int = 10, chains_per_device: int = 1024, n_samples: int = 50,
                           n_steps: int = 10, seed: int = 0, devices=None) -> dict:
    """Langevin samples/s: 1 device vs all devices, a shard of chains per
    device (each its own seed). After ``multihost_initialize`` (and
    ``devices`` None): one shard per rank on its device, 1 rank vs all."""
    rt = distributed.runtime()
    if rt is not None and devices is None:
        results = {}
        for label, n in (("1_device", 1), ("all_devices", rt.world_size)):
            def run(i):
                sample_langevin(seed + i * n + rt.rank, np.zeros((chains_per_device, dim)),
                                energy_fn=Quadratic(0.0, 1.0), n_samples=n_samples, dt=0.05,
                                n_burnin=50, n_steps=n_steps, device=rt.device)
                _sync([rt.device])
            dt = _timed_over_ranks(n, run)
            results[label] = {"n_devices": n, "samples_per_s":
                              chains_per_device * n * n_samples / dt, "time_s": dt}
        results.update(_efficiency(results["1_device"]["samples_per_s"],
                                   results["all_devices"]["samples_per_s"], rt.placements))
        return results
    devices = _devices(devices)
    results = {}
    for label, devs in (("1_device", devices[:1]), ("all_devices", devices)):
        n_chains = chains_per_device * len(devs)

        def run(i):
            out = [sample_langevin(seed + i * len(devs) + k, np.zeros((chains_per_device, dim)),
                                   energy_fn=Quadratic(0.0, 1.0), n_samples=n_samples, dt=0.05,
                                   n_burnin=50, n_steps=n_steps, device=d)
                   for k, d in enumerate(devs)]
            _sync(devs)
            return out

        run(0)
        t0 = time.perf_counter()
        run(1)
        dt = time.perf_counter() - t0
        results[label] = {"n_devices": len(devs), "samples_per_s": n_chains * n_samples / dt,
                          "time_s": dt}
    results.update(_efficiency(results["1_device"]["samples_per_s"],
                               results["all_devices"]["samples_per_s"], devices))
    return results


def bnn_dp_row(devs, n_points: int, dim: int = 8, hidden: int = 64, n_epochs: int = 20,
               seed: int = 0) -> dict:
    """One data-parallel row: ``n_points`` synthetic regression points
    (x ~ N(0, 1)^dim, y = sin(sum x), from ``seed``) and a (dim, hidden, 1)
    BNN, ``n_epochs`` full-batch ELBO steps (n_mc 2, kl_weight 1e-3, Adam
    1e-2) with the batch split over ``devs``, run twice (a warm-up, then
    timed). The steps run eagerly, one call each, as the reference
    dispatches one jitted step a call. The draws come from one device
    generator seeded by ``seed``, so any split of the same points sees the
    same draws."""
    from tsu_tpu_torch.models.ml import _adam, _flat, init_layer, n_weights, train_step
    from tsu_tpu_torch.samplers.loop import scalar

    devs = [resolve_device(d) for d in devs]
    home = devs[0]
    rng = np.random.default_rng(seed)
    x_np = rng.normal(size=(n_points, dim)).astype(np.float32)
    y_np = np.sin(x_np.sum(axis=1, keepdims=True)).astype(np.float32)
    x, y = torch.from_numpy(x_np).to(home), torch.from_numpy(y_np).to(home)
    gen = torch.Generator().manual_seed(seed)
    ts = [t.to(home) for t in _flat([init_layer(gen, dim, hidden), init_layer(gen, hidden, 1)])]
    opt, _ = _adam(ts, scalar(1e-2, home), home)
    dgen = torch.Generator(device=home).manual_seed(seed)
    P = n_weights((dim, hidden, 1))
    kw = dict(n_layers=2, learn_noise=False, activation="relu", kl_weight=1e-3, temperature=1.0,
              prior_std=1.0, devices=list(devs))

    def run():
        loss = None
        for _ in range(n_epochs):
            loss, _ = train_step(ts, opt, torch.randn((2, P), generator=dgen, device=home),
                                 x, y, **kw)
        _sync(devs)
        return loss

    run()
    t0 = time.perf_counter()
    loss = run()
    dt = time.perf_counter() - t0
    return {"n_devices": len(devs), "points_per_s": n_points * n_epochs / dt,
            "loss_final": float(loss), "n_points": n_points, "time_s": dt}


def measure_bnn_dp_scaling(points_per_device: int = 16384, dim: int = 8, hidden: int = 64,
                           n_epochs: int = 20, seed: int = 0, devices=None) -> dict:
    """BNN ELBO training points/s with the batch data-parallel over the
    devices (weak scaling: points_per_device x n_devices points)."""
    devices = _devices(devices)
    results = {}
    for label, devs in (("1_device", devices[:1]), ("all_devices", devices)):
        results[label] = bnn_dp_row(devs, points_per_device * len(devs), dim, hidden, n_epochs,
                                    seed)
    results.update(_efficiency(results["1_device"]["points_per_s"],
                               results["all_devices"]["points_per_s"], devices))
    return results


def measure_lattice_scaling(rows_per_device: int = 1024, cols: int = 4096,
                            n_sweeps: Optional[int] = None, seed: int = 0,
                            devices=None) -> dict:
    """Row-sharded lattice sweeps/s: 1 device vs all (halo-exchange bound):
    bf16 planes from all-ones at T = 2.269, the fused sweep in shard mode
    (K1 on the card), 1,000 sweeps a call on the card (200 on the CPU).
    After ``multihost_initialize`` (and ``devices`` None): rank 0 alone vs
    the global mesh, one row shard per rank."""
    from tsu_tpu_torch.ops.checkerboard import split_checkerboard
    from tsu_tpu_torch.parallel.lattice import sharded_checkerboard_sweeps

    rt = distributed.runtime()
    if rt is not None and devices is None:
        on_card = rt.device.type == "cuda"
        if n_sweeps is None:
            n_sweeps = 1000 if on_card else 200
        results = {"kernel": "fused" if on_card else "plain", "n_sweeps": n_sweeps}
        for label, n in (("1_device", 1), ("all_devices", rt.world_size)):
            mesh = make_mesh(rows=n, ranks=range(n))
            R = rows_per_device * n
            red, black = split_checkerboard(torch.ones((R, cols), dtype=torch.bfloat16,
                                                       device=rt.device))

            def run(i):
                sharded_checkerboard_sweeps(mesh, seed + i, red, black, 2.269, n_sweeps,
                                            periodic=True)
                _sync([rt.device])
            dt = _timed_over_ranks(n, run)
            results[label] = {"n_devices": n, "flips_per_s": R * cols * n_sweeps / dt,
                              "time_s": dt}
        results.update(_efficiency(results["1_device"]["flips_per_s"],
                                   results["all_devices"]["flips_per_s"], rt.placements))
        return results
    devices = _devices(devices)
    on_card = devices[0].type == "cuda"
    if n_sweeps is None:
        n_sweeps = 1000 if on_card else 200
    results = {"kernel": "fused" if on_card else "plain"}
    for label, devs in (("1_device", devices[:1]), ("all_devices", devices)):
        mesh = make_mesh(rows=len(devs), devices=devs)
        R = rows_per_device * len(devs)
        red, black = split_checkerboard(torch.ones((R, cols), dtype=torch.bfloat16,
                                                   device=devs[0]))

        def run(i, red, black):
            out = sharded_checkerboard_sweeps(mesh, seed + i, red, black, 2.269, n_sweeps,
                                              periodic=True)
            _sync(devs)
            return out

        red, black = run(0, red, black)
        t0 = time.perf_counter()
        red, black = run(1, red, black)
        dt = time.perf_counter() - t0
        results[label] = {"n_devices": len(devs), "flips_per_s": R * cols * n_sweeps / dt,
                          "time_s": dt}
    results.update(_efficiency(results["1_device"]["flips_per_s"],
                               results["all_devices"]["flips_per_s"], devices))
    return results


def measure_lattice_matched(size: int = 4096, n_sweeps: int = 2500, n_iters: int = 3,
                            seed: int = 0, device=None) -> dict:
    """The sharded path (``parallel/lattice.py``, the fused sweep in shard
    mode, bf16) on a one-device mesh at the headline's size, best of
    ``n_iters`` timed calls after a warm-up. On the CPU (the plain
    version) the size is clamped to 1024^2 and 20 sweeps, as the reference
    clamps off its chip."""
    from tsu_tpu_torch.ops.checkerboard import split_checkerboard
    from tsu_tpu_torch.parallel.lattice import sharded_checkerboard_sweeps

    dev = resolve_device(device)
    if dev.type != "cuda":
        size = min(size, 1024)
        n_sweeps = min(n_sweeps, 20)
    mesh = make_mesh(rows=1, devices=[dev])
    red, black = split_checkerboard(torch.ones((size, size), dtype=torch.bfloat16, device=dev))

    def run(i, red, black):
        out = sharded_checkerboard_sweeps(mesh, seed + i, red, black, 2.269, n_sweeps,
                                          periodic=True)
        _sync([dev])
        return out

    red, black = run(0, red, black)
    best = 0.0
    for i in range(1, n_iters + 1):
        t0 = time.perf_counter()
        red, black = run(i, red, black)
        best = max(best, size * size * n_sweeps / (time.perf_counter() - t0))
    return {"size": size, "n_sweeps": n_sweeps, "flips_per_s": best,
            "kernel": "fused" if dev.type == "cuda" else "plain", "dtype": "bfloat16"}


def main(argv=None):
    import argparse
    import json
    import os

    parser = argparse.ArgumentParser(description="scaling-efficiency rows")
    parser.add_argument("--output-dir", default=None,
                        help="also write scaling_<platform><n>.json here")
    parser.add_argument("--device", default=None,
                        help="run every row on this one device (default: every card)")
    args = parser.parse_args(argv)

    devices = _devices(None if args.device is None else [args.device])
    on_card = devices[0].type == "cuda"
    result = {
        "topology": {"platform": devices[0].type, "n_devices": len(devices),
                     "devices": [str(d) for d in devices],
                     "shared_host_virtual_mesh": _shared_host(devices)},
        "chains": measure_chains_scaling(devices=devices),
        "bnn_dp": measure_bnn_dp_scaling(devices=devices),
        "lattice": measure_lattice_scaling(rows_per_device=1024 if on_card else 256,
                                           cols=4096 if on_card else 1024, devices=devices),
        "lattice_matched": measure_lattice_matched(device=devices[0]),
    }
    print(json.dumps(result, indent=2, default=float))
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        out = os.path.join(args.output_dir, f"scaling_{devices[0].type}{len(devices)}.json")
        with open(out, "w") as f:
            json.dump(result, f, indent=2, default=float)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
