"""Graft entry points: one step on the card, and a dry run of the sharded
paths on a mesh.

Counterpart of the repository's ``__graft_entry__.py``:

``entry(device=None)`` -> (fn, args): ``fn(*args)`` runs one full
    checkerboard heat-bath sweep of a 256^2 lattice at T = 2.269, the fused
    sweep (K1) on the card.
``dryrun_multichip(n_devices, device=None)`` builds meshes of n_devices
    devices and runs the sharded paths a few steps, with their assertions:
    the spatially sharded sample on row shards (K1 in shard mode) and on
    2 x 2 (K3), the 4x4 exact-enumeration check on 2 row shards, a
    data-parallel BNN training step (``fit(mesh=)``) and replica-sharded
    tempering (K2). On the card the mesh takes the visible cards, then
    repeats ``cuda:0`` up to n_devices; ``device="cpu"`` runs every shard on
    the CPU (the plain versions). The reference's Pallas interpret-mode
    section has no counterpart: the sharded sections run the kernels
    themselves.
"""

from __future__ import annotations

import numpy as np
import torch

from tsu_tpu_torch.config import resolve_device


def entry(device=None):
    """(fn, args): ``fn(seed, lattice, temperature)`` returns the (256, 256)
    lattice after one sweep."""
    from tsu_tpu_torch.ops.checkerboard import merge_checkerboard, split_checkerboard
    from tsu_tpu_torch.ops.checkerboard_fused import fused_sweeps

    dev = resolve_device(device)

    def fn(seed, lattice, temperature):
        red, black = split_checkerboard(lattice.to(torch.bfloat16))
        red, black = fused_sweeps(seed, red, black, temperature, 1, J=1.0, field=0.0,
                                  periodic=True)
        return merge_checkerboard(red, black).float()

    lattice = torch.ones((256, 256), dtype=torch.float32, device=dev)
    return fn, (0, lattice, 2.269)


def mesh_devices(n_devices: int, device=None) -> list:
    """n_devices devices: the visible cards, then cuda:0 repeated, or the
    CPU n_devices times."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * n_devices
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return (cards + [torch.device("cuda", 0)] * n_devices)[:n_devices]


def _check(ok: bool, what) -> None:
    """Raise AssertionError(what) unless ok (kept under ``python -O``)."""
    if not ok:
        raise AssertionError(what)


def _torus_J(L: int) -> np.ndarray:
    n = L * L
    J = np.zeros((n, n))
    for r in range(L):
        for c in range(L):
            i = r * L + c
            for rr, cc in ((r, (c + 1) % L), ((r + 1) % L, c)):
                j = rr * L + cc
                J[i, j] += 1.0
                J[j, i] += 1.0
    return J


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the sharded paths on meshes of ``n_devices`` devices; raises
    AssertionError if one fails its check."""
    from tsu_tpu_torch.models.ml import BayesianNetwork
    from tsu_tpu_torch.parallel import make_mesh, sharded_lattice_sample

    devices = mesh_devices(n_devices, device)

    # --- 1. Spatially sharded lattice Gibbs: row shards (K1's shard mode),
    # and rows x columns when the device count splits (K3, column halos).
    layouts = [(n_devices, 1)]
    if n_devices % 2 == 0 and n_devices >= 4:
        layouts.append((n_devices // 2, 2))
    for n_rows, n_cols in layouts:
        mesh = make_mesh(rows=n_rows, cols=n_cols, devices=devices)
        out = sharded_lattice_sample(
            mesh, 0, torch.ones((2 * n_rows, 4 * n_cols), dtype=torch.float32),
            n_samples=2, temperature=2.0, n_burnin=2, n_sweeps=1, periodic=True,
            col_axis="col" if n_cols > 1 else None,
        )
        m = out["magnetization"].numpy()
        _check(m.shape == (2,) and np.all(np.abs(m) <= 1.0), (n_rows, n_cols, m))

    # The sharded sampler reproduces exact 4x4 enumeration within MC error.
    if n_devices >= 2:
        from tsu_tpu_torch.oracle import exact_ising_moments

        L4, T4 = 4, 3.0
        exact = exact_ising_moments(_torus_J(L4), np.zeros(L4 * L4), temperature=T4)
        stat = sharded_lattice_sample(
            make_mesh(rows=2, devices=devices[:2]), 11, torch.ones((L4, L4)),
            n_samples=1500, temperature=T4, n_burnin=200, n_sweeps=2, periodic=True,
        )
        m_abs = np.abs(stat["magnetization"].numpy())
        e = stat["energy"].numpy()
        # ~3 sigma bands at 1500 samples (sigma_|m| ~ 0.17, sigma_E ~ 6.3).
        _check(abs(m_abs.mean() - exact["abs_magnetization"]) < 0.05,
               (m_abs.mean(), exact["abs_magnetization"]))
        _check(abs(e.mean() - exact["energy"]) < 1.0, (e.mean(), exact["energy"]))

    # --- 2. Data-parallel BNN ELBO step: each minibatch split over the
    # ``chains`` axis, gradients averaged.
    dp_mesh = make_mesh(chains=n_devices, devices=devices)
    batch = 4 * n_devices
    x = np.linspace(-1, 1, batch * 2, dtype=np.float32).reshape(batch, 2)
    y = x.sum(axis=1, keepdims=True)
    net = BayesianNetwork([2, 8, 1], activation="relu", prior_std=1.0, seed=1,
                          device=devices[0])
    hist = net.fit(x, y, n_epochs=1, batch_size=batch, learning_rate=1e-2, kl_weight=1e-3,
                   n_samples_per_batch=2, mesh=dp_mesh)
    _check(np.isfinite(hist["loss_history"][-1]), hist)

    # --- 3. Replica axis: parallel tempering sharded over the mesh (K2).
    if n_devices > 1:
        from tsu_tpu_torch.parallel.tempering_sharded import parallel_tempering_replica_sharded

        out = parallel_tempering_replica_sharded(
            make_mesh(replica=n_devices, devices=devices), 2, (4, 4),
            temperatures=np.geomspace(1.0, 4.0, n_devices),
            n_samples=2, swap_interval=1, n_sweeps=1, n_burnin=1,
        )
        _check(out["magnetization"].shape == (2, n_devices), out["magnetization"].shape)
    else:
        from tsu_tpu_torch.samplers.tempering import parallel_tempering_lattice

        cold, _ = parallel_tempering_lattice(
            2, (4, 4), temperatures=np.geomspace(1.0, 4.0, 2),
            n_samples=2, swap_interval=1, n_burnin=1, device=devices[0],
        )
        _check(tuple(cold.shape) == (2, 4, 4), cold.shape)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", tuple(out.shape), out.dtype)
    n = max(torch.cuda.device_count(), 1)
    dryrun_multichip(n)
    print(f"dryrun_multichip({n}) ok")
