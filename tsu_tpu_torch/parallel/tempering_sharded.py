"""Parallel tempering with replicas sharded over the ``replica`` mesh axis.

Counterpart of ``tsu_tpu/parallel/tempering_sharded.py``. Each mesh device
holds n_replicas / n_devices lattice replicas as one batch of compact planes
for the whole run and sweeps them through the batched fused sweep (K2), one
launch per sweep, each replica at the temperature of the rung it holds.
Swap rounds exchange rungs, not lattices: the replicas' energies are gathered
to the host, which makes the same even/odd Metropolis decisions as the
reference and permutes the rung assignment; the next round's threshold rows
follow the rungs. Nothing larger than O(n_replicas) scalars leaves a device.
Per-round (magnetization, energy, rung) traces come back, so the cold
chain's (rung 0) observables are picked on the host.

Across processes (``parallel.multihost_initialize``) each rank sweeps the
replicas of its own mesh entries (``Mesh.ranks``); per round the (m, e)
pairs are gathered on every rank, and every rank makes the same swap
decisions from the same CPU generator: there is no coordinator, as the
reference says of itself (``docs/DISTRIBUTED.md``).

Host randomness (initial lattices, per-round stream ids, swap uniforms) is
drawn up front from a CPU ``torch.Generator``, so a seed gives the same run
on every mesh. Energies and magnetizations are float64.
"""

from __future__ import annotations

import numpy as np
import torch

from tsu_tpu_torch.ops.checkerboard import plane_energy_batch, split_checkerboard
from tsu_tpu_torch.ops.checkerboard_fused import fused_sweeps_keyed, sigmoid_table16
from tsu_tpu_torch.parallel import distributed
from tsu_tpu_torch.parallel.mesh import Mesh
from tsu_tpu_torch.rng import as_generator, sweep_keys


def _rung_swap(u: np.ndarray, energies: np.ndarray, rungs: np.ndarray,
               betas_ladder: np.ndarray, offset: int):
    """Even/odd rung exchange; returns (new rungs, accepted pairs).

    ``energies``, ``rungs``: (n_replicas,) per replica; ``u``: (n_replicas,)
    uniforms, the pair of rungs (k, k+1) deciding with u[k]."""
    R = energies.shape[0]
    replica_of_rung = np.argsort(rungs)
    e_by_rung = energies[replica_of_rung]
    idx = np.arange(R)
    is_left = ((idx - offset) % 2 == 0) & (idx >= offset) & (idx + 1 < R)
    partner = np.where(is_left, idx + 1,
                       np.where(((idx - offset) % 2 == 1) & (idx >= 1), idx - 1, idx))
    delta = (betas_ladder - betas_ladder[partner]) * (e_by_rung - e_by_rung[partner])
    u_shared = np.where(is_left, u, u[partner])
    accept = (partner != idx) & (u_shared < np.exp(np.minimum(delta, 0.0)))
    new_rung_by_rung = np.where(accept, partner, idx)   # rung k -> its new rung
    return new_rung_by_rung[rungs], int(np.sum(accept & is_left))


def _replica_devices(mesh: Mesh, axis_name: str) -> tuple:
    """(devices, ranks) of the entries along ``axis_name``."""
    names = list(mesh.axis_names)
    axis = names.index(axis_name)
    rest = tuple(0 for a in range(len(names)) if a != axis)
    return tuple(list(np.moveaxis(a, axis, 0)[(slice(None),) + rest])
                 for a in (mesh.devices, mesh.ranks))


def parallel_tempering_replica_sharded(mesh: Mesh, seed, shape, temperatures, *,
                                       n_samples: int = 100, swap_interval: int = 5,
                                       n_sweeps: int = 1, n_burnin: int = 50, J: float = 1.0,
                                       field: float = 0.0, periodic: bool = True,
                                       axis_name: str = "replica") -> dict:
    """Replica exchange over the ``replica`` mesh axis.

    n_replicas = len(temperatures) must be divisible by the axis size;
    device d holds replicas d * per_dev .. (d + 1) * per_dev - 1, and
    replica r starts on rung r of the ascending ladder. Each round sweeps
    every replica n_sweeps times (replica r of round t draws from
    (fold_seed(seeds[t, r]), k) for its k-th sweep), then gathers the
    energies and, every swap_interval rounds, exchanges rungs. ``seed``: an
    int or a CPU ``torch.Generator``. Returns per-sample (n_samples,
    n_replicas) ``magnetization`` (per spin), ``energy`` and ``rungs``, the
    cold rung's ``cold_magnetization`` and ``cold_energy``, ``swap_accepts``,
    ``swap_acceptance_rate`` and ``final_rungs``, all numpy.
    """
    temps = np.asarray(temperatures, np.float32).reshape(-1)
    n_rep = temps.shape[0]
    devs, owners = _replica_devices(mesh, axis_name)
    n_dev = len(devs)
    mine = [d for d in range(n_dev) if owners[d] == distributed.rank()]
    if n_rep % n_dev:
        raise ValueError(f"{n_rep} replicas on {n_dev} devices")
    per_dev = n_rep // n_dev
    rows, cols = shape
    n_sites = rows * cols
    ladder = np.sort(temps)
    betas_ladder = 1.0 / ladder.astype(np.float64)
    total = n_burnin + n_samples

    gen = as_generator(seed)
    lat0 = torch.where(torch.rand((n_rep, rows, cols), generator=gen) < 0.5, 1.0, -1.0)
    seeds = torch.randint(0, 2**30, (total, n_rep), generator=gen).numpy()
    swap_u = torch.rand((total, n_rep), generator=gen).numpy()
    keys_all = sweep_keys(seeds[:, None, :], np.arange(n_sweeps)[None, :, None])
    tables_all = sigmoid_table16(J, field, torch.from_numpy(ladder))   # row k: rung k

    slots = [slice(d * per_dev, (d + 1) * per_dev) for d in range(n_dev)]
    planes = {d: split_checkerboard(lat0[slots[d]].to(devs[d], torch.bfloat16)) for d in mine}
    keys = {d: keys_all[:, :, slots[d]].contiguous().to(devs[d]) for d in mine}
    tables = {d: tables_all.to(devs[d]) for d in mine}

    rungs = np.arange(n_rep)
    ms = np.empty((total, n_rep))
    es = np.empty((total, n_rep))
    rung_hist = np.empty((total, n_rep), dtype=np.int64)
    n_acc = 0
    for t in range(total):
        obs = torch.zeros((2, n_rep), dtype=torch.float64)
        for d in mine:
            my_rungs = torch.from_numpy(rungs[slots[d]]).to(devs[d])
            reds, blacks = fused_sweeps_keyed(*planes[d], tables[d][my_rungs], keys[d][t],
                                              periodic=periodic)
            planes[d] = (reds, blacks)
            m = (reds.sum((-2, -1), dtype=torch.float64)
                 + blacks.sum((-2, -1), dtype=torch.float64)) / n_sites
            e = plane_energy_batch(reds, blacks, J=J, field=field, periodic=periodic)
            obs[:, slots[d]] = torch.stack([m, e]).cpu()
        if distributed.initialized():
            obs = distributed.all_reduce_sum(obs)    # each replica's pair from its rank
        m_all, e_all = obs.numpy()
        if (t + 1) % swap_interval == 0:
            rungs, acc = _rung_swap(swap_u[t], e_all, rungs, betas_ladder,
                                    (t // swap_interval) % 2)
            n_acc += acc
        ms[t], es[t], rung_hist[t] = m_all, e_all, rungs
    ms, es, rung_hist = ms[n_burnin:], es[n_burnin:], rung_hist[n_burnin:]
    cold_idx = rung_hist.argmin(axis=1)
    at = np.arange(n_samples)
    n_swap_rounds = max(total // swap_interval, 1)
    return {
        "magnetization": ms,
        "energy": es,
        "rungs": rung_hist,
        "cold_magnetization": ms[at, cold_idx],
        "cold_energy": es[at, cold_idx],
        "swap_accepts": n_acc,
        "swap_acceptance_rate": n_acc / (n_swap_rounds * max(n_rep - 1, 1) / 2),
        "final_rungs": rungs,
    }
