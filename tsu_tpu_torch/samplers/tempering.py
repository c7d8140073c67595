"""Parallel tempering (replica exchange) of 2-D lattices on the batched sweep
kernels.

Counterpart of ``tsu_tpu/samplers/tempering.py``: ``_swap_permutation``, the
generic loop ``_state_exchange_run``, ``_pt_info``,
``parallel_tempering_lattice`` (uniform J, the batched fused sweep),
``_BondPlaneOps`` and ``parallel_tempering_bonds`` (one bond set, the
batched bond half-sweep). Every rung sweeps in one batched launch at its own
temperature; the replicas stay checkerboard planes across rounds, their
energies are taken from the planes, and only the cold samples and the final
states are merged into lattices. Swaps decide on the device, so a round
needs no sync.
All host randomness (initial lattices, per-round stream ids, swap uniforms)
is drawn from a CPU ``torch.Generator`` before the run, so a seed gives the
same chain on every device.

Swap rule: replicas i (colder) and j = i + 1 exchange states with
probability min(1, exp((beta_i - beta_j)(E_i - E_j))).
"""

from __future__ import annotations

import numpy as np
import torch

from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.ops.checkerboard import (
    merge_checkerboard,
    plane_energy_batch,
    split_checkerboard,
)
from tsu_tpu_torch.ops.checkerboard_bonds import color_bond_weights, lattice_energy_bonds_planes
from tsu_tpu_torch.ops.checkerboard_bonds_kernel import (
    bond_kernel_weights,
    bond_modes,
    bond_sweep_keys,
    bond_sweeps_keyed,
)
from tsu_tpu_torch.ops.checkerboard_fused import fused_sweeps_keyed, sigmoid_table16
from tsu_tpu_torch.rng import as_generator, sweep_keys
from tsu_tpu_torch.samplers.annealing import discrete_table_applicable


def _swap_permutation(u: torch.Tensor, energies: torch.Tensor,
                      betas: torch.Tensor, offset: int):
    """Even/odd adjacent-pair Metropolis swap as a permutation of replica
    slots; returns (perm, acc_pairs, att_pairs), the pair counts (R-1,)
    int32 with index p for the pair (p, p+1).

    ``u``: (R,) float32 uniforms; the pair (p, p+1) decides with u[p].
    The energy difference is taken in the energies' dtype, then the exponent
    in float32 as in the JAX package. ``energies`` and ``u`` may carry
    leading axes (independent ladders, one per row): perm and acc_pairs
    then carry them too, att_pairs does not.
    """
    R = energies.shape[-1]
    idx = torch.arange(R, device=energies.device)
    is_left = ((idx - offset) % 2 == 0) & (idx >= offset) & (idx + 1 < R)
    is_right = ((idx - offset) % 2 == 1) & (idx >= 1)
    partner = torch.where(is_left, idx + 1, torch.where(is_right, idx - 1, idx))
    delta = (betas - betas[partner]) * (energies - energies[..., partner]).to(torch.float32)
    u_shared = torch.where(is_left, u, u[..., partner])
    accept = (partner != idx) & (u_shared < torch.exp(torch.clamp(delta, max=0.0)))
    perm = torch.where(accept, partner, idx)
    att_pairs = is_left[:-1].to(torch.int32)
    acc_pairs = (accept & is_left)[..., :-1].to(torch.int32)
    return perm, acc_pairs, att_pairs


def _state_exchange_run(states0: tuple, sweep_all, energy_of,
                        betas: torch.Tensor, swap_u: torch.Tensor, *,
                        total: int, swap_interval: int, n_burnin: int):
    """Replica-exchange loop shared by the lattice-carrying PT variants.

    ``states0``: a tuple of (R, ...) tensors that together hold the replica
    states (the two checkerboard planes, say), slot 0 the coldest rung; a
    swap permutes all of them. ``sweep_all(states, t)`` advances every
    replica one round; ``energy_of(states)`` gives (R,) energies.
    ``swap_u``: (total, R) float32 uniforms on the states' device. Round t
    swaps when (t + 1) % swap_interval == 0, pairing from slot
    (t // swap_interval) % 2. Returns (a tuple of the cold slots of the
    rounds after burn-in, (total, R) energies before each swap, the final
    states, acc_pairs, att_pairs) with the pair counts as (R-1,) numpy
    vectors.
    """
    R = betas.shape[0]
    states = tuple(states0)
    device = states[0].device
    cold = tuple(torch.empty((total - n_burnin, *s.shape[1:]), dtype=s.dtype, device=device)
                 for s in states)
    energy_hist = torch.empty((total, R), dtype=torch.float64, device=device)
    acc_p = torch.zeros(R - 1, dtype=torch.int32, device=device)
    att_p = torch.zeros_like(acc_p)
    for t in range(total):
        states = tuple(sweep_all(states, t))
        energies = energy_of(states)
        energy_hist[t] = energies
        if (t + 1) % swap_interval == 0:
            offset = (t // swap_interval) % 2
            perm, acc, att = _swap_permutation(swap_u[t], energies, betas, offset)
            states = tuple(s[perm] for s in states)
            acc_p += acc
            att_p += att
        if t >= n_burnin:
            for c, s in zip(cold, states):
                c[t - n_burnin] = s[0]
    return cold, energy_hist, states, acc_p.cpu().numpy(), att_p.cpu().numpy()


def _pt_info(acc_p, att_p, energy_hist, finals) -> dict:
    """info dict shared by every PT variant: aggregate and per-pair swap
    statistics (pair p = adjacent rungs (p, p+1), coldest first), the
    per-round energies and the final states, as numpy arrays."""
    acc_p = np.asarray(acc_p)
    att_p = np.asarray(att_p)
    n_acc, n_att = int(acc_p.sum()), int(att_p.sum())
    return {
        "swap_acceptance_rate": n_acc / n_att if n_att > 0 else 0.0,
        "swap_attempts": n_att,
        "swap_accepts": n_acc,
        "pair_acceptance": acc_p / np.maximum(att_p, 1),
        "pair_attempts": att_p,
        "energies": energy_hist.cpu().numpy(),
        "final_states": finals.cpu().numpy(),
    }


def parallel_tempering_lattice(seed, shape, *, temperatures, J: float = 1.0,
                               field: float = 0.0, n_samples: int = 100,
                               swap_interval: int = 10, n_sweeps: int = 1,
                               n_burnin: int = 100, periodic: bool = True,
                               device=None):
    """Replica exchange over checkerboard lattice sweeps on ``device``
    (default ``torch.get_default_device()``).

    ``seed``: an int or a CPU ``torch.Generator``. ``temperatures``: (R,)
    rung temperatures, slot 0 the coldest. Each round sweeps every replica
    n_sweeps times in batched launches (replica r of round t draws from
    (fold_seed(seeds[t, r]), k) for its k-th sweep), then computes the
    energies and, every swap_interval rounds, swaps adjacent rungs. Returns
    (cold samples (n_samples, R_rows, C) float32 tensor on that device, the
    info dict of :func:`_pt_info`).
    """
    device = resolve_device(device)
    gen = as_generator(seed)
    temps = torch.as_tensor(temperatures, dtype=torch.float32).cpu().reshape(-1)
    R = temps.shape[0]
    total = n_burnin + n_samples
    up = torch.rand((R, *shape), generator=gen) < 0.5
    states = torch.where(up, 1.0, -1.0).to(device, torch.bfloat16)
    seeds = torch.randint(0, 2**30, (total, R), generator=gen).numpy()
    swap_u = torch.rand((total, R), generator=gen).to(device)

    keys = sweep_keys(seeds[:, None, :], np.arange(n_sweeps)[None, :, None]).to(device)
    tables = sigmoid_table16(J, field, temps).to(device)
    betas = (1.0 / temps).to(device)

    def sweep_all(planes, t):
        return fused_sweeps_keyed(*planes, tables, keys[t], periodic=periodic)

    def energy_of(planes):
        return plane_energy_batch(*planes, J=J, field=field, periodic=periodic)

    cold, energy_hist, finals, acc_p, att_p = _state_exchange_run(
        split_checkerboard(states), sweep_all, energy_of, betas, swap_u, total=total,
        swap_interval=swap_interval, n_burnin=n_burnin)
    return (merge_checkerboard(*cold).float(),
            _pt_info(acc_p, att_p, energy_hist, merge_checkerboard(*finals).float()))


class _BondPlaneOps:
    """Plane-level primitives for a batch of replicas over one bond
    realization (Jh, Jv) on one device: initial planes, keyed sweeps on the
    batched bond kernel, energies and the merge, all in the compact
    (B, R, C/2) layout.

    Bonds in {-1, 0, +1} with a zero field take the discrete mode: code
    planes and bfloat16 spins; others the continuous mode: float32 weights
    and spins. Energies come from the planes and the float32 weight planes
    (``lattice_energy_bonds_planes``), whatever form the kernel reads.
    """

    def __init__(self, Jh, Jv, *, field=0.0, periodic: bool = True, device=None):
        self.device = resolve_device(device)
        self.Jh = torch.as_tensor(Jh, dtype=torch.float32).to(self.device)
        self.Jv = torch.as_tensor(Jv, dtype=torch.float32).to(self.device)
        self.field, self.periodic = field, periodic
        self.discrete = discrete_table_applicable(self.Jh, self.Jv, field)
        self.energy_weights = color_bond_weights(self.Jh, self.Jv, field, periodic)
        self.weights = bond_kernel_weights(self.energy_weights, self.discrete)
        self.dtype = torch.bfloat16 if self.discrete else torch.float32

    def init_planes(self, generator: torch.Generator, batch: int):
        up = torch.rand((batch, *self.Jh.shape), generator=generator) < 0.5
        return split_checkerboard(torch.where(up, 1.0, -1.0).to(self.device, self.dtype))

    def modes(self, temperatures) -> dict:
        """The temperatures (any shape) in the form the kernel reads."""
        return bond_modes(temperatures, self.discrete, self.device)

    def sweep_keyed(self, reds, blacks, keys, modes: dict):
        return bond_sweeps_keyed(reds, blacks, self.weights, keys, periodic=self.periodic,
                                 **modes)

    def energy_planes(self, reds, blacks):
        return lattice_energy_bonds_planes(reds, blacks, self.energy_weights,
                                           periodic=self.periodic)

    def merge(self, reds, blacks):
        return merge_checkerboard(reds, blacks).float()


def parallel_tempering_bonds(seed, Jh, Jv, *, temperatures, field: float = 0.0,
                             n_samples: int = 100, swap_interval: int = 10,
                             n_sweeps: int = 1, n_burnin: int = 100, periodic: bool = True,
                             device=None):
    """Replica exchange over one bond realization (per-bond couplings) on
    ``device`` (default ``torch.get_default_device()``).

    Every rung sweeps the same bonds at its own temperature (sorted
    ascending, slot 0 the coldest), all rungs in one batched bond kernel
    launch per half-sweep; adjacent rungs exchange states by the Metropolis
    rule every swap_interval rounds. Replica r of round t draws from
    (fold_seed(seeds[t, r]), 2k + colour) for sweep k of the round. Returns
    (cold samples (n_samples, R_rows, C) float32 tensor on that device, the
    info dict of :func:`_pt_info` with ``"discrete_table_path"``, True when
    the bonds took the kernel's discrete mode).

    Swap acceptance falls like exp(-dbeta dE) with dE extensive in the
    lattice size: large lattices need many rungs, or a ladder from
    ``tsu_tpu_torch.samplers.tempering_ladder.build_tempering_ladder``.
    """
    ops = _BondPlaneOps(Jh, Jv, field=field, periodic=periodic, device=device)
    gen = as_generator(seed)
    temps = np.sort(np.asarray(temperatures, np.float32).reshape(-1))
    R = temps.shape[0]
    total = n_burnin + n_samples
    planes = ops.init_planes(gen, R)
    seeds = torch.randint(0, 2**30, (total, R), generator=gen).numpy()
    swap_u = torch.rand((total, R), generator=gen).to(ops.device)
    keys = bond_sweep_keys(seeds, n_sweeps).to(ops.device)
    modes = ops.modes(temps)
    betas = (1.0 / torch.from_numpy(temps)).to(ops.device)

    cold, energy_hist, finals, acc_p, att_p = _state_exchange_run(
        planes, lambda planes, t: ops.sweep_keyed(*planes, keys[t], modes),
        lambda planes: ops.energy_planes(*planes), betas, swap_u, total=total,
        swap_interval=swap_interval, n_burnin=n_burnin)
    info = _pt_info(acc_p, att_p, energy_hist, ops.merge(*finals))
    info["discrete_table_path"] = ops.discrete
    return ops.merge(*cold), info
