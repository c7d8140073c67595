"""Simulated annealing of 2-D lattices through the sweep kernels.

Counterpart of ``tsu_tpu/samplers/annealing.py``: ``make_schedule``, the
fused branch of ``anneal_lattice`` (all chains sweep together, one batched
launch per sweep of the schedule, the best state tracked every
``track_every`` sweeps), the gates of the ±J table path
(``discrete_table_applicable``, ``pure_pm1_applicable``) and the kernel
branch of ``anneal_spin_glass`` on the bond half-sweep kernel. The JAX
package's XLA branches have no counterpart: on a CPU lattice the wrappers
run the kernels' plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.models.lattice_sampler import SEED_STRIDE
from tsu_tpu_torch.ops.checkerboard import (
    merge_checkerboard,
    plane_energy_batch,
    split_checkerboard,
)
from tsu_tpu_torch.ops.checkerboard_bonds import (
    color_bond_weights,
    lattice_energy_bonds,
    lattice_energy_bonds_planes,
)
from tsu_tpu_torch.ops.checkerboard_bonds_kernel import bond_kernel_weights, bond_key, bond_sweeps
from tsu_tpu_torch.ops.checkerboard_fused import fused_sweeps_keyed, sigmoid_table, sigmoid_table16
from tsu_tpu_torch.rng import as_generator, sweep_keys, to_int32


def checkpoint_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"checkpoint/resume of {what} is not ported to tsu_tpu_torch yet (slice 5 of "
        "ROADMAP.md, which ports checkpoint.py)")


def make_schedule(T_initial: float, T_final: float, n_steps: int,
                  kind: str = "exponential") -> np.ndarray:
    """Temperature schedule (n_steps,) float32, built on the host; equal bit
    for bit to ``tsu_tpu.samplers.annealing.make_schedule``."""
    t = np.arange(n_steps, dtype=np.float32) / max(n_steps - 1, 1)
    if kind == "exponential":
        return np.float32(T_initial) * np.float32(T_final / T_initial) ** t
    if kind == "linear":
        return np.float32(T_initial) + np.float32(T_final - T_initial) * t
    raise ValueError(f"unknown cooling schedule {kind!r}")


def anneal_lattice(seed, shape, *, J: float = 1.0, field: float = 0.0,
                   T_initial: float = 5.0, T_final: float = 0.05,
                   n_steps: int = 1000, cooling_schedule: str = "exponential",
                   n_chains: int = 1, periodic: bool = True,
                   track_every: int = 10, device=None):
    """Anneal ``n_chains`` (R, C) lattices on ``device`` (default
    ``torch.get_default_device()``); returns (best_state (R, C) float32
    tensor on that device, best_energy float) over all chains.

    ``seed``: an int or a CPU ``torch.Generator``; the initial lattices and
    the chains' stream ids are drawn from it. Exactly n_steps sweeps run:
    n_steps // track_every chunks of track_every sweeps and one remainder
    chunk. The best energy is tracked after each chunk, the initial state
    counting as a candidate. Sweep g of chain c (g counts across chunks)
    draws from (fold_seed(seeds[c]), g) at schedule[g]; the keys and tables
    of the whole anneal go to the device once.
    """
    if track_every < 1:
        raise ValueError(f"track_every must be positive, got {track_every}")
    device = resolve_device(device)
    gen = as_generator(seed)
    schedule = make_schedule(T_initial, T_final, n_steps, cooling_schedule)
    up = torch.rand((n_chains, *shape), generator=gen) < 0.5
    states = torch.where(up, 1.0, -1.0).to(device)
    seeds = torch.randint(0, 2**30, (n_chains,), generator=gen).numpy()

    tables = sigmoid_table16(J, field, torch.from_numpy(schedule))
    tables = tables[:, None, :].expand(n_steps, n_chains, 9).contiguous().to(device)
    keys = sweep_keys(seeds[None, :], np.arange(n_steps)[:, None]).to(device)

    reds, blacks = split_checkerboard(states.to(torch.bfloat16))
    best_r, best_b = reds, blacks
    best_e = plane_energy_batch(reds, blacks, J=J, field=field, periodic=periodic)
    for g in range(0, n_steps, track_every):
        reds, blacks = fused_sweeps_keyed(reds, blacks, tables[g:g + track_every],
                                          keys[g:g + track_every], periodic=periodic)
        e = plane_energy_batch(reds, blacks, J=J, field=field, periodic=periodic)
        better = (e < best_e)[:, None, None]
        best_r = torch.where(better, reds, best_r)
        best_b = torch.where(better, blacks, best_b)
        best_e = torch.minimum(e, best_e)
    i = int(torch.argmin(best_e))
    return merge_checkerboard(best_r[i], best_b[i]).float(), float(best_e[i])


def _in_pm1_or_zero(J: torch.Tensor) -> bool:
    return bool(((J == -1) | (J == 0) | (J == 1)).all())


def discrete_table_applicable(Jh, Jv, field) -> bool:
    """True when the ±J threshold-table path is exact: every bond in
    {-1, 0, +1} and a zero field, so the local field stays on the integers
    -4..4 that the 9-entry table covers. A non-zero field, even an integer
    one, moves it to ±5, off the table."""
    return (_in_pm1_or_zero(torch.as_tensor(Jh)) and _in_pm1_or_zero(torch.as_tensor(Jv))
            and float(field) == 0.0)


def pure_pm1_applicable(Jh, Jv, field, periodic: bool) -> bool:
    """True when every bond is ±1 (no zeros), the field is zero and the
    lattice periodic: the local field is then always even (the reference
    kernel's 5-entry parity table)."""
    return bool(periodic and float(field) == 0.0
                and (torch.as_tensor(Jh).abs() == 1).all()
                and (torch.as_tensor(Jv).abs() == 1).all())


def anneal_spin_glass(seed, Jh, Jv, *, field: float = 0.0, T_initial: float = 3.0,
                      T_final: float = 0.05, n_steps: int = 2000,
                      cooling_schedule: str = "exponential", n_restarts: int = 1,
                      periodic: bool = True, checkpoint_path=None, resume: bool = False,
                      device=None):
    """Ground-state search on a lattice with per-bond couplings (the ±J
    Edwards-Anderson spin glass): annealed sweeps of the bond half-sweep
    kernel over a per-sweep schedule, best state over ``n_restarts``
    anneals on ``device`` (default ``torch.get_default_device()``). Returns
    (best_state (R, C) float32 numpy array, best_energy float).

    ``seed``: an int or a CPU ``torch.Generator``; each restart draws its
    initial lattice and a stream id from it. Bonds in {-1, 0, +1} with a zero
    field take the discrete mode (code planes, bfloat16 spins, a 24-bit
    table per sweep), others the continuous one (float32 weights and spins).
    The best state is tracked every ``max(1, n_steps // 20)`` sweeps; chunk
    i draws from the stream id seed + i * SEED_STRIDE, its half-sweeps keyed
    (fold_seed(id, colour), sweep within the chunk). The energy returned is
    ``lattice_energy_bonds`` of the state returned. ``checkpoint_path`` and
    ``resume`` raise ``NotImplementedError``.
    """
    if checkpoint_path is not None or resume:
        raise checkpoint_not_ported("anneal_spin_glass")
    device = resolve_device(device)
    gen = as_generator(seed)
    Jh = torch.as_tensor(Jh, dtype=torch.float32).to(device)
    Jv = torch.as_tensor(Jv, dtype=torch.float32).to(device)
    R, C = Jh.shape
    discrete = discrete_table_applicable(Jh, Jv, field)
    weights = color_bond_weights(Jh, Jv, field, periodic)
    kernel_weights = bond_kernel_weights(weights, discrete)
    dtype = torch.bfloat16 if discrete else torch.float32
    schedule = make_schedule(T_initial, T_final, n_steps, cooling_schedule)
    tables = sigmoid_table(1.0, 0.0, torch.from_numpy(schedule)).to(device) if discrete else None
    track_every = max(1, n_steps // 20)

    best_state, best_e = None, float("inf")
    for _ in range(n_restarts):
        up = torch.rand((R, C), generator=gen) < 0.5
        run_seed = int(torch.randint(0, 2**30, (), generator=gen))
        red, black = split_checkerboard(torch.where(up, 1.0, -1.0).to(device, dtype))
        best_r, best_b = red, black
        be = lattice_energy_bonds_planes(red, black, weights, periodic=periodic)
        for i, g in enumerate(range(0, n_steps, track_every)):
            n = min(track_every, n_steps - g)
            chunk_seed = to_int32(run_seed + i * SEED_STRIDE)
            keys = [[bond_key(chunk_seed, c, k) for c in (0, 1)] for k in range(n)]
            red, black = bond_sweeps(red, black, kernel_weights, keys,
                                     temperatures=schedule[g:g + n],
                                     tables=None if tables is None else tables[g:g + n],
                                     periodic=periodic)
            e = lattice_energy_bonds_planes(red, black, weights, periodic=periodic)
            better = e < be
            best_r = torch.where(better, red, best_r)
            best_b = torch.where(better, black, best_b)
            be = torch.minimum(e, be)
        lattice = merge_checkerboard(best_r, best_b).float()
        e = float(lattice_energy_bonds(lattice, Jh, Jv, field, periodic=periodic))
        if e < best_e:
            best_state, best_e = lattice.cpu().numpy(), e
    return best_state, best_e
