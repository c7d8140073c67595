"""Simulated annealing: dense bit-Boltzmann models, and 2-D lattices
through the sweep kernels.

Counterpart of ``tsu_tpu/samplers/annealing.py``: ``make_schedule``,
``simulated_annealing_dense`` (the native host loop for small problems, the
graphed colour sweep of ``samplers/gibbs.py`` for the rest), the
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

from tsu_tpu_torch.checkpoint import checkpoint_exists, restore_state, save_state
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
from tsu_tpu_torch.samplers.gibbs import ColourPlan, DenseSweeper


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


def takes_native(n: int, n_steps: int, n_chains: int) -> bool:
    """Whether :func:`simulated_annealing_dense` with an int seed anneals n
    bits on the native host loop (n <= 256 and n^2 * n_steps * n_chains <=
    2^31)."""
    return n <= 256 and n * n * n_steps * max(n_chains, 1) <= (1 << 31)


def simulated_annealing_dense(seed, J, h, *, T_initial: float = 10.0, T_final: float = 0.1,
                              n_steps: int = 1000, cooling_schedule: str = "exponential",
                              n_chains: int = 1, device=None):
    """Anneal bit states of a dense (J, h); returns (best_state (n,) float32
    numpy array, best_energy) over all chains and steps.

    An int ``seed`` on a small problem (n <= 256 and n^2 * n_steps *
    n_chains <= 2^31) runs the native host loop (site by site in index
    order, chains one after another; the energy a numpy float32). Everything
    else anneals on ``device`` (default the card): all chains take one
    colour sweep per temperature of the schedule (a CUDA graph on the card)
    and the best state of each chain is tracked after every sweep, the
    initial state counting as a candidate; the energy is a float.
    ``seed``: an int or a CPU ``torch.Generator``.
    """
    J_np = np.asarray(J, np.float32)
    h_np = np.asarray(h, np.float32)
    n = J_np.shape[0]
    schedule = make_schedule(T_initial, T_final, n_steps, cooling_schedule)
    if takes_native(n, n_steps, n_chains) and isinstance(seed, (int, np.integer)):
        from tsu_tpu_torch.native import sa_dense_native

        state, e = sa_dense_native(J_np, h_np, schedule, n_chains, int(seed))
        return state, np.float32(e)
    gen = as_generator(seed)
    plan = ColourPlan(J_np, h_np, device=device)
    sweeper = DenseSweeper(plan, n_chains, gen)
    sweeper.load((torch.rand((n_chains, n), generator=gen) < 0.5).to(torch.float32))
    best = sweeper.states.clone()
    best_e = sweeper.energies()
    for T in schedule.tolist():
        sweeper.set_temperature(T)
        sweeper.run(1)
        e = sweeper.energies()
        better = (e < best_e)[:, None]
        torch.where(better, sweeper.states, best, out=best)
        torch.minimum(e, best_e, out=best_e)
    i = int(torch.argmin(best_e))
    return plan.from_plan(best[i]).cpu().numpy(), float(best_e[i])


def anneal_lattice(seed, shape, *, J: float = 1.0, field: float = 0.0,
                   T_initial: float = 5.0, T_final: float = 0.05,
                   n_steps: int = 1000, cooling_schedule: str = "exponential",
                   n_chains: int = 1, periodic: bool = True,
                   track_every: int = 10, device=None):
    """Anneal ``n_chains`` (R, C) lattices on ``device`` (default
    the card, ``"cuda"``); returns (best_state (R, C) float32
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
    anneals on ``device`` (default the card, ``"cuda"``). Returns
    (best_state (R, C) float32 numpy array, best_energy float).

    ``seed``: an int or a CPU ``torch.Generator``; each restart draws its
    initial lattice and a stream id from it. Bonds in {-1, 0, +1} with a zero
    field take the discrete mode (code planes, bfloat16 spins, a 24-bit
    table per sweep), others the continuous one (float32 weights and spins).
    The best state is tracked every ``max(1, n_steps // 20)`` sweeps; chunk
    i draws from the stream id seed + i * SEED_STRIDE, its half-sweeps keyed
    (fold_seed(id, colour), sweep within the chunk). The energy returned is
    ``lattice_energy_bonds`` of the state returned.

    ``checkpoint_path`` snapshots the best state, its energy, the restarts
    done and the state of the generator after each finished restart;
    ``resume=True`` restores that snapshot, when it exists, and runs the
    restarts left, so the resumed search returns exactly what the
    uninterrupted one would from the same seed.
    """
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
    r_start = 0
    if resume and checkpoint_path is not None and checkpoint_exists(checkpoint_path):
        st = restore_state(checkpoint_path, {
            "best_state": np.zeros((R, C), np.float32), "best_e": 0.0, "restarts_done": 0,
            "generator": gen.get_state()})
        r_start = st["restarts_done"]
        best_state, best_e = st["best_state"], st["best_e"]
        gen.set_state(st["generator"])
    for r in range(r_start, n_restarts):
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
        if checkpoint_path is not None:
            save_state(checkpoint_path, {"best_state": best_state, "best_e": best_e,
                                         "restarts_done": r + 1, "generator": gen.get_state()})
    return best_state, best_e
