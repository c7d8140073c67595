"""Simulated annealing of 2-D lattices through the batched fused sweep.

Counterpart of ``tsu_tpu/samplers/annealing.py``: ``make_schedule`` and the
fused branch of ``anneal_lattice``. All chains sweep together, one batched
launch per sweep of the schedule, and the best state is tracked every
``track_every`` sweeps. The JAX package's XLA branch has no counterpart: on a
CPU lattice the wrapper runs the kernel's plain version.
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
from tsu_tpu_torch.ops.checkerboard_fused import fused_sweeps_keyed, sigmoid_table16
from tsu_tpu_torch.rng import as_generator, sweep_keys


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
