"""Single-device lattice sampling entry: glue between IsingGrid and the
sweep kernels.

Counterpart of ``tsu_tpu/models/lattice_sampler.py``: ``sample_grid`` (one
lattice) and ``sample_grid_ensemble`` (B lattices, each at its own
temperature, one batched launch per sweep). Every even grid goes through the
fused sweep (the CUDA kernel for a lattice on the card, its plain version for
one on the CPU): the kernel takes any even R and C, so the JAX package's
streaming path for R % 8 != 0 and its XLA ensemble branch have no
counterpart here. A lattice with per-bond couplings is sampled by
``tsu_tpu_torch.ops.checkerboard_bonds.sample_lattice_bonds``, where the JAX
package has it too.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from tsu_tpu_torch.ops.checkerboard import (
    merge_checkerboard,
    plane_energy_batch,
    split_checkerboard,
)
from tsu_tpu_torch.ops.checkerboard_fused import (
    fused_sweeps,
    fused_sweeps_keyed,
    sigmoid_table16,
)
from tsu_tpu_torch.rng import SEED_STRIDE, sweep_keys, to_int32


def sample_chain(generator: torch.Generator, lattice0: torch.Tensor, *,
                 n_samples: int, temperature, J: float = 1.0,
                 field: float = 0.0, n_burnin: int = 100, n_sweeps: int = 1,
                 periodic: bool = False) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Yield the bfloat16 (red, black) planes of the (R, C) lattice after
    each of n_samples blocks of n_sweeps sweeps that follow n_burnin sweeps
    of burn-in (spins are exact in bfloat16)."""
    base = int(torch.randint(0, 2**30, (), generator=generator))
    red, black = split_checkerboard(lattice0.to(torch.bfloat16))

    def sweeps(i, red, black, n):
        return fused_sweeps(to_int32(base + i * SEED_STRIDE), red, black,
                            temperature, n, J=J, field=field, periodic=periodic)

    red, black = sweeps(0, red, black, n_burnin)
    for i in range(n_samples):
        red, black = sweeps(1 + i, red, black, n_sweeps)
        yield red, black


def sample_grid(generator: torch.Generator, lattice0: torch.Tensor, *,
                n_samples: int, temperature, J: float = 1.0, field: float = 0.0,
                n_burnin: int = 100, n_sweeps: int = 1,
                periodic: bool = False) -> torch.Tensor:
    """Checkerboard-Gibbs sample a (R, C) lattice; returns (n_samples, R, C)
    on lattice0's device, in its dtype."""
    chain = sample_chain(generator, lattice0, n_samples=n_samples,
                         temperature=temperature, J=J, field=field,
                         n_burnin=n_burnin, n_sweeps=n_sweeps, periodic=periodic)
    R, C = lattice0.shape
    out = torch.empty((n_samples, R, C), dtype=lattice0.dtype, device=lattice0.device)
    for i, (red, black) in enumerate(chain):
        out[i] = merge_checkerboard(red, black)
    return out


def sample_grid_ensemble(generator: torch.Generator, lattices0: torch.Tensor,
                         temperatures, *, n_samples: int, J: float = 1.0,
                         field: float = 0.0, n_burnin: int = 100,
                         n_sweeps: int = 1, periodic: bool = True) -> dict:
    """Sample an ensemble of (R, C) lattices, member b at temperature[b]:
    every sweep of every member is one batched fused-sweep launch.

    ``lattices0``: (B, R, C) initial spins (+-1) on the device that runs the
    ensemble. ``temperatures``: a scalar or (B,). Returns
    ``{"magnetization", "energy"}``, (n_samples, B) float64 tensors on that
    device: per-spin magnetization and total energy after each block of
    n_sweeps sweeps that follows n_burnin sweeps of burn-in.

    Member b's call i (burn-in is call 0, sample block i is call 1 + i)
    draws from the stream id seeds[b] + i * SEED_STRIDE, its in-call sweep
    counter starting at 0, as in the JAX package. The keys of every sweep and
    the tables go to the device once.
    """
    B, R, C = lattices0.shape
    device = lattices0.device
    seeds = torch.randint(0, 2**30, (B,), generator=generator).numpy()
    lengths = [n_burnin] + [n_sweeps] * n_samples
    calls = np.repeat(np.arange(len(lengths)), lengths)          # call of each sweep
    counters = np.concatenate([np.arange(n) for n in lengths])   # its in-call counter
    keys = sweep_keys(seeds + calls[:, None] * SEED_STRIDE, counters[:, None]).to(device)
    temps = torch.as_tensor(temperatures, dtype=torch.float32).cpu().reshape(-1)
    tables = sigmoid_table16(J, field, temps.broadcast_to((B,))).to(device)

    reds, blacks = split_checkerboard(lattices0.to(torch.bfloat16))
    ms = torch.empty((n_samples, B), dtype=torch.float64, device=device)
    es = torch.empty((n_samples, B), dtype=torch.float64, device=device)
    ends = np.cumsum(lengths)
    for i, (g, n) in enumerate(zip(ends - lengths, lengths)):
        reds, blacks = fused_sweeps_keyed(reds, blacks, tables, keys[g:g + n],
                                          periodic=periodic)
        if i == 0:
            continue
        ms[i - 1] = (reds.sum((-2, -1), dtype=torch.float64)
                     + blacks.sum((-2, -1), dtype=torch.float64)) / (R * C)
        es[i - 1] = plane_energy_batch(reds, blacks, J=J, field=field, periodic=periodic)
    return {"magnetization": ms, "energy": es}
