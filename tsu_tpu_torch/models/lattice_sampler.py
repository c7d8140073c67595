"""Single-device lattice sampling entry: glue between IsingGrid and the
sweep kernels.

Counterpart of ``tsu_tpu/models/lattice_sampler.py``: ``sample_grid`` (one
lattice) and ``sample_grid_ensemble`` (B lattices, each at its own
temperature, one batched launch per sweep). Every even grid goes through the
fused sweep (the CUDA kernel for a lattice on the card, its plain version for
one on the CPU): the kernel takes any even R and C, so the JAX package's
streaming path for R % 8 != 0 and its XLA ensemble branch have no
counterpart here. ``sample_lattice_bonds``, the counterpart of
``tsu_tpu/ops/checkerboard_bonds.py:sample_lattice_bonds``, samples a lattice
with per-bond couplings on the bond half-sweep kernel.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from tsu_tpu_torch.ops.checkerboard import (
    merge_checkerboard,
    plane_energy_batch,
    split_checkerboard,
)
from tsu_tpu_torch.ops.checkerboard_bonds import color_bond_weights, lattice_energy_bonds_planes
from tsu_tpu_torch.ops.checkerboard_bonds_kernel import checkerboard_sweeps_bonds_kernel
from tsu_tpu_torch.ops.checkerboard_fused import (
    fused_sweeps,
    fused_sweeps_keyed,
    sigmoid_table16,
)
from tsu_tpu_torch.rng import sweep_keys, to_int32

# Per-call seed stride: burn-in is call 0, sample block i is call 1 + i, and
# each call restarts its in-call sweep counter.
SEED_STRIDE = 1_000_033


def sample_chain(generator: torch.Generator, lattice0: torch.Tensor, *,
                 n_samples: int, temperature, J: float = 1.0,
                 field: float = 0.0, n_burnin: int = 100, n_sweeps: int = 1,
                 periodic: bool = False) -> Iterator[torch.Tensor]:
    """Yield the (R, C) lattice, in lattice0's dtype, after each of n_samples
    blocks of n_sweeps sweeps that follow n_burnin sweeps of burn-in.

    The planes are kept in bfloat16 between sweeps (spins are exact in it).
    """
    base = int(torch.randint(0, 2**30, (), generator=generator))
    red, black = split_checkerboard(lattice0.to(torch.bfloat16))

    def sweeps(i, red, black, n):
        return fused_sweeps(to_int32(base + i * SEED_STRIDE), red, black,
                            temperature, n, J=J, field=field, periodic=periodic)

    red, black = sweeps(0, red, black, n_burnin)
    for i in range(n_samples):
        red, black = sweeps(1 + i, red, black, n_sweeps)
        yield merge_checkerboard(red, black).to(lattice0.dtype)


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
    for i, lattice in enumerate(chain):
        out[i] = lattice
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


def sample_lattice_bonds(generator: torch.Generator, lattice0: torch.Tensor, Jh, Jv, *,
                         n_samples: int, temperature, field=0.0, n_burnin: int = 100,
                         n_sweeps: int = 1, periodic: bool = True,
                         collect: str = "states"):
    """Boltzmann-sample a (R, C) lattice with per-bond couplings (Jh, Jv).

    Sampling runs the bond kernel's continuous mode (exact sigmoid against
    24-bit uniforms) on float32 planes, as the JAX package does; the
    threshold table is the annealers' business. Call i (burn-in is call 0,
    sample block i is call 1 + i) draws from the stream id
    base + i * SEED_STRIDE, with base drawn from ``generator``.
    collect="states": returns (n_samples, R, C) on lattice0's device, in
    its dtype. collect="observables": returns ``{"magnetization",
    "energy"}``, (n_samples,) float64 tensors, per-spin magnetization and
    total energy.
    """
    if collect not in ("states", "observables"):
        raise ValueError(f"collect must be 'states' or 'observables', got {collect!r}")
    device = lattice0.device
    weights = color_bond_weights(torch.as_tensor(Jh, dtype=torch.float32, device=device),
                                 torch.as_tensor(Jv, dtype=torch.float32, device=device),
                                 field, periodic)
    base = int(torch.randint(0, 2**30, (), generator=generator))
    red, black = split_checkerboard(lattice0.to(torch.float32))

    def sweeps(i, red, black, n):
        return checkerboard_sweeps_bonds_kernel(to_int32(base + i * SEED_STRIDE), red, black,
                                                weights, temperature, n, periodic=periodic)

    red, black = sweeps(0, red, black, n_burnin)
    R, C = lattice0.shape
    if collect == "states":
        out = torch.empty((n_samples, R, C), dtype=lattice0.dtype, device=device)
    else:
        ms = torch.empty(n_samples, dtype=torch.float64, device=device)
        es = torch.empty(n_samples, dtype=torch.float64, device=device)
    for i in range(n_samples):
        red, black = sweeps(1 + i, red, black, n_sweeps)
        if collect == "states":
            out[i] = merge_checkerboard(red, black)
        else:
            ms[i] = (red.sum(dtype=torch.float64) + black.sum(dtype=torch.float64)) / (R * C)
            es[i] = lattice_energy_bonds_planes(red, black, weights, periodic=periodic)
    return out if collect == "states" else {"magnetization": ms, "energy": es}
