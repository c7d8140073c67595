"""Single-device lattice sampling entry: glue between IsingGrid and the fused
sweep.

Counterpart of ``tsu_tpu/models/lattice_sampler.py:sample_grid``. Every even
grid goes through the fused sweep (the CUDA kernel for a lattice on the card,
its plain version for one on the CPU): the kernel takes any even R and C, so
the JAX package's streaming path for R % 8 != 0 has no counterpart here.
"""

from __future__ import annotations

from typing import Iterator

import torch

from tsu_tpu_torch.ops.checkerboard import merge_checkerboard, split_checkerboard
from tsu_tpu_torch.ops.checkerboard_fused import fused_sweeps
from tsu_tpu_torch.rng import to_int32

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
