"""Stencil energy of the 2-D Ising lattice and the spin/bit maps.

Counterpart of ``tsu_tpu/energy.py:lattice_ising_energy``, ``spins_to_bits``
and ``bits_to_spins``. Sums are taken in float64: the bond sum of a 4096^2
lattice exceeds 2^24, where a float32 sum stops being exact.
"""

from __future__ import annotations

import torch

from tsu_tpu_torch.ops.checkerboard import lattice_energy_batch


def lattice_ising_energy(spins: torch.Tensor, J: float = 1.0, h: float = 0.0,
                         periodic: bool = True) -> torch.Tensor:
    """E = -J * sum_<ij> s_i s_j - h * sum_i s_i over right+down bonds,
    summed over every axis; a float64 scalar tensor."""
    return lattice_energy_batch(spins, J=J, field=h, periodic=periodic).sum()


def spins_to_bits(s: torch.Tensor) -> torch.Tensor:
    """{-1,+1} -> {0,1}."""
    return (s + 1.0) / 2.0


def bits_to_spins(b: torch.Tensor) -> torch.Tensor:
    """{0,1} -> {-1,+1}."""
    return 2.0 * b - 1.0
