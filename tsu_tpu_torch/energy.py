"""Energies of the discrete models: the 2-D Ising lattice's stencil, dense
Ising and Boltzmann energies, and the spin/bit maps.

Counterpart of ``tsu_tpu/energy.py:lattice_ising_energy``, ``DenseIsing``,
``DenseBoltzmann``, ``spins_to_bits``, ``bits_to_spins`` and
``ising_to_boltzmann``. Lattice sums are taken in float64: the bond sum of a
4096^2 lattice exceeds 2^24, where a float32 sum stops being exact.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
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


def ising_to_boltzmann(J, h):
    """Spin-model (J, h) as the bit-model (J_bit, h_bit) with the same Gibbs
    conditionals. With s = 2b - 1,
        E(s) = -1/2 s^T J s - h^T s = -2 b^T J b + 2 (rowsum J - h)^T b + const,
    so J_bit = 4 J and h_bit = 2 h - 2 rowsum(J). Numpy in, numpy out;
    tensors in, tensors out."""
    if isinstance(J, torch.Tensor) or isinstance(h, torch.Tensor):
        J, h = torch.as_tensor(J), torch.as_tensor(h)
        return 4.0 * J, 2.0 * h - 2.0 * J.sum(dim=1)
    J = np.asarray(J)
    return 4.0 * J, 2.0 * np.asarray(h) - 2.0 * np.sum(J, axis=1)


def _quadratic(x: torch.Tensor, J: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """-1/2 x^T J x - h^T x over the last axis of x."""
    return -0.5 * ((x @ J) * x).sum(-1) - x @ h


@dataclass(frozen=True)
class DenseIsing:
    """Dense-coupling Ising energy over spins s in {-1,+1}^n:
    E(s) = -1/2 s^T J s - h^T s, for one state (n,) or a batch (..., n)."""

    J: torch.Tensor
    h: torch.Tensor

    def __call__(self, s: torch.Tensor) -> torch.Tensor:
        return _quadratic(s, torch.as_tensor(self.J), torch.as_tensor(self.h))


@dataclass(frozen=True)
class DenseBoltzmann:
    """Binary Boltzmann energy over bits b in {0,1}^n:
    E(b) = -1/2 b^T J b - h^T b, the Gibbs sampler's convention,
    P(b_i = 1 | rest) = sigmoid(((J b)_i - J_ii b_i + h_i) / T)."""

    J: torch.Tensor
    h: torch.Tensor

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return _quadratic(b, torch.as_tensor(self.J), torch.as_tensor(self.h))
