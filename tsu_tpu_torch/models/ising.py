"""2-D nearest-neighbour Ising grid with uniform coupling, on the fused sweep.

Counterpart of ``tsu_tpu/models/ising.py:IsingGrid`` for even grids with a
uniform coupling. Observables match the JAX package: M = <sum s>/N,
C = Var(E)/(T^2 N), chi = Var(m_per_spin) * N / T. Features of the JAX class
that later slices of the port bring raise ``NotImplementedError`` naming the
slice (see ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tsu_tpu_torch.config import ConfigurationError, IsingConfig
from tsu_tpu_torch.models.lattice_sampler import sample_chain, sample_grid
from tsu_tpu_torch.ops.checkerboard import lattice_energy_batch
from tsu_tpu_torch.rng import as_generator


def _not_ported(what: str, slice_: str):
    return NotImplementedError(
        f"{what} is not ported to tsu_tpu_torch yet ({slice_} of ROADMAP.md)")


def _resolve_device(device) -> torch.device:
    """``device`` as a torch.device (default: torch.get_default_device());
    raises if it names a CUDA device that this process cannot use."""
    device = torch.device(device) if device is not None else torch.get_default_device()
    if device.type == "cuda" and not torch.cuda.is_available():
        raise ConfigurationError(f"device {device} requested but CUDA is not available")
    return device


class IsingGrid:
    """2-D nearest-neighbour grid with uniform coupling, sampled by the fused
    checkerboard sweep on ``device`` (default ``torch.get_default_device()``).

    Sampling returns numpy arrays of flat states, (n_samples, rows*cols),
    as the JAX package does.
    """

    def __init__(
        self,
        shape: Tuple[int, int],
        coupling_strength: float = 1.0,
        config: Optional[IsingConfig] = None,
        periodic: bool = False,
        seed: Optional[int] = None,
        device=None,
        bonds=None,
    ):
        rows, cols = shape
        if rows <= 0 or cols <= 0:
            raise ConfigurationError(f"grid shape must be positive, got {shape}")
        if rows % 2 or cols % 2:
            raise _not_ported("an odd-sized grid (dense path)", "slice 4")
        if bonds is not None:
            raise _not_ported("per-bond couplings", "slice 3")
        self.shape = (rows, cols)
        self.periodic = periodic
        self.coupling_strength = coupling_strength
        self.n_spins = rows * cols
        self.config = config or IsingConfig(coupling_strength=coupling_strength)
        self.device = _resolve_device(device)
        self._gen = as_generator(seed)

    # -- features of later slices -------------------------------------------

    def set_bonds(self, Jh, Jv):
        raise _not_ported("per-bond couplings", "slice 3")

    def set_coupling(self, i: int, j: int, strength: float):
        raise _not_ported(
            "set_coupling (bond planes for lattice neighbours, a dense J "
            "otherwise)", "slices 3 and 4")

    def find_ground_state(self, n_steps: int = 1000):
        raise _not_ported("find_ground_state (anneal_lattice)", "slice 2")

    # -- energetics / sampling -----------------------------------------------

    def _lattice(self, state) -> torch.Tensor:
        return torch.as_tensor(np.asarray(state), dtype=torch.float32).to(
            self.device).reshape((-1,) + self.shape)

    def energy(self, state: np.ndarray) -> float:
        """Energy of one flat or (rows, cols) state."""
        return float(self.energies(state)[0])

    def energies(self, samples: np.ndarray) -> np.ndarray:
        """Energies (float64) of a batch of flat or (rows, cols) states."""
        return lattice_energy_batch(
            self._lattice(samples), J=self.coupling_strength, field=0.0,
            periodic=self.periodic).cpu().numpy()

    def _initial_lattice(self, initial_state) -> torch.Tensor:
        if initial_state is not None:
            return self._lattice(initial_state)[0]
        up = torch.rand(self.shape, generator=self._gen) < 0.5
        return torch.where(up, 1.0, -1.0).to(self.device)

    def _chain_args(self, n_samples: int, temperature: Optional[float]) -> dict:
        return dict(
            n_samples=n_samples,
            temperature=self.config.temperature if temperature is None else temperature,
            J=self.coupling_strength, n_burnin=self.config.n_burnin,
            n_sweeps=self.config.n_sweeps, periodic=self.periodic)

    def sample(self, n_samples: int = 100,
               initial_state: Optional[np.ndarray] = None,
               temperature: Optional[float] = None) -> np.ndarray:
        """Sample spin configurations; returns (n_samples, rows*cols) flat
        float32 spins."""
        states = sample_grid(self._gen, self._initial_lattice(initial_state),
                             **self._chain_args(n_samples, temperature))
        return states.reshape(n_samples, -1).cpu().numpy()

    def sample_observables(self, n_samples: int = 100,
                           temperature: Optional[float] = None,
                           mesh=None) -> dict:
        """Per-sample magnetization (per spin) and total energy, without
        returning states; the lattice stays on the device."""
        if mesh is not None:
            raise _not_ported("sample_observables over a device mesh", "slice 6")
        ms, es = [], []
        for lattice in sample_chain(self._gen, self._initial_lattice(None),
                                    **self._chain_args(n_samples, temperature)):
            ms.append(lattice.to(torch.float64).sum() / self.n_spins)
            es.append(lattice_energy_batch(lattice, J=self.coupling_strength,
                                           field=0.0, periodic=self.periodic))
        return {"magnetization": torch.stack(ms).cpu().numpy(),
                "energy": torch.stack(es).cpu().numpy()}

    # -- observables ----------------------------------------------------------

    def magnetization(self, samples: np.ndarray) -> float:
        """M = <sum_i s_i> / N."""
        return float(np.mean(np.sum(samples, axis=1)) / self.n_spins)

    def specific_heat(self, samples: np.ndarray,
                      temperature: Optional[float] = None) -> float:
        """C = (<E^2> - <E>^2) / (T^2 N)."""
        T = self.config.temperature if temperature is None else temperature
        e = self.energies(samples)
        return float((np.mean(e**2) - np.mean(e) ** 2) / (T**2 * self.n_spins))

    def susceptibility(self, samples: np.ndarray,
                       temperature: Optional[float] = None) -> float:
        """chi = (<m^2> - <m>^2) N / T with m the per-spin magnetization."""
        T = self.config.temperature if temperature is None else temperature
        m = np.sum(samples, axis=1) / self.n_spins
        return float((np.mean(m**2) - np.mean(m) ** 2) * self.n_spins / T)
