"""2-D nearest-neighbour Ising grid, uniform or with per-bond couplings, and
the phase-transition scan.

Counterpart of ``tsu_tpu/models/ising.py:IsingGrid`` for even grids, and of
``demonstrate_phase_transition``. A uniform grid samples on the fused sweep;
a grid with bond planes (Jh, Jv), a random-bond lattice or a ±J spin glass,
samples on the bond half-sweep kernel and finds ground states with
``anneal_spin_glass``. Observables match the JAX package: M = <sum s>/N,
C = Var(E)/(T^2 N), chi = Var(m_per_spin) * N / T. Features of the JAX class
that later slices of the port bring raise ``NotImplementedError`` naming the
slice (see ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tsu_tpu_torch.config import ConfigurationError, IsingConfig, resolve_device
from tsu_tpu_torch.models.lattice_sampler import (
    sample_chain,
    sample_grid,
    sample_grid_ensemble,
    sample_lattice_bonds,
)
from tsu_tpu_torch.ops.checkerboard import lattice_energy_batch
from tsu_tpu_torch.ops.checkerboard_bonds import lattice_energy_bonds
from tsu_tpu_torch.rng import as_generator
from tsu_tpu_torch.samplers.annealing import anneal_lattice, anneal_spin_glass


def _not_ported(what: str, slice_: str):
    return NotImplementedError(
        f"{what} is not ported to tsu_tpu_torch yet ({slice_} of ROADMAP.md)")


class IsingGrid:
    """2-D nearest-neighbour grid on ``device`` (default
    ``torch.get_default_device()``): uniform coupling, sampled by the fused
    checkerboard sweep, or per-bond couplings ``bonds=(Jh, Jv)``, sampled by
    the bond half-sweep kernel. ``Jh[r, c]`` couples (r, c)-(r, c+1) and
    ``Jv[r, c]`` couples (r, c)-(r+1, c); the wrap entries count only when
    periodic.

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
        self.shape = (rows, cols)
        self.periodic = periodic
        self.coupling_strength = coupling_strength
        self.n_spins = rows * cols
        self.config = config or IsingConfig(coupling_strength=coupling_strength)
        self.device = resolve_device(device)
        self._gen = as_generator(seed)
        # Per-bond couplings: (Jh, Jv) float32 numpy planes, or None for the
        # uniform coupling_strength.
        self._Jh: Optional[np.ndarray] = None
        self._Jv: Optional[np.ndarray] = None
        if bonds is not None:
            self.set_bonds(*bonds)

    # -- bonds ----------------------------------------------------------------

    def set_bonds(self, Jh, Jv):
        """Set all horizontal and vertical bonds at once; each plane has the
        grid's shape."""
        Jh = np.asarray(Jh, dtype=np.float32)
        Jv = np.asarray(Jv, dtype=np.float32)
        if Jh.shape != self.shape or Jv.shape != self.shape:
            raise ConfigurationError(
                f"bond planes must have shape {self.shape}; got {Jh.shape} / {Jv.shape}")
        self._Jh, self._Jv = Jh.copy(), Jv.copy()

    def _bond_planes(self):
        """Current (Jh, Jv), made uniform planes on the first edit."""
        if self._Jh is None:
            self._Jh = np.full(self.shape, self.coupling_strength, np.float32)
            self._Jv = np.full(self.shape, self.coupling_strength, np.float32)
        return self._Jh, self._Jv

    def _neighbor_bond(self, i: int, j: int):
        """(plane, r, c) of the bond between flat sites i and j, or None when
        they are not lattice neighbours."""
        rows, cols = self.shape
        ri, ci = divmod(i, cols)
        rj, cj = divmod(j, cols)
        if ri == rj:
            dc = (cj - ci) % cols
            if dc == 1 or (self.periodic and dc == cols - 1):
                return ("h", ri, ci if dc == 1 else cj)
        if ci == cj:
            dr = (rj - ri) % rows
            if dr == 1 or (self.periodic and dr == rows - 1):
                return ("v", ri if dr == 1 else rj, ci)
        return None

    def set_coupling(self, i: int, j: int, strength: float):
        """Set the coupling of lattice neighbours i and j in the bond planes.
        Other pairs need a dense J (slice 4) and raise."""
        loc = self._neighbor_bond(i, j)
        if loc is None:
            raise _not_ported(
                f"set_coupling of sites {i} and {j}, which are not lattice neighbours "
                "(a dense J)", "slice 4")
        Jh, Jv = self._bond_planes()
        kind, r, c = loc
        (Jh if kind == "h" else Jv)[r, c] = strength

    # -- energetics / sampling -----------------------------------------------

    def _lattice(self, state) -> torch.Tensor:
        return torch.as_tensor(np.asarray(state), dtype=torch.float32).to(
            self.device).reshape((-1,) + self.shape)

    def energy(self, state: np.ndarray) -> float:
        """Energy of one flat or (rows, cols) state."""
        return float(self.energies(state)[0])

    def energies(self, samples: np.ndarray) -> np.ndarray:
        """Energies (float64) of a batch of flat or (rows, cols) states."""
        if self._Jh is not None:
            e = lattice_energy_bonds(self._lattice(samples), self._Jh, self._Jv, 0.0,
                                     periodic=self.periodic)
        else:
            e = lattice_energy_batch(self._lattice(samples), J=self.coupling_strength,
                                     field=0.0, periodic=self.periodic)
        return e.cpu().numpy()

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

    def _bond_chain_args(self, n_samples: int, temperature: Optional[float]) -> dict:
        args = self._chain_args(n_samples, temperature)
        del args["J"]
        return args

    def sample(self, n_samples: int = 100,
               initial_state: Optional[np.ndarray] = None,
               temperature: Optional[float] = None) -> np.ndarray:
        """Sample spin configurations; returns (n_samples, rows*cols) flat
        float32 spins."""
        lattice0 = self._initial_lattice(initial_state)
        if self._Jh is not None:
            states = sample_lattice_bonds(self._gen, lattice0, self._Jh, self._Jv,
                                          **self._bond_chain_args(n_samples, temperature))
        else:
            states = sample_grid(self._gen, lattice0, **self._chain_args(n_samples, temperature))
        return states.reshape(n_samples, -1).cpu().numpy()

    def sample_observables(self, n_samples: int = 100,
                           temperature: Optional[float] = None,
                           mesh=None) -> dict:
        """Per-sample magnetization (per spin) and total energy, without
        returning states; the lattice stays on the device."""
        if mesh is not None:
            raise _not_ported("sample_observables over a device mesh", "slice 6")
        if self._Jh is not None:
            out = sample_lattice_bonds(self._gen, self._initial_lattice(None), self._Jh,
                                       self._Jv, collect="observables",
                                       **self._bond_chain_args(n_samples, temperature))
            return {k: v.cpu().numpy() for k, v in out.items()}
        ms, es = [], []
        for lattice in sample_chain(self._gen, self._initial_lattice(None),
                                    **self._chain_args(n_samples, temperature)):
            ms.append(lattice.to(torch.float64).sum() / self.n_spins)
            es.append(lattice_energy_batch(lattice, J=self.coupling_strength,
                                           field=0.0, periodic=self.periodic))
        return {"magnetization": torch.stack(ms).cpu().numpy(),
                "energy": torch.stack(es).cpu().numpy()}

    def find_ground_state(self, n_steps: int = 1000) -> Tuple[np.ndarray, float]:
        """Anneal from T = 5.0 to 0.05 over n_steps sweeps; returns the best
        flat state (rows*cols float32) and its energy. A uniform grid anneals
        two chains (``anneal_lattice``), a grid with bonds one
        (``anneal_spin_glass``)."""
        if self._Jh is not None:
            best, e = anneal_spin_glass(self._gen, self._Jh, self._Jv, T_initial=5.0,
                                        T_final=0.05, n_steps=n_steps, periodic=self.periodic,
                                        device=self.device)
            return best.reshape(-1), e
        best, e = anneal_lattice(
            self._gen, self.shape, J=self.coupling_strength, T_initial=5.0,
            T_final=0.05, n_steps=n_steps, n_chains=2, periodic=self.periodic,
            device=self.device)
        return best.reshape(-1).cpu().numpy(), e

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


def demonstrate_phase_transition(sizes: Sequence[int] = (8, 16, 32),
                                 temperatures: Optional[np.ndarray] = None,
                                 n_samples: int = 64, seed: int = 0,
                                 ensemble: Optional[bool] = None,
                                 device=None) -> dict:
    """Scan temperature across T_c ~ 2.269 for several periodic grid sizes.

    Returns {size: {"temperatures", "magnetization", "susceptibility",
    "specific_heat"}}, numpy arrays over the temperatures. Below T_c a chain
    starts ordered (a random cold quench freezes into stripe states); above
    it, from random spins. ``ensemble`` (default on) runs all temperatures of
    a size as one ensemble, one batched launch per sweep
    (:func:`sample_grid_ensemble`); ``ensemble=False`` runs
    ``IsingGrid.sample`` once per temperature. Every even size takes the
    ensemble; odd sizes need the dense path (slice 4).
    """
    odd = [size for size in sizes if size % 2]
    if odd:
        raise _not_ported(f"odd grid sizes {odd} (dense path)", "slice 4")
    device = resolve_device(device)
    if temperatures is None:
        temperatures = np.linspace(0.5, 4.0, 15)
    T_c = 2.0 / np.log(1.0 + np.sqrt(2.0))
    Tn = np.asarray(temperatures, np.float64)
    results = {}
    for idx, size in enumerate(sizes):
        n_spins = size * size
        if ensemble is None or ensemble:
            gen = as_generator(seed + idx)
            Ts = torch.as_tensor(np.asarray(temperatures, np.float32))
            rand = torch.where(torch.rand((len(Ts), size, size), generator=gen) < 0.5, 1.0, -1.0)
            lat0 = torch.where((Ts < T_c)[:, None, None], 1.0, rand).to(device)
            out = sample_grid_ensemble(gen, lat0, Ts, n_samples=n_samples,
                                       n_burnin=200, n_sweeps=2, periodic=True)
            m = out["magnetization"].cpu().numpy()   # (n_samples, B), per spin
            e = out["energy"].cpu().numpy()          # (n_samples, B), total
            results[size] = {
                "temperatures": np.asarray(temperatures),
                "magnetization": np.abs(m.mean(axis=0)),
                "susceptibility": (m**2).mean(axis=0) * n_spins / Tn
                - m.mean(axis=0) ** 2 * n_spins / Tn,
                "specific_heat": ((e**2).mean(axis=0) - e.mean(axis=0) ** 2)
                / (Tn**2 * n_spins),
            }
            continue
        grid = IsingGrid((size, size), coupling_strength=1.0, periodic=True,
                         seed=seed + idx, device=device,
                         config=IsingConfig(n_burnin=200, n_sweeps=2))
        ordered = np.ones(n_spins, dtype=np.float32)
        mags, chis, cs = [], [], []
        for T in temperatures:
            samples = grid.sample(n_samples=n_samples, temperature=float(T),
                                  initial_state=ordered if T < T_c else None)
            mags.append(abs(grid.magnetization(samples)))
            chis.append(grid.susceptibility(samples, temperature=float(T)))
            cs.append(grid.specific_heat(samples, temperature=float(T)))
        results[size] = {
            "temperatures": np.asarray(temperatures),
            "magnetization": np.asarray(mags),
            "susceptibility": np.asarray(chis),
            "specific_heat": np.asarray(cs),
        }
    return results
