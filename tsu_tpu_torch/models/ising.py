"""Ising models: general graph (dense J), 1-D chain and 2-D grid, and the
phase-transition scan.

Counterpart of ``tsu_tpu/models/ising.py``. ``IsingModel`` and
``IsingChain`` sample spins through the bit model of
``energy.ising_to_boltzmann`` on the dense colour-sweep engine
(``samplers/gibbs.py``). ``IsingGrid`` on an even grid samples on the fused
sweep (uniform coupling) or the bond half-sweep kernel (bond planes, a
random-bond lattice or a ±J spin glass); an odd grid, or an even one given a
coupling between sites that are not lattice neighbours, falls back to the
dense engine (at most 4,096 spins). Observables match the JAX package: M =
<sum s>/N, C = Var(E)/(T^2 N), chi = Var(m_per_spin) * N / T; energies are
taken in float64 on the model's device. The plots (``visualize``) need
matplotlib and raise ``ImportError`` without it; ``compute_domains`` labels
a state on the host with ``scipy.ndimage``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tsu_tpu_torch import profiling
from tsu_tpu_torch.config import ConfigurationError, IsingConfig, SamplingError, resolve_device
from tsu_tpu_torch.energy import ising_to_boltzmann
from tsu_tpu_torch.models.lattice_sampler import (
    sample_chain,
    sample_grid,
    sample_grid_ensemble,
)
from tsu_tpu_torch.ops.checkerboard import lattice_energy_batch, merge_checkerboard
from tsu_tpu_torch.ops.checkerboard_bonds import lattice_energy_bonds, sample_lattice_bonds
from tsu_tpu_torch.ops.plane_observables import observables_scratch, plane_observables
from tsu_tpu_torch.parallel.lattice import MeshStart, sharded_lattice_sample
from tsu_tpu_torch.rng import as_generator
from tsu_tpu_torch.samplers.annealing import (
    anneal_lattice,
    anneal_spin_glass,
    simulated_annealing_dense,
)
from tsu_tpu_torch.samplers.gibbs import ColourPlan, dense_gibbs_sample

DENSE_LIMIT = 4096          # spins of the dense fall-back of a grid


class IsingModel:
    """General-graph Ising model with dense couplings on ``device`` (default
    the card): E(s) = -1/2 sum_ij J_ij s_i s_j - sum_i h_i s_i over
    s in {-1,+1}^n. ``set_coupling`` writes both (i, j) and (j, i).

    ``seed``: an int or a CPU ``torch.Generator``. Sampling returns numpy
    arrays of spins, (n_samples, n) float32.
    """

    def __init__(self, n_spins: int, config: Optional[IsingConfig] = None, seed=None,
                 device=None):
        if n_spins <= 0:
            raise ConfigurationError(f"n_spins must be positive, got {n_spins}")
        self.n_spins = n_spins
        self.config = config or IsingConfig()
        self.device = resolve_device(device)
        self._gen = as_generator(seed)
        self.J = np.zeros((n_spins, n_spins), dtype=np.float32)
        self.h = np.zeros(n_spins, dtype=np.float32)
        self._plan_of = None    # (J, h, ColourPlan) of the last bit model sampled

    # -- construction ---------------------------------------------------------

    def set_coupling(self, i: int, j: int, strength: float):
        """Set the symmetric coupling J_ij = J_ji = strength."""
        if not (0 <= i < self.n_spins and 0 <= j < self.n_spins):
            raise ConfigurationError(
                f"spin indices ({i},{j}) out of range for n_spins={self.n_spins}")
        if i == j:
            raise ConfigurationError("self-coupling J_ii is not allowed")
        self.J[i, j] = strength
        self.J[j, i] = strength

    def set_external_field(self, field):
        """Set the per-spin external field h."""
        field = np.asarray(field, dtype=np.float32)
        if field.shape != (self.n_spins,):
            raise ConfigurationError(
                f"field shape {field.shape} does not match n_spins={self.n_spins}")
        self.h = field

    # -- energetics -----------------------------------------------------------

    def energy(self, state) -> float:
        """E(s) = -1/2 s^T J s - h^T s of one state, in float64."""
        s = np.asarray(state, dtype=np.float64)
        if s.shape[-1] != self.n_spins:
            raise SamplingError(
                f"state length {s.shape[-1]} does not match n_spins={self.n_spins}")
        return float(-0.5 * s @ self.J.astype(np.float64) @ s - self.h.astype(np.float64) @ s)

    def energies(self, samples) -> np.ndarray:
        """Energies (float64) of a (n_samples, n) batch, computed on the
        model's device."""
        s = torch.as_tensor(np.asarray(samples), dtype=torch.float64).to(self.device)
        s = s.reshape(-1, self.n_spins)
        J = torch.from_numpy(self.J).to(self.device, torch.float64)
        h = torch.from_numpy(self.h).to(self.device, torch.float64)
        return (-0.5 * ((s @ J) * s).sum(1) - s @ h).cpu().numpy()

    # -- sampling -------------------------------------------------------------

    def _bit_plan(self) -> ColourPlan:
        """The colour plan of the bit model of the current (J, h), kept
        across calls while J and h stay the same."""
        if (self._plan_of is None or not np.array_equal(self._plan_of[0], self.J)
                or not np.array_equal(self._plan_of[1], self.h)):
            J_bit, h_bit = ising_to_boltzmann(self.J, self.h)
            self._plan_of = (self.J.copy(), self.h.copy(),
                             ColourPlan(J_bit, h_bit, device=self.device))
        return self._plan_of[2]

    def sample(self, n_samples: int = 100, initial_state=None,
               temperature: Optional[float] = None) -> np.ndarray:
        """Sample spin configurations; returns (n_samples, n_spins) float32
        in {-1,+1}, the chains interleaved round-robin. ``temperature``
        overrides the config without changing it."""
        T = self.config.temperature if temperature is None else temperature
        n_chains = self.config.n_chains
        per_chain = -(-n_samples // n_chains)
        if initial_state is not None:
            bits0 = (torch.as_tensor(np.asarray(initial_state, np.float32)).reshape(1, -1)
                     + 1.0) / 2.0
            bits0 = bits0.expand(n_chains, self.n_spins)
        else:
            bits0 = (torch.rand((n_chains, self.n_spins), generator=self._gen) < 0.5).float()
        J_bit, h_bit = ising_to_boltzmann(self.J, self.h)
        bits = dense_gibbs_sample(self._gen, J_bit, h_bit, bits0, n_samples=per_chain,
                                  temperature=T, n_burnin=self.config.n_burnin,
                                  n_sweeps=self.config.n_sweeps, device=self.device,
                                  plan=self._bit_plan())
        bits = bits.transpose(0, 1).reshape(-1, self.n_spins)[:n_samples]
        return (2.0 * bits - 1.0).cpu().numpy()

    # -- observables ----------------------------------------------------------

    def magnetization(self, samples) -> float:
        """M = <sum_i s_i> / N."""
        return float(np.mean(np.sum(samples, axis=1)) / self.n_spins)

    def specific_heat(self, samples, temperature: Optional[float] = None) -> float:
        """C = (<E^2> - <E>^2) / (T^2 N)."""
        T = self.config.temperature if temperature is None else temperature
        e = self.energies(samples)
        return float((np.mean(e**2) - np.mean(e) ** 2) / (T**2 * self.n_spins))

    def susceptibility(self, samples, temperature: Optional[float] = None) -> float:
        """chi = (<m^2> - <m>^2) N / T with m the per-spin magnetization."""
        T = self.config.temperature if temperature is None else temperature
        m = np.sum(samples, axis=1) / self.n_spins
        return float((np.mean(m**2) - np.mean(m) ** 2) * self.n_spins / T)

    def find_ground_state(self, n_steps: int = 1000) -> Tuple[np.ndarray, float]:
        """Simulated annealing from T = 5.0 to 0.01 over ``n_steps`` colour
        sweeps of max(n_chains, 4) chains on the model's device; returns (the
        best spins (n,) float32, their energy)."""
        J_bit, h_bit = ising_to_boltzmann(self.J, self.h)
        best_bits, _ = simulated_annealing_dense(
            self._gen, J_bit, h_bit, T_initial=5.0, T_final=0.01, n_steps=n_steps,
            n_chains=max(self.config.n_chains, 4), device=self.device)
        state = 2.0 * np.asarray(best_bits, np.float32) - 1.0
        return state, self.energy(state)


class IsingChain(IsingModel):
    """1-D nearest-neighbour chain, open: J couples i and i + 1."""

    def __init__(self, n_spins: int, J: float = 1.0, config: Optional[IsingConfig] = None,
                 seed=None, device=None):
        super().__init__(n_spins, config, seed, device)
        self.coupling_strength = J
        for i in range(n_spins - 1):
            self.set_coupling(i, i + 1, J)

    def visualize(self, state, title: str = "Ising Chain"):
        """Render the chain as coloured squares; returns a Figure."""
        from tsu_tpu_torch.visualization import pyplot

        _, plt = pyplot()
        fig, ax = plt.subplots(figsize=(max(6, self.n_spins * 0.3), 1.5))
        ax.imshow(np.asarray(state)[None, :], cmap="coolwarm", vmin=-1, vmax=1,
                  aspect="auto")
        ax.set_title(title)
        ax.set_yticks([])
        return fig


class IsingGrid(IsingModel):
    """2-D nearest-neighbour grid on ``device`` (default
    the card, ``"cuda"``): uniform coupling, sampled by the fused
    checkerboard sweep, or per-bond couplings ``bonds=(Jh, Jv)``, sampled by
    the bond half-sweep kernel. ``Jh[r, c]`` couples (r, c)-(r, c+1) and
    ``Jv[r, c]`` couples (r, c)-(r+1, c); the wrap entries count only when
    periodic.

    An odd grid runs on the dense engine of :class:`IsingModel` (at most
    4,096 spins; a periodic wrap is added only along a side longer than 2),
    and so does an even one after a ``set_coupling`` of two sites that are
    not lattice neighbours. Bond planes need an even grid, and do not mix
    with non-local couplings.

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
        self.shape = (rows, cols)
        self.periodic = periodic
        self.coupling_strength = coupling_strength
        self._fast = rows % 2 == 0 and cols % 2 == 0
        # Per-bond couplings: (Jh, Jv) float32 numpy planes, or None for the
        # uniform coupling_strength.
        self._Jh: Optional[np.ndarray] = None
        self._Jv: Optional[np.ndarray] = None
        if self._fast:
            # The stencil engines: no dense J.
            self.n_spins = rows * cols
            self.config = config or IsingConfig(coupling_strength=coupling_strength)
            self.device = resolve_device(device)
            self._gen = as_generator(seed)
            self.J = None
            # The stencil engines take no field: a read-only view of one zero,
            # so that a grid larger than the host's memory holds no array of
            # its size.
            self.h = np.broadcast_to(np.float32(0.0), (self.n_spins,))
            self._plan_of = None
            if bonds is not None:
                self.set_bonds(*bonds)
        else:
            if bonds is not None:
                raise ConfigurationError(
                    "per-bond arrays require even grid dimensions (checkerboard engine)")
            super().__init__(rows * cols, config, seed, device)
            self._build_dense()

    # -- bonds ----------------------------------------------------------------

    def set_bonds(self, Jh, Jv):
        """Set all horizontal and vertical bonds at once; each plane has the
        grid's shape. Needs an even grid on its stencil engine."""
        if not self._fast:
            raise ConfigurationError("per-bond arrays require even grid dimensions")
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
        """Set one coupling. Lattice neighbours of an even grid are edited in
        the bond planes, and the grid keeps its stencil engine. Other pairs
        move the grid to the dense engine: at most 4,096 spins, and not on a
        grid with bond planes."""
        if self._fast:
            loc = self._neighbor_bond(i, j)
            if loc is not None:
                Jh, Jv = self._bond_planes()
                kind, r, c = loc
                (Jh if kind == "h" else Jv)[r, c] = strength
                return
            if self.n_spins > DENSE_LIMIT:
                raise ConfigurationError(
                    f"sites {i} and {j} are not lattice neighbors; non-local couplings "
                    f"require the dense path, which is limited to {DENSE_LIMIT} spins "
                    f"(grid has {self.n_spins})")
            if self._Jh is not None:
                raise ConfigurationError(
                    "cannot mix per-bond planes with non-local couplings; build an "
                    "IsingModel with a dense J instead")
            self._fast = False
            self.J = np.zeros((self.n_spins, self.n_spins), dtype=np.float32)
            self.h = np.array(self.h, dtype=np.float32)   # a field set before is kept
            self._build_dense()
        super().set_coupling(i, j, strength)

    def _build_dense(self):
        """Dense J from the grid's stencil (the odd-grid fall-back)."""
        rows, cols = self.shape
        if rows * cols > DENSE_LIMIT:
            raise ConfigurationError(
                f"dense fallback limited to {DENSE_LIMIT} spins; use even grid dimensions "
                "for the stencil checkerboard path")
        J = self.coupling_strength
        for r in range(rows):
            for c in range(cols):
                i = r * cols + c
                if c + 1 < cols:
                    IsingModel.set_coupling(self, i, i + 1, J)
                elif self.periodic and cols > 2:
                    IsingModel.set_coupling(self, i, r * cols, J)
                if r + 1 < rows:
                    IsingModel.set_coupling(self, i, i + cols, J)
                elif self.periodic and rows > 2:
                    IsingModel.set_coupling(self, i, c, J)

    # -- energetics / sampling -----------------------------------------------

    def _lattice(self, state) -> torch.Tensor:
        return torch.as_tensor(np.asarray(state), dtype=torch.float32).to(
            self.device).reshape((-1,) + self.shape)

    def energy(self, state: np.ndarray) -> float:
        """Energy of one flat or (rows, cols) state."""
        if not self._fast:
            return super().energy(np.asarray(state).reshape(-1))
        return float(self.energies(state)[0])

    def energies(self, samples: np.ndarray) -> np.ndarray:
        """Energies (float64) of a batch of flat or (rows, cols) states."""
        if not self._fast:
            return super().energies(samples)
        if self._Jh is not None:
            e = lattice_energy_bonds(self._lattice(samples), self._Jh, self._Jv, 0.0,
                                     periodic=self.periodic)
        else:
            e = lattice_energy_batch(self._lattice(samples), J=self.coupling_strength,
                                     field=0.0, periodic=self.periodic)
        return e.cpu().numpy()

    def _initial_lattice(self, initial_state) -> torch.Tensor:
        with profiling.annotate("ising.initial_draw"):
            if initial_state is not None:
                return self._lattice(initial_state)[0]
            up = torch.rand(self.shape, generator=self._gen) < 0.5
            profiling.count("host_syncs")   # a copy in from pageable memory
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
        if not self._fast:
            return super().sample(n_samples, None if initial_state is None
                                  else np.asarray(initial_state).reshape(-1), temperature)
        lattice0 = self._initial_lattice(initial_state)
        if self._Jh is not None:
            states = sample_lattice_bonds(self._gen, lattice0, self._Jh, self._Jv,
                                          **self._bond_chain_args(n_samples, temperature))
        else:
            states = sample_grid(self._gen, lattice0, **self._chain_args(n_samples, temperature))
        return states.reshape(n_samples, -1).cpu().numpy()

    def sample_observables(self, n_samples: int = 100,
                           temperature: Optional[float] = None,
                           mesh=None, initial: Optional[str] = None,
                           final_rows=None, final_shards: bool = False) -> dict:
        """Per-sample magnetization (per spin) and total energy, without
        returning states; the lattice stays on the device.

        ``mesh`` (a :class:`~tsu_tpu_torch.parallel.Mesh`): shard a uniform
        grid over its ``row`` axis, and over its ``col`` axis too when that
        is larger than 1 (:func:`~tsu_tpu_torch.parallel.sharded_lattice_sample`);
        the shards live on the mesh's devices. A grid with bonds, or on the
        dense engine, ignores ``mesh``.

        ``initial="mesh"`` (a uniform grid with a ``mesh`` only) draws the
        random start on the mesh's devices, each shard its own rows, from one
        base drawn from the grid's generator and keyed by global coordinates
        (:class:`~tsu_tpu_torch.parallel.lattice.MeshStart`): the lattice is
        the same for any number of shards and never exists whole, so a
        lattice larger than one card runs. The default draws the start on
        the host. ``final_rows`` (with a ``mesh``): global rows of the final
        state to return too, as ``"final_rows"``, (red, black) numpy arrays
        of those rows of the compact planes. ``final_shards=True`` (with a
        ``mesh``): the final state's shards too, as ``"final_shards"``,
        {(i, j): (red, black)} on their devices; they hold the lattice's
        memory for as long as the caller keeps them.

        On one card a uniform grid's observables come from the sweep's
        planes, one K11 launch a sample (``ops/plane_observables.py``); on
        the CPU from the merged lattice (``lattice_energy_batch``). Both give
        the same float64 values, bit for bit."""
        if initial not in (None, "mesh"):
            raise ConfigurationError(f"initial must be None (the host) or 'mesh', got {initial!r}")
        sharded = mesh is not None and self._fast and self._Jh is None
        if (initial == "mesh" or final_rows is not None or final_shards) and not sharded:
            raise ConfigurationError("initial='mesh', final_rows and final_shards take a uniform "
                                     "even grid sharded on a mesh: pass mesh=")
        with profiling.annotate("ising.sample_observables"):
            return self._sample_observables(n_samples, temperature, mesh, initial == "mesh",
                                            final_rows, final_shards)

    def _sample_observables(self, n_samples, temperature, mesh, on_mesh=False,
                            final_rows=None, final_shards=False) -> dict:
        if not self._fast:
            samples = self.sample(n_samples, temperature=temperature)
            return {"magnetization": samples.mean(axis=1), "energy": self.energies(samples)}
        if self._Jh is not None:
            out = sample_lattice_bonds(self._gen, self._initial_lattice(None), self._Jh,
                                       self._Jv, collect="observables",
                                       **self._bond_chain_args(n_samples, temperature))
            return {k: v.cpu().numpy() for k, v in out.items()}
        if mesh is not None:
            start = (MeshStart(self.shape, int(torch.randint(0, 2**31 - 1, (),
                                                             generator=self._gen)))
                     if on_mesh else self._initial_lattice(None))
            out = sharded_lattice_sample(
                mesh, self._gen, start, col_axis="col" if mesh.shape["col"] > 1 else None,
                final_rows=final_rows, **self._chain_args(n_samples, temperature))
            got = {"magnetization": out["magnetization"].numpy(),
                   "energy": out["energy"].numpy()}
            if final_rows is not None:
                got["final_rows"] = tuple(p.float().numpy() for p in out["final_rows"])
            if final_shards:
                got["final_shards"] = out["shards"]
            return got
        lattice0 = self._initial_lattice(None)
        chain = sample_chain(self._gen, lattice0, **self._chain_args(n_samples, temperature))
        if lattice0.device.type == "cuda":
            m = torch.empty(n_samples, dtype=torch.float64, device=lattice0.device)
            e = torch.empty_like(m)
            scratch = observables_scratch((self.shape[0], self.shape[1] // 2), lattice0.device)
            for i, (red, black) in enumerate(chain):
                with profiling.annotate("ising.observables", lattice0.device):
                    plane_observables(red, black, m, e, i, scratch, J=self.coupling_strength,
                                      periodic=self.periodic)
                    profiling.count("observables.fused_samples")
        else:
            ms, es = [], []
            for red, black in chain:
                with profiling.annotate("ising.observables", lattice0.device):
                    lattice = merge_checkerboard(red, black).to(lattice0.dtype)
                    ms.append(lattice.to(torch.float64).sum() / self.n_spins)
                    es.append(lattice_energy_batch(lattice, J=self.coupling_strength,
                                                   field=0.0, periodic=self.periodic))
            m, e = torch.stack(ms), torch.stack(es)
        with profiling.annotate("ising.readout"):
            profiling.count("host_syncs", 2)   # the two series read back
            return {"magnetization": m.cpu().numpy(), "energy": e.cpu().numpy()}

    def find_ground_state(self, n_steps: int = 1000) -> Tuple[np.ndarray, float]:
        """Anneal from T = 5.0 to 0.05 over n_steps sweeps; returns the best
        flat state (rows*cols float32) and its energy. A uniform grid anneals
        two chains (``anneal_lattice``), a grid with bonds one
        (``anneal_spin_glass``), a grid on the dense engine max(n_chains, 4)
        (:meth:`IsingModel.find_ground_state`)."""
        if not self._fast:
            return super().find_ground_state(n_steps)
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

    def visualize(self, state, title: str = "Ising Grid", show_colorbar: bool = True):
        """Render a configuration as an image; returns a Figure."""
        from tsu_tpu_torch.visualization import pyplot

        _, plt = pyplot()
        fig, ax = plt.subplots(figsize=(5, 5))
        im = ax.imshow(np.asarray(state).reshape(self.shape), cmap="coolwarm", vmin=-1, vmax=1)
        ax.set_title(title)
        if show_colorbar:
            fig.colorbar(im, ax=ax)
        return fig

    def compute_domains(self, state) -> int:
        """Connected domains of aligned spins (4-connectivity, open edges),
        counted on the host."""
        from scipy import ndimage

        grid = np.asarray(state).reshape(self.shape)
        return int(sum(ndimage.label(grid == val)[1] for val in (-1.0, 1.0)))


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
    ensemble; an odd size samples per temperature on the dense engine.
    """
    device = resolve_device(device)
    if temperatures is None:
        temperatures = np.linspace(0.5, 4.0, 15)
    T_c = 2.0 / np.log(1.0 + np.sqrt(2.0))
    Tn = np.asarray(temperatures, np.float64)
    results = {}
    for idx, size in enumerate(sizes):
        n_spins = size * size
        if (ensemble is None or ensemble) and size % 2 == 0:
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
