"""tsu_tpu_torch — the PyTorch and CUDA port of tsu_tpu.

The port grows slice by slice beside the JAX package (see ROADMAP.md). It
imports torch, numpy and scipy, never JAX and never ``tsu_tpu``. Its hot
loops are CUDA kernels for Hopper built at first use: the fused checkerboard
sweep of one lattice, of a batch of lattices and of a shard; the bond
half-sweep of one lattice and of a batch of replicas; the resident
multi-sweep kernel (S sweeps in one launch); and the exact-sigmoid
half-sweep of a lattice or a shard. ``tsu_tpu_torch.parallel`` drives
sharded runs over a mesh of devices from one process. Dense Boltzmann
machines, Ising models on any graph and MAX-CUT sample and anneal on colour
sweeps replayed as CUDA graphs (``samplers/gibbs.py``), sparse graphs on
ELL arrays (``ops/sparse_ising.py``); ``checkpoint`` saves and resumes
long runs. Entry points run on
the card unless the caller passes ``device="cpu"``, which runs the plain
PyTorch versions.
"""

from tsu_tpu_torch.api import MaxCutProblem, OptimizationProblem, optimize
from tsu_tpu_torch.config import (
    ConfigurationError,
    GibbsConfig,
    IsingConfig,
    SamplingError,
    TSUError,
)
from tsu_tpu_torch.models.ising import (
    IsingChain,
    IsingGrid,
    IsingModel,
    demonstrate_phase_transition,
)
from tsu_tpu_torch.ops.checkerboard_resident import resident_anneal, resident_sweeps
from tsu_tpu_torch.parallel import (
    make_mesh,
    mesh_info,
    plan_lattice_mesh,
    sharded_checkerboard_sweeps,
    sharded_lattice_sample,
)
from tsu_tpu_torch.samplers import (
    GibbsSampler,
    anneal_spin_glass,
    build_tempering_ladder,
    parallel_tempering_bonds,
    pt_ground_state_search,
)

__all__ = [
    "ConfigurationError",
    "GibbsConfig",
    "GibbsSampler",
    "IsingChain",
    "IsingConfig",
    "IsingGrid",
    "IsingModel",
    "MaxCutProblem",
    "OptimizationProblem",
    "SamplingError",
    "TSUError",
    "anneal_spin_glass",
    "build_tempering_ladder",
    "demonstrate_phase_transition",
    "make_mesh",
    "mesh_info",
    "optimize",
    "parallel_tempering_bonds",
    "plan_lattice_mesh",
    "pt_ground_state_search",
    "resident_anneal",
    "resident_sweeps",
    "sharded_checkerboard_sweeps",
    "sharded_lattice_sample",
]
