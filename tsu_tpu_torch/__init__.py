"""tsu_tpu_torch — the PyTorch and CUDA port of tsu_tpu.

The port grows slice by slice beside the JAX package (see ROADMAP.md). It
imports torch, numpy and scipy, never JAX and never ``tsu_tpu``. Its hot
loops, the fused checkerboard sweep of one lattice and of a batch of
lattices and the bond half-sweep of one lattice and of a batch of replicas,
are CUDA kernels for Hopper built at first use.
"""

from tsu_tpu_torch.config import (
    ConfigurationError,
    IsingConfig,
    SamplingError,
    TSUError,
)
from tsu_tpu_torch.models.ising import IsingGrid, demonstrate_phase_transition
from tsu_tpu_torch.samplers import (
    anneal_spin_glass,
    build_tempering_ladder,
    parallel_tempering_bonds,
    pt_ground_state_search,
)

__all__ = [
    "ConfigurationError",
    "IsingConfig",
    "IsingGrid",
    "SamplingError",
    "TSUError",
    "anneal_spin_glass",
    "build_tempering_ladder",
    "demonstrate_phase_transition",
    "parallel_tempering_bonds",
    "pt_ground_state_search",
]
