"""tsu_tpu_torch — the PyTorch and CUDA port of tsu_tpu.

The port grows slice by slice beside the JAX package (see ROADMAP.md). It
imports torch and numpy, never JAX and never ``tsu_tpu``. Its hot loops, the
fused checkerboard sweep of one lattice and of a batch of lattices, are CUDA
kernels for Hopper built at first use.
"""

from tsu_tpu_torch.config import (
    ConfigurationError,
    IsingConfig,
    SamplingError,
    TSUError,
)
from tsu_tpu_torch.models.ising import IsingGrid, demonstrate_phase_transition

__all__ = [
    "ConfigurationError",
    "IsingConfig",
    "IsingGrid",
    "SamplingError",
    "TSUError",
    "demonstrate_phase_transition",
]
