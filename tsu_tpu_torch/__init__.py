"""tsu_tpu_torch — the PyTorch and CUDA port of tsu_tpu.

The port grows slice by slice beside the JAX package (see ROADMAP.md). It
imports torch and numpy, never JAX and never ``tsu_tpu``. Its hot loop, the
fused checkerboard sweep, is a CUDA kernel for Hopper built at first use.
"""

from tsu_tpu_torch.config import (
    ConfigurationError,
    IsingConfig,
    SamplingError,
    TSUError,
)
from tsu_tpu_torch.models.ising import IsingGrid

__all__ = [
    "ConfigurationError",
    "IsingConfig",
    "IsingGrid",
    "SamplingError",
    "TSUError",
]
