"""Exception hierarchy, the validated, immutable Ising configuration and the
device an entry point runs on.

The errors and ``IsingConfig`` are copied from ``tsu_tpu/config.py``:
importing that module runs ``tsu_tpu/__init__.py``, which imports JAX, so the
PyTorch port keeps its own copy.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


class TSUError(Exception):
    """Base exception for all tsu_tpu_torch errors."""


class ConfigurationError(TSUError):
    """Invalid configuration parameters."""


class SamplingError(TSUError):
    """Errors raised during sampling."""


def _require(cond: bool, msg: str):
    if not cond:
        raise ConfigurationError(msg)


@dataclass(frozen=True)
class IsingConfig:
    """Configuration for Ising model sampling."""

    temperature: float = 1.0
    n_burnin: int = 100
    n_sweeps: int = 10
    coupling_strength: float = 1.0
    n_chains: int = 1

    def __post_init__(self):
        _require(self.temperature > 0, f"temperature must be positive, got {self.temperature}")
        _require(self.n_burnin >= 0, f"n_burnin must be non-negative, got {self.n_burnin}")
        _require(self.n_sweeps > 0, f"n_sweeps must be positive, got {self.n_sweeps}")
        _require(self.n_chains > 0, f"n_chains must be positive, got {self.n_chains}")

    def replace(self, **kwargs) -> "IsingConfig":
        return dataclasses.replace(self, **kwargs)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device (default: torch.get_default_device());
    raises if it names a CUDA device that this process cannot use."""
    device = torch.device(device) if device is not None else torch.get_default_device()
    if device.type == "cuda" and not torch.cuda.is_available():
        raise ConfigurationError(f"device {device} requested but CUDA is not available")
    return device
