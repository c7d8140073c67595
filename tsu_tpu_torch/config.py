"""Exception hierarchy, the validated, immutable Langevin, Gibbs and Ising
configurations and the device an entry point runs on.

The errors, ``TSUConfig``, ``GibbsConfig`` and ``IsingConfig`` are copied
from ``tsu_tpu/config.py``:
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
class TSUConfig:
    """Configuration for the Langevin sampling engine.

    Attributes:
        temperature: sampling temperature T > 0.
        dt: integrator step size, 0 < dt <= 0.1.
        friction: Langevin friction coefficient gamma > 0.
        n_burnin: burn-in steps discarded before the first sample.
        n_steps: integration steps between retained samples.
        n_chains: independent chains run in parallel.
        underdamped: use the underdamped (BAOAB) integrator; if False,
            overdamped Euler-Maruyama.
        mass: particle mass for the underdamped integrator.
    """

    temperature: float = 1.0
    dt: float = 0.01
    friction: float = 1.0
    n_burnin: int = 100
    n_steps: int = 1000
    n_chains: int = 1
    underdamped: bool = True
    mass: float = 1.0

    def __post_init__(self):
        _require(self.temperature > 0, f"temperature must be positive, got {self.temperature}")
        _require(0 < self.dt <= 0.1, f"dt must be in (0, 0.1], got {self.dt}")
        _require(self.friction > 0, f"friction must be positive, got {self.friction}")
        _require(self.n_burnin >= 0, f"n_burnin must be non-negative, got {self.n_burnin}")
        _require(self.n_steps > 0, f"n_steps must be positive, got {self.n_steps}")
        _require(self.n_chains > 0, f"n_chains must be positive, got {self.n_chains}")
        _require(self.mass > 0, f"mass must be positive, got {self.mass}")

    def replace(self, **kwargs) -> "TSUConfig":
        """Return a copy with fields replaced (configs are immutable)."""
        return dataclasses.replace(self, **kwargs)


@dataclass(frozen=True)
class GibbsConfig:
    """Configuration for dense Gibbs sampling.

    Attributes:
        temperature: sampling temperature T > 0.
        n_burnin: burn-in sweeps before the first retained sample.
        n_sweeps: sweeps between retained samples (thinning).
        update_order: "checkerboard" (default: graph-coloured block sweeps),
            "sequential" (sites one at a time in index order) or "random"
            (the site order drawn anew every sweep). All three have the
            same invariant distribution.
        n_chains: independent chains run in parallel.
    """

    temperature: float = 1.0
    n_burnin: int = 100
    n_sweeps: int = 10
    update_order: str = "checkerboard"
    n_chains: int = 1

    def __post_init__(self):
        _require(self.temperature > 0, f"temperature must be positive, got {self.temperature}")
        _require(self.n_burnin >= 0, f"n_burnin must be non-negative, got {self.n_burnin}")
        _require(self.n_sweeps > 0, f"n_sweeps must be positive, got {self.n_sweeps}")
        _require(
            self.update_order in ("checkerboard", "sequential", "random"),
            "update_order must be 'checkerboard', 'sequential' or "
            f"'random', got {self.update_order!r}",
        )
        _require(self.n_chains > 0, f"n_chains must be positive, got {self.n_chains}")

    def replace(self, **kwargs) -> "GibbsConfig":
        return dataclasses.replace(self, **kwargs)


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
    """``device`` as a torch.device. The default is the card,
    ``torch.device("cuda")``: the entry points run their kernels unless the
    caller asks for the plain path with ``device="cpu"``. Raises
    ``ConfigurationError`` if the device is a CUDA device that this process
    cannot use, the default included; there is no fall-back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise ConfigurationError(
            f"device {device} requested but CUDA is not available; pass device='cpu' "
            "for the plain PyTorch path")
    return device
