"""Energy models: the continuous energies the Langevin, MALA, HMC, NUTS,
SMC and VI samplers consume, the 2-D Ising lattice's stencil, dense Ising
and Boltzmann energies, and the spin/bit maps.

Counterpart of ``tsu_tpu/energy.py``. A continuous energy is a function
``energy(x) -> scalar`` of ONE float32 state ``x`` of shape (dim,), written
with torch operations: the samplers batch it over chains with
``torch.func.vmap`` and differentiate it with ``torch.func.grad``, as the
reference takes ``jax.grad`` of a ``(dim,) -> scalar`` energy. It is the
negative unnormalized log-density at temperature 1:
p(x) ∝ exp(-energy(x) / T). The built-ins keep their constant tensors on
each device they meet (made at the first call there, never inside a CUDA
graph's capture). Lattice sums are taken in float64: the bond sum of a
4096^2 lattice exceeds 2^24, where a float32 sum stops being exact.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from tsu_tpu_torch.config import SamplingError
from tsu_tpu_torch.ops.checkerboard import lattice_energy_batch

EnergyFn = Callable[[torch.Tensor], torch.Tensor]

# The port's copy of the activation table of tsu_tpu/models/ml.py.
ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


def validate_energy_fn(energy_fn: EnergyFn, x0) -> None:
    """Probe an energy function once on ``x0`` (float32).

    Raises SamplingError if the call fails or returns a non-scalar.
    """
    x0 = torch.as_tensor(x0).to(torch.float32)
    try:
        out = energy_fn(x0)
    except Exception as e:  # noqa: BLE001 - surface any failure of the user's energy
        raise SamplingError(
            f"energy function failed tracing on x0 of shape {tuple(x0.shape)}: {e}"
        ) from e
    shape = tuple(torch.as_tensor(out).shape)
    if shape not in ((), (1,)):
        raise SamplingError(f"energy function must return a scalar, got shape {shape}")


def _constants(cache: dict, x: torch.Tensor, make):
    """``make(device, dtype)``'s tensors for x's device and dtype, made once."""
    key = (x.device, x.dtype)
    if key not in cache:
        cache[key] = make(x.device, x.dtype)
    return cache[key]


@dataclass(frozen=True)
class Quadratic:
    """Gaussian energy E(x) = sum((x - mu)^2) / (2 sigma^2), over every
    dimension."""

    mu: float = 0.0
    sigma: float = 1.0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum((x - self.mu) ** 2) / (2.0 * self.sigma**2)


@dataclass(frozen=True)
class MixtureOfGaussians:
    """Energy of a K-mode isotropic Gaussian mixture,
    E(x) = -log sum_k w_k exp(-|x - m_k|^2 / (2 s_k^2)), computed stably."""

    modes: tuple  # tuple of mode centers, each a (dim,) tuple or float
    sigmas: tuple
    weights: Optional[tuple] = None
    _cache: dict = field(default_factory=dict, init=False, repr=False, compare=False,
                         hash=False)

    def _tensors(self, device, dtype):
        modes = torch.as_tensor(self.modes, dtype=dtype).to(device)
        if modes.dim() == 1:
            modes = modes[:, None]
        sigmas = torch.as_tensor(self.sigmas, dtype=dtype).to(device)
        w = (torch.as_tensor(self.weights, dtype=dtype).to(device) if self.weights is not None
             else torch.ones((modes.shape[0],), dtype=dtype, device=device) / modes.shape[0])
        return modes, sigmas, torch.log(w)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        modes, sigmas, log_w = _constants(self._cache, x, self._tensors)
        sq = torch.sum((x[None, :] - modes) ** 2, dim=-1)
        return -torch.logsumexp(log_w - sq / (2.0 * sigmas**2), dim=0)


@dataclass(frozen=True, eq=False)
class BNNPosterior:
    """Negative log posterior of an MLP regressor over a FLAT weight vector:

        E(theta) = sum((f(x; theta) - y)^2) / (2 noise_std^2)
                 + sum(theta^2) / (2 prior_std^2)

    The flat layout is the reference's: per layer (d_in, d_out), the weights
    row-major, then the biases. ``x`` (N, d_in) and ``y`` (N, d_out) are
    numpy arrays or tensors, held as float32 on each device the energy meets.
    ``eq=False``: instances hash by identity.
    """

    x: object                     # (N, d_in)
    y: object                     # (N, d_out)
    sizes: tuple                  # (d_in, hidden..., d_out)
    activation: str = "relu"
    prior_std: float = 1.0
    noise_std: float = 0.1
    _cache: dict = field(default_factory=dict, init=False, repr=False)

    @property
    def dim(self) -> int:
        """Total number of parameters in the flat vector."""
        return sum((a + 1) * b for a, b in zip(self.sizes[:-1], self.sizes[1:]))

    def unflatten(self, theta: torch.Tensor):
        """Flat (dim,) vector -> list of {"w": (a, b), "b": (b,)} layers."""
        layers = []
        off = 0
        for a, b in zip(self.sizes[:-1], self.sizes[1:]):
            w = theta[off:off + a * b].reshape(a, b)
            off += a * b
            bias = theta[off:off + b]
            off += b
            layers.append({"w": w, "b": bias})
        return layers

    def forward(self, theta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        act = ACTIVATIONS[self.activation]
        h = x
        layers = self.unflatten(theta)
        for i, layer in enumerate(layers):
            h = h @ layer["w"] + layer["b"]
            if i < len(layers) - 1:
                h = act(h)
        return h

    def _data(self, device, dtype):
        return (torch.as_tensor(np.asarray(self.x) if not isinstance(self.x, torch.Tensor)
                                else self.x).to(device=device, dtype=dtype),
                torch.as_tensor(np.asarray(self.y) if not isinstance(self.y, torch.Tensor)
                                else self.y).to(device=device, dtype=dtype))

    def __call__(self, theta: torch.Tensor) -> torch.Tensor:
        x, y = _constants(self._cache, theta, self._data)
        resid = self.forward(theta, x) - y
        nll = torch.sum(resid**2) / (2.0 * self.noise_std**2)
        prior = torch.sum(theta**2) / (2.0 * self.prior_std**2)
        return nll + prior


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
