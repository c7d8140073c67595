"""High-level sampling and optimization API.

Counterpart of the sampler and optimization parts of ``tsu_tpu/api.py``:
``Sampler`` and its Gaussian, mixture and Bayesian-regression samplers on
the Langevin engine (``ThermalSamplingUnit``), the functional
``sample_gaussian`` / ``sample_multimodal`` / ``compare_samplers``, and
``OptimizationProblem``, ``MaxCutProblem`` and ``optimize``, and the
probabilistic-layer half: ``ProbabilisticLayer``, ``StochasticLinear``,
``BernoulliActivation`` and the Keras-like ``ProbabilisticModel``, numpy in
and numpy out, their noise drawn on the layer's device.

``Backend`` names the port's targets: the CPU and the card. The reference's
TPU members are aliases of the card; asking for the card without CUDA
raises ``ConfigurationError``. ``optimize`` anneals a problem with
``to_ising`` on its bit model (``simulated_annealing_dense``; an int seed
lets a small problem take the native host loop) and any other problem by
annealed Langevin dynamics on its objective, which must be written with
torch operations so that ``torch.func.grad`` can differentiate it.
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional

import numpy as np
import torch
from torch.func import grad

from tsu_tpu_torch.config import ConfigurationError, TSUConfig, resolve_device
from tsu_tpu_torch.core import ThermalSamplingUnit
from tsu_tpu_torch.energy import MixtureOfGaussians, Quadratic, ising_to_boltzmann
from tsu_tpu_torch.rng import as_generator, device_generator
from tsu_tpu_torch.samplers.annealing import simulated_annealing_dense
from tsu_tpu_torch.samplers.langevin import run_langevin
from tsu_tpu_torch.samplers.loop import Draws


class Backend(Enum):
    """Execution targets. EMULATOR is the default device (the card); the
    reference's TPU and TPU_POD are aliases of CUDA, one card."""

    CPU = "cpu"
    CUDA = "cuda"
    EMULATOR = "emulator"
    TPU = "cuda"
    TPU_POD = "cuda"


@dataclass
class SamplingResult:
    """Samples + metadata."""

    samples: np.ndarray
    n_samples: int
    time_elapsed: float
    backend: Backend
    metadata: dict = field(default_factory=dict)


class Sampler(ABC):
    """Abstract sampler with timing metadata, on the Langevin engine."""

    def __init__(self, backend: Backend = Backend.EMULATOR, config: Optional[TSUConfig] = None,
                 seed=None):
        if backend is Backend.CUDA and not torch.cuda.is_available():
            raise ConfigurationError(
                f"backend {backend} requested but torch.cuda.is_available() is false")
        self.backend = backend
        self.device = resolve_device("cpu" if backend is Backend.CPU else None)
        self.config = config or TSUConfig(n_chains=16, n_burnin=200, n_steps=200)
        self.tsu = ThermalSamplingUnit(self.config, seed=seed, device=self.device)
        self._compiled_shapes: set = set()

    @abstractmethod
    def energy_function(self, x: torch.Tensor) -> torch.Tensor:
        """Scalar energy of one state, in torch operations."""

    def _get_initial_state(self) -> np.ndarray:
        return np.zeros(1, dtype=np.float32)

    def sample(self, n_samples: int = 1000, return_metadata: bool = True, *,
               n: Optional[int] = None):
        """Draw ``n_samples`` samples (``n`` is an alias).

        Returns a :class:`SamplingResult` by default; ``return_metadata=False``
        returns the bare (n_samples, dim) array. ``metadata["includes_compile"]``
        marks the first call of this instance with a sample count: it may
        include the capture of the step loop's CUDA graphs (a per-instance
        heuristic, as the graphs are cached per energy and shape).
        """
        if n is not None:
            n_samples = n
        first_call = n_samples not in self._compiled_shapes
        start = time.perf_counter()
        samples = self.tsu.sample_from_energy(self.energy_function, self._get_initial_state(),
                                              n_samples)
        elapsed = time.perf_counter() - start
        self._compiled_shapes.add(n_samples)
        if not return_metadata:
            return np.asarray(samples)
        return SamplingResult(
            samples=samples, n_samples=n_samples, time_elapsed=elapsed, backend=self.backend,
            metadata={
                "samples_per_second": n_samples / elapsed if elapsed > 0 else float("inf"),
                "device": (torch.cuda.get_device_name(self.device)
                           if self.device.type == "cuda" else "cpu"),
                "n_chains": self.config.n_chains,
                "includes_compile": first_call,
                "route": self.tsu.last_route,
            })


class GaussianSampler(Sampler):
    """N(mu, sigma) sampling via the Langevin engine."""

    def __init__(self, mu: float = 0.0, sigma: float = 1.0, **kwargs):
        if sigma <= 0:
            raise ConfigurationError(f"sigma must be positive, got {sigma}")
        super().__init__(**kwargs)
        self.mu = mu
        self.sigma = sigma
        self._energy = Quadratic(mu, sigma)

    def energy_function(self, x):
        return self._energy(x)

    def _get_initial_state(self):
        return np.array([self.mu], dtype=np.float32)


class MultimodalSampler(Sampler):
    """Gaussian-mixture sampling."""

    def __init__(self, modes: List[float] = (-2.0, 2.0), sigmas: List[float] = (0.5, 0.5),
                 weights: Optional[List[float]] = None, **kwargs):
        super().__init__(**kwargs)
        if len(modes) != len(sigmas):
            raise ConfigurationError("modes and sigmas must have equal length")
        self.modes = tuple(float(m) for m in modes)
        self.sigmas = tuple(float(s) for s in sigmas)
        self.weights = tuple(weights) if weights is not None else None
        self._energy = MixtureOfGaussians(self.modes, self.sigmas, self.weights)

    def energy_function(self, x):
        return self._energy(x)

    def _get_initial_state(self):
        return np.array([float(np.mean(self.modes))], dtype=np.float32)


class BayesianSampler(Sampler):
    """Posterior sampling for Bayesian linear regression:
    E(theta) = |y - X theta|^2 / (2 s^2) + |theta|^2 / (2 prior_std^2)."""

    def __init__(self, X, y, noise_std: float = 0.1, prior_std: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.X = torch.as_tensor(np.atleast_2d(np.asarray(X, np.float32))).to(self.device)
        self.y = torch.as_tensor(np.asarray(y, np.float32).ravel()).to(self.device)
        if self.X.shape[0] != self.y.shape[0]:
            raise ConfigurationError("X and y must have matching first dimension")
        self.noise_std = noise_std
        self.prior_std = prior_std

    def energy_function(self, theta):
        resid = self.y - self.X @ theta
        nll = torch.sum(resid**2) / (2.0 * self.noise_std**2)
        prior = torch.sum(theta**2) / (2.0 * self.prior_std**2)
        return nll + prior

    def _get_initial_state(self):
        return np.zeros(self.X.shape[1], dtype=np.float32)


def sample_gaussian(mu: float = 0.0, sigma: float = 1.0, n_samples: int = 1000, *,
                    n: Optional[int] = None, **kwargs) -> np.ndarray:
    """Functional Gaussian sampling; ``n`` is an alias for ``n_samples``
    and ``kwargs`` go to :class:`GaussianSampler`."""
    if n is not None:
        n_samples = n
    return GaussianSampler(mu, sigma, **kwargs).sample(n_samples).samples.ravel()


def sample_multimodal(modes: List[float] = (-2.0, 2.0), sigmas: List[float] = (0.5, 0.5),
                      n_samples: int = 1000, *, n: Optional[int] = None,
                      centers: Optional[List[float]] = None, **kwargs) -> np.ndarray:
    """Functional mixture sampling; ``n`` and ``centers`` are aliases for
    ``n_samples`` and ``modes`` (sigmas of 0.5 when their count differs)."""
    if n is not None:
        n_samples = n
    if centers is not None:
        modes = centers
        if len(sigmas) != len(modes):
            sigmas = [0.5] * len(modes)
    return MultimodalSampler(modes, sigmas, **kwargs).sample(n_samples).samples.ravel()


def compare_samplers(n_samples: int = 1000, **kwargs) -> dict:
    """The engine's N(0, 1) samples beside direct NumPy sampling and a
    random-walk Metropolis-Hastings chain; ``kwargs`` go to
    :func:`sample_gaussian`."""
    out = {}
    t0 = time.perf_counter()
    s = sample_gaussian(0.0, 1.0, n_samples, **kwargs)
    out["tsu"] = {"time": time.perf_counter() - t0, "mean": float(np.mean(s)),
                  "std": float(np.std(s))}
    t0 = time.perf_counter()
    s = np.random.normal(0.0, 1.0, n_samples)
    out["direct"] = {"time": time.perf_counter() - t0, "mean": float(np.mean(s)),
                     "std": float(np.std(s))}
    t0 = time.perf_counter()
    x, samples = 0.0, []
    rng = np.random.default_rng(0)
    for _ in range(n_samples):
        prop = x + rng.normal(0, 0.5)
        if np.log(rng.random()) < (x**2 - prop**2) / 2.0:
            x = prop
        samples.append(x)
    out["mcmc"] = {"time": time.perf_counter() - t0, "mean": float(np.mean(samples)),
                   "std": float(np.std(samples))}
    return out


class OptimizationProblem(ABC):
    """An optimization problem: minimize ``objective`` over ``dimension``
    variables."""

    @abstractmethod
    def objective(self, x: np.ndarray) -> float:
        """Objective to minimize."""

    @property
    @abstractmethod
    def dimension(self) -> int:
        """Number of decision variables."""


class MaxCutProblem(OptimizationProblem):
    """MAX-CUT on a weighted graph given by its symmetric adjacency matrix.

    Maximizing the cut minimizes E(s) = -1/2 s^T J s with J = -W, since
    cut(s) = 1/4 sum_ij W_ij (1 - s_i s_j). ``objective`` returns -cut, so
    smaller is better.
    """

    def __init__(self, adjacency_matrix):
        W = np.asarray(adjacency_matrix, dtype=np.float32)
        if W.ndim != 2 or W.shape[0] != W.shape[1]:
            raise ConfigurationError("adjacency matrix must be square")
        self.adjacency = W

    def objective(self, x) -> float:
        s = np.where(np.asarray(x) >= 0, 1.0, -1.0)
        return -0.25 * float(np.sum(self.adjacency * (1.0 - np.outer(s, s))))

    def cut_value(self, spins) -> float:
        s = np.asarray(spins, dtype=np.float64)
        return 0.25 * float(np.sum(self.adjacency * (1.0 - np.outer(s, s))))

    def to_ising(self):
        """(J, h) whose ground state is the max cut."""
        return -self.adjacency, np.zeros(self.adjacency.shape[0], dtype=np.float32)

    @property
    def dimension(self) -> int:
        return self.adjacency.shape[0]


def optimize(problem: OptimizationProblem, n_steps: int = 1000, initial_temp: float = 10.0,
             final_temp: float = 0.01, n_chains: int = 8, seed=None, device=None) -> dict:
    """Annealed optimization on ``device`` (default the card).

    A problem with ``to_ising``: ``n_chains`` chains of its bit model anneal
    from ``initial_temp`` to ``final_temp`` over ``n_steps`` sweeps, or on
    the host for a small problem (n <= 256) with an int seed. Any other
    problem: ``n_chains`` chains from 0.1 N(0, 1) run ``n_steps // 10 + 1``
    overdamped Langevin steps (dt 0.01) at each of 10 temperatures geometric
    from ``initial_temp`` to ``final_temp`` on its objective, and the chain
    with the best objective wins; the objective must be written with torch
    operations (``ConfigurationError`` otherwise). ``seed``: an int, a CPU
    ``torch.Generator`` or None (fresh entropy). Returns {"best_solution",
    "best_objective", "time_elapsed", "n_steps"}; the best solution is ±1
    spins for an Ising problem, and the Langevin fallback adds its "route"
    ("graph" or "eager")."""
    start = time.perf_counter()
    if not hasattr(problem, "to_ising"):
        best_x, best_obj, route = _anneal_langevin(problem, n_steps, initial_temp, final_temp,
                                                   n_chains, seed, resolve_device(device))
        return {"best_solution": best_x, "best_objective": best_obj,
                "time_elapsed": time.perf_counter() - start, "n_steps": n_steps,
                "route": route}
    J, h = problem.to_ising()
    J_bit, h_bit = ising_to_boltzmann(np.asarray(J), np.asarray(h))
    if not isinstance(seed, (int, np.integer)):
        seed = int(torch.randint(0, 2**63 - 1, (), generator=as_generator(seed)))
    best_bits, _ = simulated_annealing_dense(
        int(seed), J_bit, h_bit, T_initial=initial_temp, T_final=final_temp, n_steps=n_steps,
        n_chains=n_chains, device=device)
    best_x = 2.0 * np.asarray(best_bits, np.float64) - 1.0
    return {
        "best_solution": best_x,
        "best_objective": float(problem.objective(best_x)),
        "time_elapsed": time.perf_counter() - start,
        "n_steps": n_steps,
    }


def _anneal_langevin(problem: OptimizationProblem, n_steps: int, initial_temp: float,
                     final_temp: float, n_chains: int, seed, device):
    """The annealed-Langevin fallback of :func:`optimize`: (best solution
    as numpy, its objective, the route of the Langevin loops)."""
    dim = problem.dimension
    obj = problem.objective
    # Probe differentiability up front: a numpy-only objective would
    # otherwise fail deep inside the engine.
    try:
        g = grad(obj)(torch.zeros(dim, dtype=torch.float32, device=device))
    except Exception as e:  # noqa: BLE001 - any failure means the objective cannot be used
        raise ConfigurationError(
            f"{type(problem).__name__}.objective cannot be differentiated by torch.func.grad, "
            "so the annealed-Langevin fallback cannot use it. Either implement to_ising() -> "
            "(J, h) for the discrete annealer, or write the objective with torch operations "
            f"returning a scalar tensor. Underlying error: {e}") from e
    if g.shape != (dim,):
        raise ConfigurationError(f"objective's gradient has shape {tuple(g.shape)}, not "
                                 f"({dim},) (problem {type(problem).__name__})")

    gen = device_generator(seed, device)
    x = 0.1 * torch.randn((n_chains, dim), generator=gen, device=device)
    draws = Draws(gen)
    routes = set()
    for T in np.geomspace(initial_temp, final_temp, 10):
        samples, route = run_langevin(draws, x, energy_fn=obj, n_samples=1, temperature=float(T),
                                      dt=0.01, n_burnin=n_steps // 10, n_steps=1,
                                      underdamped=False)
        x = samples[:, -1]
        routes.add(route)
    objs = [float(obj(xi)) for xi in x]
    best = x[int(np.argmin(objs))]
    return best.cpu().numpy(), float(obj(best)), "graph" if routes == {"graph"} else "eager"


# -- probabilistic model API -------------------------------------------------


class ProbabilisticLayer(ABC):
    """Abstract stochastic layer."""

    @abstractmethod
    def forward(self, x: np.ndarray, n_samples: Optional[int] = None) -> np.ndarray:
        """Stochastic forward pass.

        ``n_samples=None`` (default) returns one draw with the input's
        shape; an integer returns ``(n_samples, ...)`` stacked independent
        draws (0 gives an empty stack)."""


def perturbed_linear(x: torch.Tensor, weights: torch.Tensor, bias: torch.Tensor,
                     noise: torch.Tensor, weight_noise: float) -> torch.Tensor:
    """x @ (weights + weight_noise * noise) + bias; ``noise`` (..., in, out)
    gives (..., batch, out)."""
    return x @ (weights + weight_noise * noise) + bias


class StochasticLinear(ProbabilisticLayer):
    """Linear layer with Gaussian weight noise, drawn anew every pass.
    ``seed``: an int or a CPU ``torch.Generator`` (the initial weights, then
    the noise's device stream); ``device`` default the card."""

    def __init__(self, in_features: int, out_features: int, weight_noise: float = 0.1,
                 seed=None, device=None):
        self.in_features = in_features
        self.out_features = out_features
        self.weight_noise = weight_noise
        self.device = resolve_device(device)
        gen = as_generator(seed)
        scale = 1.0 / np.sqrt(max(in_features, 1))
        self.weights = (scale * torch.randn((in_features, out_features), generator=gen)).numpy()
        self.bias = np.zeros(out_features, dtype=np.float32)
        self._dgen = device_generator(gen, self.device)

    def forward(self, x: np.ndarray, n_samples: Optional[int] = None) -> np.ndarray:
        # `is not None`, not truthiness: n_samples=0 must give an empty
        # (0, batch, out) stack, not one unstacked draw.
        shape = ((n_samples,) if n_samples is not None else ()) + self.weights.shape
        noise = torch.randn(shape, generator=self._dgen, device=self.device)
        x = torch.atleast_2d(torch.as_tensor(np.asarray(x, np.float32))).to(self.device)
        return perturbed_linear(x, torch.as_tensor(self.weights).to(self.device),
                                torch.as_tensor(self.bias).to(self.device), noise,
                                self.weight_noise).cpu().numpy()


class BernoulliActivation(ProbabilisticLayer):
    """Stochastic binary activation: one ``torch.bernoulli`` of sigmoid(x)
    over the whole tensor, on the layer's device (default the card)."""

    def __init__(self, seed=None, device=None):
        self.device = resolve_device(device)
        self._dgen = device_generator(seed, self.device)

    def forward(self, x: np.ndarray, n_samples: Optional[int] = None) -> np.ndarray:
        p = torch.sigmoid(torch.as_tensor(np.asarray(x, np.float32)).to(self.device))
        if n_samples is not None:
            p = p.expand(n_samples, *p.shape)
        return torch.bernoulli(p, generator=self._dgen).cpu().numpy()


class ProbabilisticModel:
    """Keras-like stochastic model."""

    def __init__(self):
        self.layers: List[ProbabilisticLayer] = []

    def add(self, layer: ProbabilisticLayer) -> "ProbabilisticModel":
        if not isinstance(layer, ProbabilisticLayer):
            raise ConfigurationError("layer must be a ProbabilisticLayer")
        self.layers.append(layer)
        return self

    def forward(self, x: np.ndarray) -> np.ndarray:
        h = np.atleast_2d(np.asarray(x, dtype=np.float32))
        for layer in self.layers:
            h = layer.forward(h)
        return h

    def sample(self, x: np.ndarray, n_samples: int = 100) -> np.ndarray:
        """(n_samples, ...) independent stochastic outputs for one input."""
        return np.stack([self.forward(x) for _ in range(n_samples)])

    def predict_proba(self, x: np.ndarray, n_samples: int = 100) -> np.ndarray:
        """Mean over stochastic forward passes."""
        return np.mean(self.sample(x, n_samples), axis=0)
