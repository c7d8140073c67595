"""Optimization API: MAX-CUT and annealed optimization of Ising-expressible
problems.

Counterpart of the optimization part of ``tsu_tpu/api.py``
(``OptimizationProblem``, ``MaxCutProblem``, ``optimize``). A problem with
``to_ising`` anneals its bit model with ``simulated_annealing_dense``; an
int seed lets a small problem take the native host loop, as in the JAX
package. Problems without ``to_ising`` need annealed Langevin dynamics,
which comes with slice 5 and raises ``NotImplementedError`` until then.
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod

import numpy as np
import torch

from tsu_tpu_torch.config import ConfigurationError
from tsu_tpu_torch.energy import ising_to_boltzmann
from tsu_tpu_torch.rng import as_generator
from tsu_tpu_torch.samplers.annealing import simulated_annealing_dense


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
    """Annealed optimization of a problem with ``to_ising``: ``n_chains``
    chains of its bit model anneal from ``initial_temp`` to ``final_temp``
    over ``n_steps`` sweeps on ``device`` (default the card), or on the host
    for a small problem (n <= 256) with an int seed. ``seed``: an int, a CPU
    ``torch.Generator`` (an int is drawn from it) or None (fresh entropy).
    Returns {"best_solution" (±1 spins), "best_objective", "time_elapsed",
    "n_steps"}."""
    start = time.perf_counter()
    if not hasattr(problem, "to_ising"):
        raise NotImplementedError(
            f"optimize of {type(problem).__name__}, which has no to_ising (annealed "
            "Langevin), is not ported to tsu_tpu_torch yet (slice 5 of ROADMAP.md)")
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
