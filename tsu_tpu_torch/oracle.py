"""Exact enumeration of small Boltzmann and Ising models, the benchmark
suites' ground truth.

The port's copy of ``_enumerate_moments``, ``exact_boltzmann_moments`` and
``exact_ising_moments`` of ``tsu_tpu/oracle/numpy_ref.py``: importing that
module runs ``tsu_tpu/__init__.py``, which imports JAX, so the port keeps
its own. Numpy, float64.
"""

from __future__ import annotations

import itertools

import numpy as np


def _enumerate_moments(states: np.ndarray, J, h, temperature):
    """Boltzmann-weighted moments over an explicit state enumeration."""
    J = np.asarray(J, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64)
    E = -0.5 * np.einsum("ki,ij,kj->k", states, J, states) - states @ h
    logw = -E / temperature
    logw -= logw.max()
    w = np.exp(logw)
    w /= w.sum()
    mean = w @ states
    m_per = states.mean(axis=1)
    return {
        "mean": mean,
        "energy": float(w @ E),
        "energy2": float(w @ (E**2)),
        "magnetization": float(w @ m_per),
        "abs_magnetization": float(w @ np.abs(m_per)),
        "m2": float(w @ (m_per**2)),
    }


def _states(n: int, values) -> np.ndarray:
    if n > 20:
        raise ValueError(f"enumeration is limited to n <= 20, got {n}")
    return np.array(list(itertools.product(values, repeat=n)))


def exact_boltzmann_moments(J, h, temperature=1.0):
    """Exact moments of the bit-Boltzmann distribution E(b) = -1/2 b^T J b -
    h^T b by enumeration (n <= 20)."""
    return _enumerate_moments(_states(np.asarray(J).shape[0], [0.0, 1.0]), J, h, temperature)


def exact_ising_moments(J, h, temperature=1.0):
    """Exact moments of the spin-Ising distribution by enumeration (n <= 20)."""
    return _enumerate_moments(_states(np.asarray(J).shape[0], [-1.0, 1.0]), J, h, temperature)
