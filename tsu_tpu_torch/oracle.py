"""Numpy ground truths: the energies of bits, spins and a 2-D lattice,
sequential heat-bath Gibbs over bits and over spins on a numpy generator,
exact enumeration of small Boltzmann and Ising models (the benchmark
suites' reference), Onsager's magnetization of the infinite 2-D lattice,
and the host Wolff cluster sampler (the critical-ESS yardstick).

The port's copy of ``tsu_tpu/oracle/numpy_ref.py`` and of ``wolff_chain``
of ``tsu_tpu/oracle/wolff.py``: importing those modules runs
``tsu_tpu/__init__.py``, which imports JAX, so the port keeps its own.
Numpy, float64; the same inputs and the same numpy generator give the same
results.
"""

from __future__ import annotations

import itertools

import numpy as np

__all__ = [
    "ising_energy",
    "boltzmann_energy",
    "sequential_gibbs_bits",
    "sequential_gibbs_spins",
    "exact_boltzmann_moments",
    "exact_ising_moments",
    "onsager_magnetization",
    "lattice_energy_np",
    "wolff_chain",
]


def boltzmann_energy(b: np.ndarray, J: np.ndarray, h: np.ndarray) -> float:
    """E(b) = -1/2 b^T J b - h^T b for bits b in {0,1}^n."""
    b = np.asarray(b, dtype=np.float64)
    return float(-0.5 * b @ J @ b - h @ b)


def ising_energy(s: np.ndarray, J: np.ndarray, h: np.ndarray) -> float:
    """E(s) = -1/2 s^T J s - h^T s for spins s in {-1,+1}^n."""
    s = np.asarray(s, dtype=np.float64)
    return float(-0.5 * s @ J @ s - h @ s)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.clip(x, -500, 500)))


def _sequential_gibbs(J, h, n_samples, n_burnin, n_sweeps, state, update):
    """n_burnin sweeps, then n_samples samples n_sweeps sweeps apart, of the
    site-by-site heat-bath ``update(i, field)`` of ``state``; the field
    excludes the diagonal coupling."""
    n = J.shape[0]

    def sweep():
        for i in range(n):
            field = J[i] @ state + h[i] - J[i, i] * state[i]
            update(i, field)

    for _ in range(n_burnin):
        sweep()
    out = np.empty((n_samples, n), dtype=np.float64)
    for k in range(n_samples):
        for _ in range(n_sweeps):
            sweep()
        out[k] = state
    return out


def sequential_gibbs_bits(rng: np.random.Generator, J: np.ndarray, h: np.ndarray,
                          n_samples: int, temperature: float = 1.0, n_burnin: int = 100,
                          n_sweeps: int = 10) -> np.ndarray:
    """Sequential-scan heat-bath Gibbs over bits {0,1}^n:
    P(b_i=1|rest) = sigmoid(((J b)_i + h_i)/T), the diagonal excluded.
    Returns (n_samples, n) float64."""
    state = (rng.random(J.shape[0]) < 0.5).astype(np.float64)

    def update(i, field):
        state[i] = 1.0 if rng.random() < _sigmoid(field / temperature) else 0.0

    return _sequential_gibbs(J, h, n_samples, n_burnin, n_sweeps, state, update)


def sequential_gibbs_spins(rng: np.random.Generator, J: np.ndarray, h: np.ndarray,
                           n_samples: int, temperature: float = 1.0, n_burnin: int = 100,
                           n_sweeps: int = 10) -> np.ndarray:
    """Sequential heat-bath Gibbs over spins {-1,+1}^n:
    P(s_i=+1|rest) = sigmoid(2 ((J s)_i + h_i)/T), the diagonal excluded.
    Returns (n_samples, n) float64."""
    state = np.where(rng.random(J.shape[0]) < 0.5, 1.0, -1.0)

    def update(i, field):
        state[i] = 1.0 if rng.random() < _sigmoid(2.0 * field / temperature) else -1.0

    return _sequential_gibbs(J, h, n_samples, n_burnin, n_sweeps, state, update)


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


def onsager_magnetization(T: float, J: float = 1.0) -> float:
    """Exact spontaneous magnetization of the infinite 2-D Ising lattice:
    M = (1 - sinh(2J/T)^-4)^(1/8) below T_c = 2J/ln(1+sqrt(2)) ~ 2.269J,
    else 0."""
    Tc = 2.0 * J / np.log(1.0 + np.sqrt(2.0))
    if T >= Tc:
        return 0.0
    return float((1.0 - np.sinh(2.0 * J / T) ** -4) ** 0.125)


def lattice_energy_np(s: np.ndarray, J: float = 1.0, h: float = 0.0,
                      periodic: bool = True) -> float:
    """Energy of a 2-D Ising lattice with uniform J (right and down bonds)
    and field h."""
    s = np.asarray(s, dtype=np.float64)
    if periodic:
        bond = np.sum(s * np.roll(s, -1, axis=-1)) + np.sum(s * np.roll(s, -1, axis=-2))
    else:
        bond = np.sum(s[:, :-1] * s[:, 1:]) + np.sum(s[:-1, :] * s[1:, :])
    return float(-J * bond - h * np.sum(s))


def wolff_chain(seed: int, L: int, T: float, n_steps: int, J: float = 1.0,
                n_burnin: int = 200) -> dict:
    """n_steps Wolff cluster flips on an L x L periodic ferromagnet, from
    all +1, on the host.

    Cluster growth is data-dependent and irregular, the computation the
    lattice kernels are not; its purpose is to measure what cluster updates
    buy at T_c. Each bond is tried at most once, from the side that enters
    the frontier first, with an independent draw at p_add = 1 - exp(-2J/T).
    Returns the per-step |m| series, the mean cluster size and the sweep
    equivalents per step (cluster size / N), and the final state.
    """
    rng = np.random.default_rng(seed)
    s = np.ones((L, L), dtype=np.int8)
    p_add = 1.0 - np.exp(-2.0 * J / T)
    N = L * L
    m_abs = np.empty(n_steps, np.float64)
    sizes = np.empty(n_steps, np.float64)

    def step():
        r, c = rng.integers(L), rng.integers(L)
        target = s[r, c]
        in_cluster = np.zeros((L, L), dtype=bool)
        in_cluster[r, c] = True
        frontier = in_cluster.copy()
        while frontier.any():
            new = np.zeros((L, L), dtype=bool)
            for axis, shift in ((0, 1), (0, -1), (1, 1), (1, -1)):
                nb = np.roll(frontier, shift, axis=axis)
                cand = nb & (~in_cluster) & (s == target)
                cand &= rng.random((L, L)) < p_add
                new |= cand
            in_cluster |= new
            frontier = new
        s[in_cluster] *= -1
        return in_cluster.sum()

    for _ in range(n_burnin):
        step()
    for t in range(n_steps):
        sizes[t] = step()
        m_abs[t] = abs(float(s.sum())) / N
    return {
        "m_abs": m_abs,
        "mean_cluster_size": float(sizes.mean()),
        "sweep_equiv_per_step": float(sizes.mean()) / N,
        "final_state": s.copy(),
    }
