"""Optimization benchmarks.

Counterpart of ``tsu_tpu/benchmarks/optimization.py``, with its problems,
sizes, seeds and result keys: MAX-CUT, graph 3-coloring (a one-hot QUBO),
number partitioning, sparse MAX-CUT at 100,000 nodes and the 2-D +-J
Edwards-Anderson ground-state search, each annealed on its Ising/QUBO
encoding; a MAX-CUT gap is against a greedy lower bound, labelled so.
``routes`` records where each row annealed: "native_cpp" (the host loop of
a small int-seeded anneal) or "device".
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from tsu_tpu_torch.api import MaxCutProblem, optimize
from tsu_tpu_torch.energy import ising_to_boltzmann
from tsu_tpu_torch.samplers.annealing import simulated_annealing_dense, takes_native


@dataclass
class OptimizationResult:
    """One optimization benchmark outcome."""

    name: str
    n_variables: int
    objective: float
    reference_bound: float
    gap_vs_bound: float
    time_elapsed: float
    extra: Dict = field(default_factory=dict)

    def summary(self) -> dict:
        return {
            "name": self.name,
            "n_variables": self.n_variables,
            "objective": round(self.objective, 4),
            "reference_bound": round(self.reference_bound, 4),
            "gap_vs_bound": round(self.gap_vs_bound, 4),
            "time_ms": round(self.time_elapsed * 1e3, 2),
            **self.extra,
        }


def greedy_maxcut_bound(W: np.ndarray, n_restarts: int = 10, seed: int = 0) -> float:
    """Greedy local-search cut value, a LOWER bound on the max cut."""
    rng = np.random.default_rng(seed)
    n = W.shape[0]
    best = 0.0
    for _ in range(n_restarts):
        s = rng.choice([-1.0, 1.0], n)
        improved = True
        while improved:
            improved = False
            for i in range(n):
                # Gain from flipping spin i.
                gain = s[i] * (W[i] @ s)
                if gain > 0:
                    s[i] = -s[i]
                    improved = True
        cut = 0.25 * float(np.sum(W * (1 - np.outer(s, s))))
        best = max(best, cut)
    return best


def coloring_qubo(adjacency: np.ndarray, n_colors: int, penalty: float = 4.0):
    """One-hot QUBO for graph coloring as a bit-Boltzmann (J, h).

    Variables x_{v,c}; energy
        A * sum_v (1 - sum_c x_vc)^2 + B * sum_{(u,v) in E, c} x_uc x_vc.
    Expanding the one-hot penalty gives quadratic terms A*x_vc*x_vc' and
    linear terms -A*x_vc. Mapped to E(b) = -1/2 b^T J b - h^T b:
        J[(v,c),(v,c')] = -2A (c != c'), J[(u,c),(v,c)] = -B for edges,
        h[(v,c)] = A.
    """
    A = penalty
    B = penalty
    n = adjacency.shape[0]
    N = n * n_colors
    J = np.zeros((N, N), np.float32)
    h = np.zeros(N, np.float32)

    def vid(v, c):
        return v * n_colors + c

    for v in range(n):
        for c in range(n_colors):
            h[vid(v, c)] = A
            for c2 in range(c + 1, n_colors):
                J[vid(v, c), vid(v, c2)] = -2.0 * A
                J[vid(v, c2), vid(v, c)] = -2.0 * A
    for u in range(n):
        for v in range(u + 1, n):
            if adjacency[u, v]:
                for c in range(n_colors):
                    J[vid(u, c), vid(v, c)] = -B
                    J[vid(v, c), vid(u, c)] = -B
    return J, h


def count_coloring_conflicts(adjacency: np.ndarray, bits: np.ndarray,
                             n_colors: int) -> int:
    """Conflicts = same-colored edges; uncolored/multi-colored nodes get the
    argmax color of their one-hot block."""
    n = adjacency.shape[0]
    colors = bits.reshape(n, n_colors).argmax(axis=1)
    conflicts = 0
    for u in range(n):
        for v in range(u + 1, n):
            if adjacency[u, v] and colors[u] == colors[v]:
                conflicts += 1
    return conflicts


class OptimizationBenchmark:
    """Optimization benchmark suite on ``device`` (default the card)."""

    def __init__(self, seed: int = 0, n_chains: int = 16, device=None):
        self.seed = seed
        self.n_chains = n_chains
        self.device = device
        self.results: List[OptimizationResult] = []
        self.routes: Dict[str, str] = {}

    def _dense_route(self, n: int, n_steps: int) -> str:
        return "native_cpp" if takes_native(n, n_steps, self.n_chains) else "device"

    def benchmark_maxcut(self, n_nodes: int = 15, edge_prob: float = 0.5,
                         n_steps: int = 500) -> OptimizationResult:
        rng = np.random.default_rng(self.seed)
        W = (rng.random((n_nodes, n_nodes)) < edge_prob).astype(np.float32)
        W = np.triu(W, 1)
        W = W + W.T
        problem = MaxCutProblem(W)
        # A warm-up with the same shapes: the timed run reports steady-state
        # ms, not first-call costs.
        t_w = time.perf_counter()
        optimize(problem, n_steps=n_steps, n_chains=self.n_chains,
                 seed=self.seed, device=self.device)
        warmup = time.perf_counter() - t_w
        t0 = time.perf_counter()
        out = optimize(problem, n_steps=n_steps, n_chains=self.n_chains,
                       seed=self.seed, device=self.device)
        elapsed = time.perf_counter() - t0
        self.routes["maxcut"] = self._dense_route(n_nodes, n_steps)
        cut = problem.cut_value(out["best_solution"])
        bound = greedy_maxcut_bound(W, seed=self.seed)
        result = OptimizationResult(
            name="maxcut",
            n_variables=n_nodes,
            objective=cut,
            reference_bound=bound,
            gap_vs_bound=(bound - cut) / max(bound, 1e-9),
            time_elapsed=elapsed,
            extra={"bound_type": "greedy_lower_bound",
                   "warmup_time_s": round(warmup, 3)},
        )
        self.results.append(result)
        return result

    def benchmark_graph_coloring(self, n_nodes: int = 10, n_colors: int = 3,
                                 edge_prob: float = 0.4,
                                 n_steps: int = 800) -> OptimizationResult:
        rng = np.random.default_rng(self.seed + 1)
        adj = (rng.random((n_nodes, n_nodes)) < edge_prob).astype(np.float32)
        adj = np.triu(adj, 1)
        adj = adj + adj.T
        J, h = coloring_qubo(adj, n_colors)

        def run():
            # An int seed and numpy (J, h): this small problem takes the
            # native host loop.
            return simulated_annealing_dense(
                self.seed, J, h,
                T_initial=5.0, T_final=0.05, n_steps=n_steps,
                n_chains=self.n_chains, device=self.device,
            )

        run()  # warm-up: first-call costs out of the timed anneal
        t0 = time.perf_counter()
        bits, _ = run()
        elapsed = time.perf_counter() - t0
        self.routes["graph_coloring"] = self._dense_route(n_nodes * n_colors, n_steps)
        conflicts = count_coloring_conflicts(adj, np.asarray(bits), n_colors)
        # Random-assignment baseline, the comparison point.
        rand_colors = rng.integers(0, n_colors, n_nodes)
        rand_conflicts = sum(
            1
            for u in range(n_nodes)
            for v in range(u + 1, n_nodes)
            if adj[u, v] and rand_colors[u] == rand_colors[v]
        )
        result = OptimizationResult(
            name="graph_coloring",
            n_variables=n_nodes * n_colors,
            objective=float(conflicts),
            reference_bound=0.0,
            gap_vs_bound=float(conflicts),
            time_elapsed=elapsed,
            extra={"random_assignment_conflicts": int(rand_conflicts),
                   "n_colors": n_colors},
        )
        self.results.append(result)
        return result

    def benchmark_number_partitioning(self, n_numbers: int = 15,
                                      n_steps: int = 500) -> OptimizationResult:
        """Minimize |sum_i s_i a_i| via Ising J = -2 a a^T."""
        rng = np.random.default_rng(self.seed + 2)
        a = rng.integers(1, 100, n_numbers).astype(np.float32)
        J = -2.0 * np.outer(a, a)
        np.fill_diagonal(J, 0.0)
        J_bit, h_bit = ising_to_boltzmann(J, np.zeros(n_numbers, np.float32))

        def run():
            return simulated_annealing_dense(
                self.seed, J_bit, h_bit,
                T_initial=float(a.sum()), T_final=0.1, n_steps=n_steps,
                n_chains=self.n_chains, device=self.device,
            )

        run()  # warm-up: first-call costs out of the timed anneal
        t0 = time.perf_counter()
        bits, _ = run()
        elapsed = time.perf_counter() - t0
        self.routes["number_partitioning"] = self._dense_route(n_numbers, n_steps)
        s = 2.0 * np.asarray(bits) - 1.0
        residual = abs(float(s @ a))
        # Parity bound: perfect partition impossible if sum is odd.
        best_possible = float(int(a.sum()) % 2)
        result = OptimizationResult(
            name="number_partitioning",
            n_variables=n_numbers,
            objective=residual,
            reference_bound=best_possible,
            gap_vs_bound=residual - best_possible,
            time_elapsed=elapsed,
            extra={"total_sum": float(a.sum())},
        )
        self.results.append(result)
        return result

    def benchmark_maxcut_sparse(self, n_nodes: int = 100_000,
                                n_edges: int = 500_000,
                                n_steps: int = 2000) -> OptimizationResult:
        """Large sparse MAX-CUT: ELL annealing on the device against the
        native greedy local-search bound."""
        from tsu_tpu_torch.native import csr_from_edges, greedy_maxcut_csr
        from tsu_tpu_torch.ops.sparse_ising import maxcut_sparse

        rng = np.random.default_rng(self.seed + 3)
        edges = rng.integers(0, n_nodes, (n_edges, 2))
        edges = edges[edges[:, 0] != edges[:, 1]]
        weights = np.ones(len(edges))

        indptr, idx, w = csr_from_edges(n_nodes, edges, weights)
        greedy_cut, _ = greedy_maxcut_csr(indptr, idx, w, n_restarts=3,
                                          seed=self.seed)

        def run():
            return maxcut_sparse(
                self.seed, n_nodes, edges, weights,
                n_steps=n_steps, n_chains=min(self.n_chains, 8), device=self.device,
            )

        run()  # warm-up: first-call costs out of the timed anneal
        t0 = time.perf_counter()
        out = run()
        elapsed = time.perf_counter() - t0
        self.routes["maxcut_sparse"] = "device"
        result = OptimizationResult(
            name="maxcut_sparse",
            n_variables=n_nodes,
            objective=out["cut_value"],
            reference_bound=greedy_cut,
            gap_vs_bound=(greedy_cut - out["cut_value"]) / max(greedy_cut, 1e-9),
            time_elapsed=elapsed,
            extra={"n_edges": int(len(edges)),
                   "bound_type": "greedy_lower_bound",
                   "cut_fraction": round(out["cut_value"] / len(edges), 4)},
        )
        self.results.append(result)
        return result

    def benchmark_spin_glass(self, size: int = 256,
                             n_iters: int = 10_000,
                             quick: bool = False) -> OptimizationResult:
        """2-D +-J Edwards-Anderson ground-state search at lattice scale, an
        optimization benchmark with a literature bound: the ground-state
        energy density is -1.4015(3) J/site. Driven by the spin-glass stack:
        a feedback-built ladder (``build_tempering_ladder``), parallel
        tempering of the whole ladder batched through the bond kernel (K5),
        Houdayer moves on the paired copies, per-slot best tracking and a
        batched final quench. The ladder build and the search are timed
        apart; swap acceptance must sit in the healthy band for the row to
        be trusted.
        """
        import torch

        from tsu_tpu_torch.samplers.tempering_ladder import (
            build_tempering_ladder,
            pt_ground_state_search,
        )

        EA_GS_DENSITY = -1.4015
        gen = torch.Generator().manual_seed(self.seed + 7)
        Jh = np.where(torch.rand((size, size), generator=gen).numpy() < 0.5, 1.0, -1.0)
        Jv = np.where(torch.rand((size, size), generator=gen).numpy() < 0.5, 1.0, -1.0)
        Jh, Jv = Jh.astype(np.float32), Jv.astype(np.float32)

        fb_iters = 128 if quick else 512
        t0 = time.perf_counter()
        temps, ladder_info = build_tempering_ladder(
            gen, Jh, Jv, T_min=0.3, T_max=2.0,
            target_acceptance=0.3, accept_floor=0.2,
            feedback_iters=fb_iters, feedback_burnin=fb_iters // 4, device=self.device)
        t_build = time.perf_counter() - t0

        # The warm-up runs one chunk with the same shapes, so the timed wall
        # is the steady-state search.
        chunk = 1000 if quick else 2500
        quench = 64 if quick else 256
        pt_kwargs = dict(temperatures=temps, n_sweeps=1, n_copies=2,
                         houdayer_every=10, quench_sweeps=quench,
                         chunk_iters=chunk, device=self.device)
        t_w = time.perf_counter()
        pt_ground_state_search(gen, Jh, Jv, n_iters=chunk, **pt_kwargs)
        warmup = time.perf_counter() - t_w
        t0 = time.perf_counter()
        out = pt_ground_state_search(
            gen, Jh, Jv, n_iters=(n_iters // chunk) * chunk, **pt_kwargs)
        elapsed = time.perf_counter() - t0
        self.routes["spin_glass_ea"] = "device"
        n = size * size
        density = out["energy_per_site"]
        bound = EA_GS_DENSITY * n
        result = OptimizationResult(
            name="spin_glass_ea",
            n_variables=n,
            objective=out["best_energy"],
            reference_bound=bound,
            gap_vs_bound=(density - EA_GS_DENSITY) / abs(EA_GS_DENSITY),
            time_elapsed=elapsed,
            extra={"energy_per_site": round(float(density), 4),
                   "bound_type": "literature_gs_density_-1.4015",
                   "method": "pt_ladder_houdayer",
                   "n_rungs": out["n_rungs"],
                   "n_copies": out["n_copies"],
                   "n_iters": n_iters,
                   "swap_acceptance": round(out["swap_acceptance_rate"], 3),
                   "min_pair_acceptance": round(
                       float(out["pair_acceptance"].min()), 3),
                   "ladder_build_time_s": round(t_build, 2),
                   "warmup_time_s": round(warmup, 2),
                   "discrete_table_path": out["discrete_table_path"]},
        )
        self.results.append(result)
        return result

    def run_all_benchmarks(self, quick: bool = False) -> List[OptimizationResult]:
        steps = 200 if quick else 800
        self.benchmark_maxcut(15, n_steps=steps)
        self.benchmark_graph_coloring(10, 3, n_steps=steps)
        self.benchmark_number_partitioning(15, n_steps=steps)
        if quick:
            self.benchmark_maxcut_sparse(5_000, 25_000, n_steps=300)
            self.benchmark_spin_glass(64, n_iters=2_000, quick=True)
        else:
            self.benchmark_maxcut_sparse(100_000, 500_000, n_steps=2000)
            self.benchmark_spin_glass(256, n_iters=10_000)
        return self.results
