"""100k-node MAX-CUT: sparse ELL annealing on the card against the native
greedy bound.

Counterpart of ``examples/large_scale_maxcut.py`` (BASELINE config 5's
scale). The dense-J path caps out at thousands of spins; the sparse path
holds O(N * max_degree) memory and anneals on the device.

Run: python3 -m tsu_tpu_torch.examples.large_scale_maxcut [--device cpu] [--<size> N ...]
"""

from __future__ import annotations

import time

import numpy as np

from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.examples import cli
from tsu_tpu_torch.native import csr_from_edges, greedy_maxcut_csr
from tsu_tpu_torch.ops.sparse_ising import maxcut_sparse


def main(n: int = 100_000, m: int = 500_000, n_steps: int = 2000, n_chains: int = 8,
         seed: int = 0, device=None) -> dict:
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, (m, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    weights = np.ones(len(edges))
    print(f"random graph: {n} nodes, {len(edges)} edges")

    t0 = time.perf_counter()
    indptr, idx, w = csr_from_edges(n, edges, weights)
    greedy_cut, _ = greedy_maxcut_csr(indptr, idx, w, n_restarts=5, seed=seed)
    t_greedy = time.perf_counter() - t0
    print(f"greedy local search (native): cut={greedy_cut:.0f} "
          f"({greedy_cut / len(edges):.1%}) in {t_greedy:.2f}s")

    t0 = time.perf_counter()
    out = maxcut_sparse(seed, n, edges, weights, n_steps=n_steps, n_chains=n_chains,
                        device=device)
    t_anneal = time.perf_counter() - t0
    line = (f"{device.type} annealing ({n_steps} steps x {n_chains} chains): "
            f"cut={out['cut_value']:.0f} ({out['cut_value'] / len(edges):.1%}) "
            f"in {t_anneal:.2f}s")
    print(line)
    return {"n_edges": len(edges), "greedy_cut": float(greedy_cut), "greedy_s": t_greedy,
            "cut": out["cut_value"], "anneal_s": t_anneal, "line": line}


if __name__ == "__main__":
    cli(main, __doc__)
