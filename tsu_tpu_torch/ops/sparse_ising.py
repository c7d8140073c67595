"""Sparse Ising systems in ELL format: large-graph annealing and MAX-CUT.

Counterpart of ``tsu_tpu/ops/sparse_ising.py``. ELL (ELLPACK) gives every
site a fixed budget K of neighbours:

    neighbor_idx: (N, K) int32   (padded with N, which gathers a zero slot)
    neighbor_w:   (N, K) float32 (zero-padded)

so the local fields of all chains are one gather and a weighted sum.

Update scheme: synchronous random-subset heat-bath. Each step draws a
Bernoulli(p_update) mask and resamples the masked sites from their
conditionals given the current neighbours, for all chains at once. It is an
optimiser, not an exact equilibrium sampler: results are reported as the
objective reached.

Stream: every draw of an anneal (the initial spins, then per step the
proposal uniforms and the mask) comes from one generator on the anneal's
device, seeded from ``seed``. A snapshot stores that generator's state, so
the stream does not depend on how the schedule is chunked, and a resumed
anneal equals the uninterrupted one bit for bit on the same device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tsu_tpu_torch.checkpoint import checkpoint_exists, restore_state, save_state
from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.rng import as_generator, device_generator


def ell_from_edges(n: int, edges, weights,
                   k_max: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """ELL arrays of an undirected edge list (E, 2) with weights (E,).

    Returns (neighbor_idx (N, K) int32, neighbor_w (N, K) float32); K is the
    largest degree unless ``k_max`` cuts it. Self-loops are dropped; each
    edge (u, v) lists v in u's row and u in v's (a duplicate edge twice).
    A row holds its neighbours by decreasing |w|, ties in edge order, and
    keeps the first K. Equal to ``tsu_tpu.ops.sparse_ising.ell_from_edges``
    (one stable sort instead of a loop over the edges).
    """
    e = np.asarray(edges).reshape(-1, 2).astype(np.int64)
    w = np.asarray(weights).reshape(-1).astype(np.float64)
    keep = e[:, 0] != e[:, 1]
    e, w = e[keep], w[keep]
    m = len(e)
    rows = np.concatenate([e[:, 0], e[:, 1]])
    cols = np.concatenate([e[:, 1], e[:, 0]])
    ws = np.concatenate([w, w])
    # Within a row, entries arrive in edge order (u -> v and v -> u of one
    # edge never share a row), so the edge index breaks |w| ties.
    arrival = np.concatenate([np.arange(m), np.arange(m)])
    order = np.lexsort((arrival, -np.abs(ws), rows))
    rows, cols, ws = rows[order], cols[order], ws[order]
    deg = np.bincount(rows, minlength=n)
    K = int(deg.max()) if m else 0
    if k_max is not None:
        K = min(K, k_max)
    start = np.concatenate([[0], np.cumsum(deg)[:-1]])
    pos = np.arange(2 * m) - start[rows]
    sel = pos < K
    idx = np.full((n, K), n, dtype=np.int32)
    wout = np.zeros((n, K), dtype=np.float32)
    idx[rows[sel], pos[sel]] = cols[sel]
    wout[rows[sel], pos[sel]] = ws[sel]
    return idx, wout


def ell_local_fields(state: torch.Tensor, neighbor_idx: torch.Tensor,
                     neighbor_w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """(J s)_i + h_i of a state (N,) or a batch (C, N), by a padded gather."""
    padded = torch.cat([state, state.new_zeros(state.shape[:-1] + (1,))], dim=-1)
    return (neighbor_w * padded[..., neighbor_idx.long()]).sum(-1) + h


def ell_energy(state: torch.Tensor, neighbor_idx: torch.Tensor, neighbor_w: torch.Tensor,
               h: torch.Tensor) -> torch.Tensor:
    """E(s) = -1/2 s^T J s - h^T s of a state (N,) or a batch (C, N)."""
    f = ell_local_fields(state, neighbor_idx, neighbor_w, torch.zeros_like(h))
    return -0.5 * (state * f).sum(-1) - (h * state).sum(-1)


def sparse_anneal(seed, neighbor_idx, neighbor_w, h, schedule, *, n_steps: int,
                  n_chains: int = 8, p_update: float = 0.5, chunk_steps: Optional[int] = None,
                  checkpoint_path: Optional[str] = None, resume: bool = False, device=None):
    """Anneal sparse Ising spins over a temperature schedule (n_steps,) on
    ``device`` (default the card). Returns (best_state (N,) float32 tensor on
    that device, best_energy float) over all chains and steps.

    ``seed``: an int or a CPU ``torch.Generator``, which seeds the anneal's
    device generator. The best state of each chain is tracked after every
    step, the initial state counting. ``checkpoint_path`` snapshots the
    spins, the bests, the steps done and the device generator's state after
    every chunk of ``chunk_steps`` steps (default 500 when checkpointing,
    else the whole schedule); ``resume=True`` continues from the snapshot
    when it exists.
    """
    device = resolve_device(device)
    idx = torch.as_tensor(np.asarray(neighbor_idx)).to(device=device, dtype=torch.long)
    w = torch.as_tensor(np.asarray(neighbor_w, np.float32)).to(device)
    h = torch.as_tensor(np.asarray(h, np.float32)).to(device)
    sched = [float(T) for T in np.asarray(schedule, np.float32)[:n_steps]]
    N = idx.shape[0]
    if chunk_steps is None:
        chunk_steps = n_steps if checkpoint_path is None else max(1, min(n_steps, 500))
    gen = device_generator(as_generator(seed), device)
    zero = torch.zeros_like(h)
    s = torch.where(torch.rand((n_chains, N), generator=gen, device=device) < 0.5, 1.0, -1.0)
    f0 = ell_local_fields(s, idx, w, zero)
    best_s = s.clone()
    best_e = -0.5 * (s * f0).sum(-1) - (h * s).sum(-1)
    done = 0
    if resume and checkpoint_path is not None and checkpoint_exists(checkpoint_path):
        st = restore_state(checkpoint_path, {"s": s, "best_s": best_s, "best_e": best_e,
                                             "done": 0, "generator": gen.get_state()})
        s, best_s, best_e, done = st["s"], st["best_s"], st["best_e"], st["done"]
        gen.set_state(st["generator"])
        f0 = ell_local_fields(s, idx, w, zero)
    while done < n_steps:
        n = min(chunk_steps, n_steps - done)
        for T in sched[done:done + n]:
            p_up = torch.sigmoid(2.0 * (f0 + h) / T)
            u = torch.rand((n_chains, N), generator=gen, device=device)
            proposal = torch.where(u < p_up, 1.0, -1.0)
            mask = torch.rand((n_chains, N), generator=gen, device=device) < p_update
            s = torch.where(mask, proposal, s)
            f0 = ell_local_fields(s, idx, w, zero)
            e = -0.5 * (s * f0).sum(-1) - (h * s).sum(-1)
            torch.where((e < best_e)[:, None], s, best_s, out=best_s)
            torch.minimum(e, best_e, out=best_e)
        done += n
        if checkpoint_path is not None:
            save_state(checkpoint_path, {"s": s, "best_s": best_s, "best_e": best_e,
                                         "done": done, "generator": gen.get_state()})
    i = int(torch.argmin(best_e))
    return best_s[i], float(best_e[i])


def maxcut_sparse(seed, n: int, edges, weights, *, n_steps: int = 2000, n_chains: int = 8,
                  T_initial: float = 3.0, T_final: float = 0.05,
                  checkpoint_path: Optional[str] = None, resume: bool = False,
                  device=None) -> dict:
    """Anneal MAX-CUT on a sparse graph as the antiferromagnetic Ising model
    J = -W on ``device`` (default the card). Returns {"spins" (n,) float32
    numpy ±1, "cut_value", "energy", "n_steps"}; the cut is taken in float64
    over the ELL arrays. ``checkpoint_path``/``resume`` as in
    :func:`sparse_anneal`.
    """
    device = resolve_device(device)
    idx, w = ell_from_edges(n, edges, weights)
    schedule = (T_initial * (T_final / T_initial)
                ** (np.arange(n_steps) / max(n_steps - 1, 1))).astype(np.float32)
    best_s, best_e = sparse_anneal(seed, idx, -w, np.zeros(n, np.float32), schedule,
                                   n_steps=n_steps, n_chains=n_chains,
                                   checkpoint_path=checkpoint_path, resume=resume,
                                   device=device)
    # cut = 1/2 sum_edges w - 1/4 s^T W s over the full symmetric W.
    s64 = best_s.to(torch.float64)
    idx_t = torch.as_tensor(idx).to(device)
    sWs = float((s64 * ell_local_fields(s64, idx_t, torch.as_tensor(w).to(device, torch.float64),
                                        torch.zeros_like(s64))).sum())
    cut = 0.5 * float(np.sum(np.asarray(weights, np.float64))) - 0.25 * sWs
    return {"spins": best_s.cpu().numpy(), "cut_value": cut, "energy": best_e,
            "n_steps": n_steps}
