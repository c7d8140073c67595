"""Plain reference of the parallel-tempering ground-state search on a ±J
lattice with Houdayer cluster moves: ``pt_ground_state_search`` worked out
again from its seed and bonds.

Replicas are whole (L, L) int8 lattices, B = copies x rungs of them, slot
c * rungs + j holding rung j (0 the coldest) of copy c. From a CPU
``torch.Generator`` seeded with the call's seed come the initial lattices
(rand(B, L, L) < 0.5 gives +1) and then ``base`` = randint(0, 2**31).

Iteration t draws one row of Philox words under key (fold(base, t), 0): the
first B, masked to 30 bits, are the replicas' stream ids; the next
copies x rungs, shifted right by 8 and scaled by 2**-24, the swap uniforms
of each copy's rungs; the rest, likewise, the Houdayer uniforms. Then:

1. every replica sweeps: red sites (r + c even) from the local field
   h = sum of J_b s_j over the four bonds, then black ones, +1 iff
   u < t[h + 4], u the top ``bits`` bits of the word at (r, c // 2) under
   key (fold(id), 2k + colour) for sweep k, t the rung's thresholds
   sigmoid(2 k / T) at ``bits`` bits;
2. every slot whose energy fell below its best keeps that lattice;
3. in each copy the pairs (p, p + 1), p = t mod 2, 4, ..., swap lattices
   when u_p < exp(min(0, (1/T_p - 1/T_p+1) (E_p - E_p+1))), in float32;
4. every ``houdayer_every`` iterations, rung j < ``hd`` of copies 2m and
   2m + 1: among the sites where the two disagree, red ones in row-major
   order then black ones, the k-th with k = floor(u count) seeds a cluster,
   the periodic 4-connected set of disagreeing sites holding it; both
   replicas flip it, and the moved slots' bests are updated.

After the iterations each slot's best lattice descends through
``quench_sweeps`` sweeps on the schedule geomspace(T_0, 0.02), sweep k of
replica b keyed by the k-th row's b-th word under (fold(base, n_iters), 1),
and every slot keeps what falls below its best. The lowest slot (the first
of equals) is returned. The CPU's sigmoid may round an element otherwise
at another place in a tensor, so the thresholds are taken as (B, 9) and
(quench, B, 9) tensors.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from perfbench.reference.ising import threshold_table
from perfbench.reference.philox import fold, words

ID_MASK = 2**30 - 1


def local_field(s, Jh, Jv, Jh_left, Jv_up):
    """Sum over the four periodic bonds of J_b times the neighbour's spin."""
    return (Jh * torch.roll(s, -1, -1) + Jh_left * torch.roll(s, 1, -1)
            + Jv * torch.roll(s, -1, -2) + Jv_up * torch.roll(s, 1, -2))


def energies(s, Jh, Jv) -> torch.Tensor:
    """-sum over bonds of J_b s_i s_j per replica, float64."""
    t = s.to(torch.int64)
    bonds = Jh * t * torch.roll(t, -1, -1) + Jv * t * torch.roll(t, -1, -2)
    return -bonds.sum((-2, -1)).double()


class _Lattice:
    """The bonds and the colouring of one (L, L) periodic ±J lattice."""

    def __init__(self, Jh, Jv, bits, device):
        self.Jh = torch.as_tensor(Jh).to(device, torch.int64)
        self.Jv = torch.as_tensor(Jv).to(device, torch.int64)
        if not bool(((self.Jh.abs() <= 1) & (self.Jv.abs() <= 1)).all()):
            raise ValueError("the reference search takes bonds in {-1, 0, +1}")
        self.Jh8, self.Jv8 = self.Jh.to(torch.int8), self.Jv.to(torch.int8)
        self.Jh_left = torch.roll(self.Jh8, 1, -1)
        self.Jv_up = torch.roll(self.Jv8, 1, -2)
        L0, L1 = self.Jh.shape
        r = torch.arange(L0, device=device)[:, None]
        c = torch.arange(L1, device=device)[None, :]
        self.red = (r + c) % 2 == 0
        self.shape, self.bits, self.device = (L0, L1), bits, device

    def half(self, s, w, tables, sites):
        """Resample ``sites`` of every replica: w (B, L, L/2) words, tables
        (B, 9)."""
        u = (w >> (32 - self.bits)).repeat_interleave(2, dim=-1)
        h = local_field(s, self.Jh8, self.Jv8, self.Jh_left, self.Jv_up).to(torch.int64) + 4
        plus = u < torch.gather(tables, 1, h.flatten(1)).view_as(h)
        return torch.where(sites, torch.where(plus, 1, -1).to(s.dtype), s)

    def sweeps(self, s, ids, n_sweeps, tables):
        """``n_sweeps`` sweeps of every replica; ids (B,) stream ids."""
        L0, L1 = self.shape
        k0 = fold(ids)[:, None, None]
        for k in range(n_sweeps):
            for colour, sites in ((0, self.red), (1, ~self.red)):
                w = words(k0, 2 * k + colour, L0, L1 // 2, self.device)
                s = self.half(s, w, tables, sites)
        return s

    def energies(self, s):
        return energies(s, self.Jh, self.Jv)


def cluster(q: np.ndarray, seed: int) -> np.ndarray:
    """Boolean mask of the periodic 4-connected component of ``q`` (L, L)
    that holds the flat site ``seed``."""
    labels, n = ndimage.label(q)
    a = np.concatenate([labels[0], labels[:, 0]])
    b = np.concatenate([labels[-1], labels[:, -1]])
    both = (a > 0) & (b > 0)
    graph = coo_matrix((np.ones(both.sum()), (a[both], b[both])), shape=(n + 1, n + 1))
    _, comp = connected_components(graph, directed=False)
    return comp[labels] == comp[labels.flat[seed]]


def houdayer(s1: np.ndarray, s2: np.ndarray, u: np.ndarray, red: np.ndarray):
    """Flip in place, in each pair i of (P, L, L) lattices, the cluster of
    disagreeing sites seeded by u[i]."""
    for i in range(s1.shape[0]):
        q = s1[i] != s2[i]
        order = np.concatenate([np.flatnonzero(q & red), np.flatnonzero(q & ~red)])
        if not len(order):
            continue
        k = min(int(np.float64(u[i]) * len(order)), len(order) - 1)
        flip = cluster(q, int(order[k]))
        s1[i][flip] *= -1
        s2[i][flip] *= -1


def pt_search(seed: int, Jh, Jv, *, temperatures, n_iters: int, n_sweeps: int = 1,
              n_copies: int, houdayer_every: int, houdayer_frac: float = 0.5,
              quench_sweeps: int, quench_T_final: float = 0.02, bits: int = 24,
              device=None) -> dict:
    """The search's returned lattice and energy and each rung pair's swap
    acceptances and attempts, as numpy values."""
    temps = np.sort(np.asarray(temperatures, np.float32).reshape(-1))
    R, C = len(temps), int(n_copies)
    B = R * C
    lat = _Lattice(Jh, Jv, bits, device)
    gen = torch.Generator().manual_seed(int(seed))
    s = torch.where(torch.rand((B, *lat.shape), generator=gen) < 0.5, 1, -1)
    s = s.to(torch.int8).to(device)
    base = int(torch.randint(0, 2**31, (), generator=gen))
    tables = threshold_table(1.0, torch.from_numpy(np.tile(temps, C)), bits).to(device)
    betas = (1.0 / torch.from_numpy(temps)).to(device)
    hd = max(1, int(round(R * houdayer_frac)))
    pairs = C // 2 if houdayer_every > 0 else 0
    i1 = (2 * R * np.arange(pairs)[:, None] + np.arange(hd)).reshape(-1)
    i2 = i1 + R
    touched = torch.from_numpy(np.concatenate([i1, i2])).to(device)
    red = lat.red.cpu().numpy()

    best_s, best_e = s, lat.energies(s)
    acc = np.zeros(max(R - 1, 0), np.int64)
    att = np.zeros_like(acc)
    Q = B + C * R + len(i1)
    for t in range(n_iters):
        w = words(fold(base, t), 0, 1, Q, device)[0]
        u = (w[B:] >> 8).to(torch.float32) * 2.0**-24
        s = lat.sweeps(s, w[:B] & ID_MASK, n_sweeps, tables)
        e = lat.energies(s)
        better = (e < best_e)[:, None, None]
        best_s, best_e = torch.where(better, s, best_s), torch.minimum(e, best_e)

        p = torch.arange(t % 2, R - 1, 2, device=device)
        ec = e.view(C, R)
        delta = torch.zeros((C, R), dtype=torch.float32, device=device)
        delta[:, p] = (betas[p] - betas[p + 1]) * (ec[:, p] - ec[:, p + 1]).to(torch.float32)
        swap = u[:C * R].view(C, R)[:, p] < torch.exp(torch.clamp(delta, max=0.0))[:, p]
        acc[p.cpu().numpy()] += swap.sum(0).cpu().numpy()
        att[p.cpu().numpy()] += C
        perm = torch.arange(B, device=device).view(C, R)
        left, right = perm[:, p].clone(), perm[:, p + 1].clone()
        perm[:, p] = torch.where(swap, right, left)
        perm[:, p + 1] = torch.where(swap, left, right)
        s = s[perm.reshape(-1)]

        if pairs and (t + 1) % houdayer_every == 0:
            sn = s.cpu().numpy()
            a, b = sn[i1], sn[i2]
            houdayer(a, b, u[C * R:].cpu().numpy(), red)
            sn[i1], sn[i2] = a, b
            s = torch.from_numpy(sn).to(device)
            e = lat.energies(s[touched])
            better = (e < best_e[touched])[:, None, None]
            best_s[touched] = torch.where(better, s[touched], best_s[touched])
            best_e[touched] = torch.minimum(e, best_e[touched])

    if quench_sweeps > 0:
        sched = np.geomspace(float(temps[0]), quench_T_final, quench_sweeps).astype(np.float32)
        qtables = threshold_table(
            1.0, torch.from_numpy(np.repeat(sched[:, None], B, axis=1)), bits).to(device)
        ids = words(fold(base, n_iters), 1, quench_sweeps, B, device) & ID_MASK
        qs = best_s
        for k in range(quench_sweeps):
            qs = lat.sweeps(qs, ids[k], 1, qtables[k])
            e = lat.energies(qs)
            better = (e < best_e)[:, None, None]
            best_s, best_e = torch.where(better, qs, best_s), torch.minimum(e, best_e)

    e_np = best_e.cpu().numpy()
    i = int(np.argmin(e_np))
    return {"best_state": best_s[i].reshape(-1).to(torch.float32).cpu().numpy(),
            "best_energy": float(e_np[i]), "pair_accepts": acc, "pair_attempts": att}


def gaps(program: dict, reference: dict) -> dict:
    """The compared numbers: the gap of the returned energy, the sites where
    the returned lattices differ, and the largest gap of a rung pair's
    accepted swaps. A missing, misshapen or non-finite answer reads as the
    largest float."""
    big = np.finfo(np.float64).max
    state = np.asarray(program.get("best_state", ()), np.float64)
    want = reference["best_state"]
    state = state.reshape(-1) if state.size == want.size else state
    att = np.asarray(program.get("pair_attempts", ()), np.float64)
    rate = np.asarray(program.get("pair_acceptance", ()), np.float64)
    ok_pairs = att.shape == rate.shape == reference["pair_attempts"].shape
    accepts = np.rint(rate * att) if ok_pairs else None
    out = {
        "best_e_gap": abs(float(program.get("best_energy", np.nan)) - reference["best_energy"]),
        "state_sites_differing": float(np.sum(state != want)) if state.shape == want.shape
        else np.inf,
        "swap_accepts_gap": float(np.max(np.abs(accepts - reference["pair_accepts"]), initial=0)
                                  + np.max(np.abs(att - reference["pair_attempts"]), initial=0))
        if ok_pairs else np.inf,
    }
    return {k: float(np.nan_to_num(v, nan=big, posinf=big)) for k, v in out.items()}
