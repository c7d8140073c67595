"""Plain reference of a heat-bath Ising chain on a periodic 2-D lattice with
uniform coupling: the chain of ``IsingGrid.sample_observables``, worked out
again from the seed.

The lattice is kept whole, as int8 spins. A sweep updates the sites with
r + c even ("red"), then the others ("black"), each by the heat-bath rule
s = +1 iff u < t[n + 4], n the sum of the four neighbours. The thresholds
t are sigmoid(2 J k / T), k = -4..4, scaled to ``bits`` bits in float32 on
the CPU, one row per sweep of a block: the CPU's sigmoid may round an
element otherwise when it stands at another place in a tensor, so the
table of a block of n sweeps is taken as an (n, 9) tensor. Sweep k of
block i draws from Philox under key
(fold(to_int32(base + i * 1_000_033)), k): site (r, c) reads the word at
(r, c // 2); red takes its low 16 bits, black its high 16, and with fewer
than 16 bits the top ones of those. The initial lattice and ``base`` come
from a CPU ``torch.Generator`` seeded with the call's seed: first
rand(L, L) < 0.5 gives +1, then randint(0, 2**30).

Magnetization per spin and energy -J sum s_i s_j over bonds are exact:
integer sums, divided by a power of two.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.philox import fold, to_int32, words

BLOCK_STRIDE = 1_000_033     # stream id step between blocks of sweeps


def threshold_table(J: float, temperature, bits: int) -> torch.Tensor:
    """(..., 9) int32 thresholds of neighbour sums -4..4 at ``bits`` bits,
    one row per temperature, from the float32 sigmoid on the CPU."""
    k = torch.arange(-4, 5, dtype=torch.float32)
    T = torch.as_tensor(temperature, dtype=torch.float32).cpu()[..., None]
    p = torch.sigmoid(2.0 * (J * k + 0.0) / T)
    scale = float(2**bits)
    return torch.clamp(p * scale, 0, scale - 1).to(torch.int32)


def initial_lattice(gen: torch.Generator, shape, device) -> torch.Tensor:
    up = torch.rand(shape, generator=gen) < 0.5
    return torch.where(up, 1, -1).to(torch.int8).to(device)


def neighbour_sum(s: torch.Tensor) -> torch.Tensor:
    """Sum of the four periodic neighbours over the last two axes."""
    return (torch.roll(s, 1, -2) + torch.roll(s, -1, -2)
            + torch.roll(s, 1, -1) + torch.roll(s, -1, -1))


def site_uniforms(w: torch.Tensor, red: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-site uniforms from (..., L, L/2) words: the low 16 bits for red
    sites, the high 16 for black, cut to their top ``bits``."""
    w = w.repeat_interleave(2, dim=-1)
    u = torch.where(red, w & 0xFFFF, w >> 16)
    return u >> (16 - bits)


def heat_bath(s, u, table, sites):
    """s with ``sites`` resampled: +1 where u < table[n + 4]."""
    n = neighbour_sum(s).to(torch.int64) + 4
    plus = u < table[n]
    return torch.where(sites, torch.where(plus, 1, -1).to(s.dtype), s)


def observables(s: torch.Tensor, J: float):
    """(magnetization per spin, energy), float64, of a (L, L) lattice."""
    t = s.to(torch.int64)
    bonds = (t * torch.roll(t, -1, -1)).sum() + (t * torch.roll(t, -1, -2)).sum()
    return t.sum().double() / t.numel(), -J * bonds.double()


def sample_observables(seed: int, shape, *, temperature: float, J: float = 1.0,
                       n_samples: int, n_burnin: int, n_sweeps: int, bits: int = 16,
                       device=None, batch: int = 8) -> dict:
    """Per-sample magnetization per spin and energy of the chain that
    ``seed`` starts: ``n_burnin`` sweeps, then ``n_samples`` blocks of
    ``n_sweeps``, each read after it. Returns float64 numpy arrays.
    ``batch`` sweeps draw their words together."""
    rows, cols = shape
    gen = torch.Generator().manual_seed(int(seed))
    s = initial_lattice(gen, shape, device)
    base = int(torch.randint(0, 2**30, (), generator=gen))
    r = torch.arange(rows, device=device)[:, None]
    c = torch.arange(cols, device=device)[None, :]
    red = (r + c) % 2 == 0
    ms = torch.empty(n_samples, dtype=torch.float64, device=device)
    es = torch.empty(n_samples, dtype=torch.float64, device=device)
    for i, n in enumerate([n_burnin] + [n_sweeps] * n_samples):
        k0 = fold(to_int32(base + i * BLOCK_STRIDE))
        tables = threshold_table(J, torch.full((n,), temperature), bits).to(device)
        for k in range(0, n, batch):
            ks = torch.arange(k, min(k + batch, n), dtype=torch.int64, device=device)
            u = site_uniforms(words(k0, ks[:, None, None], rows, cols // 2, device), red,
                              bits).to(torch.int32)
            for j in range(len(ks)):
                s = heat_bath(s, u[j], tables[k + j], red)
                s = heat_bath(s, u[j], tables[k + j], ~red)
        if i:
            ms[i - 1], es[i - 1] = observables(s, J)
    return {"magnetization": ms.cpu().numpy(), "energy": es.cpu().numpy(),
            "n_sites": rows * cols}


def gaps(program: dict, reference: dict) -> dict:
    """The compared numbers: over the samples, the largest gap of the total
    magnetization, in spins, and of the energy. A missing, misshapen or
    non-finite answer reads as the largest float."""
    n_sites = reference["n_sites"]
    out = {}
    for name, key, scale in (("m_gap_spins", "magnetization", n_sites), ("e_gap", "energy", 1)):
        got = np.asarray(program.get(key, ()), np.float64)
        want = reference[key]
        gap = (np.max(np.abs(got - want)) * scale if got.shape == want.shape
               else np.inf)
        out[name] = float(np.nan_to_num(gap, nan=np.finfo(np.float64).max,
                                        posinf=np.finfo(np.float64).max))
    return out
