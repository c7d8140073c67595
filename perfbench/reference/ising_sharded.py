"""Plain reference of the sharded ferromagnet's chain, checked by a light-cone
replay of strips: rows of the final state of ``IsingGrid.sample_observables(
..., mesh=..., initial="mesh")``, worked out again from the seed without the
whole lattice.

The chain. A CPU ``torch.Generator`` seeded with the call's seed gives
draw_base, then run_base, each randint(0, 2**31 - 1). The start: compact
site (r, c) of the red and black planes (lattice site (r, col) is red when
r + col is even, and its compact column is col // 2) takes the
Philox4x32-10 word at counter (r, c // 4), output c % 4, under the key
(fold(draw_base), DRAW_TAG): red +1 iff bit 15 of the word is clear, black
+1 iff bit 31 is. Sweep s of the run (the burn-in's first, then each
sample's block, counted on) resamples red, then black, by the heat-bath
rule of ``reference/ising.py`` from the words under (fold(run_base), s):
+1 iff u < t[n + 4], n the four neighbours' sum, u the word's low 16 bits
for red and high 16 for black, cut to their top ``bits``, t the float32
sigmoid(2 J k / T) thresholds at ``bits`` bits, one (9,) table.

The replay. A site after n sweeps depends on the start only within 2n rows
of it (a sweep's red reads black one row away, its black the new red one
row away). So a strip of rows is replayed alone, whole rows wide, with
2n + 2 more rows on each side, wrapped onto itself: the wrong values its
wrapped edges bring in travel at most 2 rows a sweep and never reach its
centre rows, which equal the whole lattice's. Where a strip would hold the
whole lattice, the whole lattice is replayed.

The sums. The strips hold no sample's magnetization or energy, so the
last sample's are held against the program's own final planes, summed
again here with plain PyTorch (:func:`lattice_sums`) before the call lets
them go: exactly, where a float32 or int32 total of the cell's 6.9e10
sites would not be.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.ising import heat_bath, site_uniforms, threshold_table
from perfbench.reference.philox import fold, philox

DRAW_TAG = 0xD1A35EED        # the draw's second key word (the program's rng.DRAW_TAG)
BLOCK_ROWS = 8192            # rows a block of lattice_sums


def bases(seed: int) -> tuple:
    """(draw_base, run_base) of the call with ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    return tuple(int(torch.randint(0, 2**31 - 1, (), generator=gen)) for _ in range(2))


def words_at(k0, k1, rows: torch.Tensor, cols: int) -> torch.Tensor:
    """(len(rows), cols) int64 words: entry (i, q) is output q % 4 of Philox
    at counter (rows[i], q // 4, 0, 0) under the key (k0, k1)."""
    quads = -(-cols // 4)
    r = rows.to(torch.int64)[:, None]
    q = torch.arange(quads, dtype=torch.int64, device=rows.device)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=rows.device)
    out = philox(r + 0 * q, q + 0 * r, zero, zero, k0, k1)
    return torch.stack(out, dim=-1).flatten(-2)[..., :cols]


def red_mask(rows: torch.Tensor, cols: int) -> torch.Tensor:
    """(len(rows), cols) bool: the red sites of the global ``rows``."""
    c = torch.arange(cols, device=rows.device)
    return (rows[:, None] + c[None, :]) % 2 == 0


def start_rows(draw_base: int, rows: torch.Tensor, cols: int) -> torch.Tensor:
    """The start's global ``rows``, (len(rows), cols) int8 spins."""
    w = words_at(fold(draw_base), DRAW_TAG, rows, cols // 2).repeat_interleave(2, dim=-1)
    bit = torch.where(red_mask(rows, cols), 0x8000, 0x80000000)
    return torch.where((w & bit) == 0, 1, -1).to(torch.int8)


def compact(lattice_rows: torch.Tensor, rows: torch.Tensor) -> tuple:
    """(red, black) compact planes of (n, cols) lattice rows at the global
    ``rows``."""
    odd = (rows % 2)[:, None]
    even_cols, odd_cols = lattice_rows[:, 0::2], lattice_rows[:, 1::2]
    return (torch.where(odd == 0, even_cols, odd_cols),
            torch.where(odd == 0, odd_cols, even_cols))


def final_rows(seed: int, shape, first_rows, *, n_rows: int, temperature: float, J: float,
               n_sweeps: int, bits: int = 16, device=None) -> dict:
    """Rows ``first + i`` (i < n_rows, wrapped) of the chain's final state for
    each ``first`` of ``first_rows``, after ``n_sweeps`` sweeps of the run.
    Returns ``{"rows": the global rows, "red", "black": (len(rows), cols // 2)
    int8 CPU tensors}``."""
    L, cols = shape
    draw_base, run_base = bases(seed)
    margin = 2 * n_sweeps + 2
    height = n_rows + 2 * margin
    firsts = torch.as_tensor(list(first_rows), dtype=torch.int64, device=device)
    if height >= L:      # one strip: the whole lattice
        strips = torch.arange(L, dtype=torch.int64, device=device)[None]
        centre = (firsts[:, None] + torch.arange(n_rows, device=device)[None]) % L
        pick = torch.zeros_like(centre), centre
    else:
        strips = (firsts[:, None] - margin + torch.arange(height, device=device)[None]) % L
        pick = (torch.arange(len(firsts), device=device)[:, None].expand(-1, n_rows),
                margin + torch.arange(n_rows, device=device)[None].expand(len(firsts), -1))
    flat = strips.reshape(-1)
    s = start_rows(draw_base, flat, cols).reshape(*strips.shape, cols)
    red = red_mask(flat, cols).reshape(s.shape)
    table = threshold_table(J, temperature, bits).to(device)
    k0 = fold(run_base)
    for k in range(n_sweeps):
        u = site_uniforms(words_at(k0, k, flat, cols // 2), red.reshape(-1, cols), bits)
        u = u.to(torch.int32).reshape(s.shape)
        s = heat_bath(s, u, table, red)
        s = heat_bath(s, u, table, ~red)
    got_rows = strips[pick[0], pick[1]].reshape(-1)
    got = s[pick[0], pick[1]].reshape(-1, cols)
    r, b = compact(got, got_rows)
    return {"rows": got_rows.cpu().tolist(), "red": r.cpu(), "black": b.cpu()}


def lattice_sums(shards, block: int = BLOCK_ROWS) -> tuple:
    """Exact (spin sum, bond sum), Python ints, of a periodic lattice held as
    row shards [(red, black), ...] in order, each (R, C/2) compact planes
    with R even on its own device. Each shard is summed a block of rows at
    a time beside it, the black rows around the shard from its neighbours,
    and every card's work is queued before any total is read, so the cards
    sum at once. Each bond is
    counted at its red site: the red spin times the black ones above and
    below it and, in its own row, at compact columns c - 1 and c (even
    rows) or c and c + 1 (odd rows). Every value on the way is an integer
    of at most 4 in size, exact in the planes' dtype; a row's sum, at most
    4 C/2, is exact in float32 below 2**24; the rows are added in int64."""
    n = len(shards)
    # The rows around each shard first: a copy between cards waits for the
    # work queued on its source card, so taken later it would make each
    # card wait for its neighbour's sums.
    halos = [(shards[(i - 1) % n][1][-1].to(red.device), shards[(i + 1) % n][1][0].to(red.device))
             for i, (red, _) in enumerate(shards)]
    totals = []
    for (red, black), (above, below) in zip(shards, halos):
        R, C2 = red.shape
        if R % 2 or block % 2 or 4 * C2 >= 2**24:
            raise ValueError(f"shards of even rows and a row under 2**22 sites, got {R} x {C2}")
        total = torch.zeros(2, dtype=torch.int64, device=red.device)
        for a in range(0, R, block):
            b = min(a + block, R)
            r, k = red[a:b], black[a:b]
            nbr = torch.empty_like(k)
            torch.add(k[:-2], k[2:], out=nbr[1:-1])
            nbr[0] = (black[a - 1] if a else above) + k[1]
            nbr[-1] = k[-2] + (black[b] if b < R else below)
            nbr += k
            nbr[0::2, 1:] += k[0::2, :-1]
            nbr[0::2, 0] += k[0::2, -1]
            nbr[1::2, :-1] += k[1::2, 1:]
            nbr[1::2, -1] += k[1::2, 0]
            nbr *= r
            rows = torch.stack([r.sum(1, dtype=torch.float32) + k.sum(1, dtype=torch.float32),
                                nbr.sum(1, dtype=torch.float32)])
            total += rows.to(torch.int64).sum(1)
        totals.append(total)
    spins, bonds = (sum(v) for v in zip(*(t.tolist() for t in totals)))
    return spins, bonds


def final_sample_differing(program: dict, n_sites: int, J: float, field: float = 0.0) -> int:
    """How many of the last sample's magnetization and energy differ from
    m = spin / N and E = -J bond - field spin, formed in float64 from the
    plain sums of the call's final planes (``program["final_sums"]``, from
    :func:`lattice_sums`); both, when either is missing."""
    m, e = program.get("magnetization"), program.get("energy")
    sums = program.get("final_sums")
    if sums is None or m is None or e is None or not len(m) or not len(e):
        return 2
    spins, bonds = sums
    want = (spins / n_sites, -J * float(bonds) - field * float(spins))
    got = (float(np.asarray(m).reshape(-1)[-1]), float(np.asarray(e).reshape(-1)[-1]))
    return sum(g != w for g, w in zip(got, want))


def observables_invalid(m, e, n_sites: int, n_samples: int, J: float = 1.0) -> int:
    """Samples whose magnetization m is no s / N with s an integer of N's
    parity in [-N, N], or whose energy -J b has no bond sum b that is a
    multiple of 4 in [-2N, 2N] (b = 2N - 2U with U bonds unsatisfied, and on
    a periodic lattice of even sides every row and column holds an even
    number of them); missing samples count too."""
    m = np.asarray(m, np.float64).reshape(-1)
    e = np.asarray(e, np.float64).reshape(-1)
    bad = max(n_samples - min(len(m), len(e)), 0)
    for mi, ei in zip(m[:n_samples], e[:n_samples]):
        s = np.round(mi * n_sites) if np.isfinite(mi) else np.nan
        b = np.round(-ei / J) if np.isfinite(ei) else np.nan
        ok = (np.isfinite(s) and s / n_sites == mi and abs(s) <= n_sites
              and (s - n_sites) % 2 == 0
              and np.isfinite(b) and -J * b == ei and abs(b) <= 2 * n_sites and b % 4 == 0)
        bad += not ok
    return int(bad)


def gaps(program: dict, reference: dict, n_sites: int, n_samples: int, J: float,
         field: float = 0.0) -> dict:
    """The compared numbers: sites of the reference's rows where the
    program's final rows differ (all of them for a missing or misshapen
    answer), :func:`observables_invalid` of its samples, and
    :func:`final_sample_differing` of its last one."""
    want_r, want_b = reference["red"], reference["black"]
    got = program.get("final_rows")
    if got is None or tuple(got[0].shape) != tuple(want_r.shape) \
            or tuple(got[1].shape) != tuple(want_b.shape):
        differing = 2 * want_r.numel()
    else:
        differing = int((torch.as_tensor(got[0]) != want_r).sum()
                        + (torch.as_tensor(got[1]) != want_b).sum())
    return {"strip_sites_differing": float(differing),
            "observables_invalid": float(observables_invalid(
                program.get("magnetization", ()), program.get("energy", ()), n_sites,
                n_samples, J)),
            "final_sample_differing": float(final_sample_differing(program, n_sites, J, field))}
