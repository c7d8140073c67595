"""Checkerboard Gibbs sweeps with per-bond (disordered) couplings, plain
PyTorch.

Counterpart of ``tsu_tpu/ops/checkerboard_bonds.py``. Two bond planes over
the (R, C) lattice,

    Jh[r, c] couples (r, c) and (r, c+1)   (wraps at c = C-1)
    Jv[r, c] couples (r, c) and (r+1, c)   (wraps at r = R-1)

plus a per-site field, become per-colour weight planes (w_up, w_down,
w_left, w_right, f) in the compact (R, C/2) layout of
``tsu_tpu_torch/ops/checkerboard.py``. Open boundaries zero the weights that
cross an edge, so no sweep ever masks an edge. The ±J (discrete) form packs
one code per site, bits 2i..2i+1 holding w_i + 1 for (up, down, left,
right), as ``torch.uint8`` (values 0..170).

The hand-written bond kernels and their plain versions live in
``tsu_tpu_torch/ops/checkerboard_bonds_kernel.py``; the sweeps here draw
their uniforms from a ``torch.Generator``, as the JAX module's XLA path
draws from a key. ``sample_lattice_bonds`` and ``anneal_lattice_bonds`` run
on those kernels (a lattice on the CPU on their plain versions); they import
that module when called, since it imports this one. ``dense_from_bonds``
gives the dense coupling matrix of the bonds, for exact enumeration.
"""

from __future__ import annotations

import numpy as np
import torch

from tsu_tpu_torch import profiling
from tsu_tpu_torch.ops.checkerboard import (
    merge_checkerboard,
    sigmoid_table,
    split_checkerboard,
    wrap_halos,
)
from tsu_tpu_torch.rng import SEED_STRIDE, bond_key, to_int32


def _color_site_cols(R: int, C: int, color: int, device):
    """Global (row, column) of compact (row, j) for colour 0 = red, 1 = black."""
    r = torch.arange(R, device=device)[:, None]
    j = torch.arange(C // 2, device=device)[None, :]
    return r.expand(R, C // 2), 2 * j + (r + color) % 2


def color_bond_weights(Jh, Jv, field=0.0, periodic: bool = True) -> dict:
    """Per-colour weight planes ``{"red": (w_up, w_down, w_left, w_right,
    f), "black": (...)}``, each (R, C/2) float32 on the bonds' device. Open
    boundaries zero the out-of-lattice weights."""
    Jh = torch.as_tensor(Jh, dtype=torch.float32)
    Jv = torch.as_tensor(Jv, dtype=torch.float32, device=Jh.device)
    R, C = Jh.shape
    # A field from the host is copied in.
    profiling.count("host_syncs", not isinstance(field, torch.Tensor) or field.device.type == "cpu")
    field = torch.as_tensor(field, dtype=torch.float32, device=Jh.device).broadcast_to((R, C))
    out = {}
    for name, color in (("red", 0), ("black", 1)):
        r, c = _color_site_cols(R, C, color, Jh.device)
        w_up = Jv[(r - 1) % R, c]
        w_down = Jv[r, c]
        w_left = Jh[r, (c - 1) % C]
        w_right = Jh[r, c]
        if not periodic:
            w_up = torch.where(r == 0, 0.0, w_up)
            w_down = torch.where(r == R - 1, 0.0, w_down)
            w_left = torch.where(c == 0, 0.0, w_left)
            w_right = torch.where(c == C - 1, 0.0, w_right)
        out[name] = (w_up, w_down, w_left, w_right, field[r, c])
    return out


def pack_bond_codes(weights: dict) -> dict:
    """One ``torch.uint8`` code plane per colour from the weight planes of
    :func:`color_bond_weights`: bits (2i, 2i+1) hold w_i + 1 for (up, down,
    left, right), values 0..170. Raises unless every weight is in
    {-1, 0, +1} and the field is zero (the discrete contract)."""
    out = {}
    for color, (wu, wd, wl, wr, f) in weights.items():
        w = torch.stack([wu, wd, wl, wr]).float()
        in_range = bool(((w == -1) | (w == 0) | (w == 1)).all())
        profiling.count("host_syncs", 1 + in_range)   # the two reads of the checks
        if not (in_range and not bool(f.any())):
            raise ValueError("bond codes need every weight in {-1, 0, +1} and a zero field")
        code = (w[0] + 1) + (w[1] + 1) * 4 + (w[2] + 1) * 16 + (w[3] + 1) * 64
        out[color] = code.to(torch.uint8)
    return out


def _neighbor_values(other, up_row, down_row, update_red: bool):
    """The four neighbour-value planes (up, down, left, right) of one colour
    in the compact layout. The horizontal neighbours always wrap; open
    boundaries are the zeroed weights' business."""
    R = other.shape[-2]
    row_is_even = (torch.arange(R, device=other.device) % 2 == 0)[:, None]
    up = torch.cat([up_row, other[..., :-1, :]], dim=-2)
    down = torch.cat([other[..., 1:, :], down_row], dim=-2)
    left_shift = torch.roll(other, 1, dims=-1)
    right_shift = torch.roll(other, -1, dims=-1)
    pick = row_is_even if update_red else ~row_is_even
    left = torch.where(pick, left_shift, other)
    right = torch.where(pick, other, right_shift)
    return up, down, left, right


def local_field(other, weights, update_red: bool, periodic: bool):
    """Weighted neighbour sum plus field, float32, for every site of the
    colour that ``weights`` (its 5-tuple) belongs to:
    ((((w_up*up + w_down*down) + w_left*left) + w_right*right) + f), in
    that order, as the bond kernel adds it."""
    other = other.float()
    up, down, left, right = _neighbor_values(other, *wrap_halos(other, periodic), update_red)
    wu, wd, wl, wr, f = (w.float() for w in weights)
    return wu * up + wd * down + wl * left + wr * right + f


def halfstep_bonds(generator: torch.Generator, other, weights, update_red: bool,
                   temperature, periodic: bool):
    """Heat-bath resample of one colour with per-bond weights; uniforms from
    ``generator``, which must live on ``other``'s device."""
    local = local_field(other, weights, update_red, periodic)
    p_up = torch.sigmoid(2.0 * local / temperature)
    u = torch.rand(other.shape, generator=generator, device=other.device)
    return torch.where(u < p_up, 1.0, -1.0).to(other.dtype)


def checkerboard_sweeps_bonds(generator: torch.Generator, red, black, weights: dict,
                              temperature, n_sweeps: int, *, periodic: bool = True):
    """n_sweeps full red/black sweeps with per-bond couplings."""
    for _ in range(n_sweeps):
        red = halfstep_bonds(generator, black, weights["red"], True, temperature, periodic)
        black = halfstep_bonds(generator, red, weights["black"], False, temperature, periodic)
    return red, black


def lattice_energy_bonds(lattice, Jh, Jv, field=0.0, *, periodic: bool = True):
    """E = -sum_b J_b s_i s_j - sum_i h_i s_i over (..., R, C) lattices,
    float64."""
    s = torch.as_tensor(lattice).to(torch.float64)
    Jh = torch.as_tensor(Jh, device=s.device).to(torch.float64)
    Jv = torch.as_tensor(Jv, device=s.device).to(torch.float64)
    eh = Jh * s * torch.roll(s, -1, -1)
    ev = Jv * s * torch.roll(s, -1, -2)
    if not periodic:
        eh, ev = eh[..., :, :-1], ev[..., :-1, :]
    h = torch.as_tensor(field, device=s.device).to(torch.float64)
    return -(eh.sum((-2, -1)) + ev.sum((-2, -1))) - (h * s).sum((-2, -1))


def lattice_energy_bonds_planes(red, black, weights: dict, *, periodic: bool = True):
    """Per-replica energy from the compact (..., R, C/2) planes, float64.

    Every bond joins a red and a black site, so the pair energy is
    -sum_red s_i * (weighted black neighbours), each bond counted once; the
    field term sums both colours. Equal to ``lattice_energy_bonds`` of the
    merged lattice."""
    w_red = weights["red"]
    up, down, left, right = _neighbor_values(black, *wrap_halos(black, periodic), True)
    bond = (w_red[0] * up + w_red[1] * down + w_red[2] * left + w_red[3] * right)
    dims = (-2, -1)
    e = -(red * bond).sum(dims, dtype=torch.float64)
    return e - (w_red[4] * red).sum(dims, dtype=torch.float64) - (
        weights["black"][4] * black).sum(dims, dtype=torch.float64)


def sample_lattice_bonds(generator: torch.Generator, lattice0: torch.Tensor, Jh, Jv, *,
                         n_samples: int, temperature, field=0.0, n_burnin: int = 100,
                         n_sweeps: int = 1, periodic: bool = True,
                         collect: str = "states"):
    """Boltzmann-sample a (R, C) lattice with per-bond couplings (Jh, Jv).

    Sampling runs the bond kernel's continuous mode (exact sigmoid against
    24-bit uniforms) on float32 planes, as the JAX package does; the
    threshold table is the annealers' business. Call i (burn-in is call 0,
    sample block i is call 1 + i) draws from the stream id
    base + i * SEED_STRIDE, with base drawn from ``generator``.
    collect="states": returns (n_samples, R, C) on lattice0's device, in
    its dtype. collect="observables": returns ``{"magnetization",
    "energy"}``, (n_samples,) float64 tensors, per-spin magnetization and
    total energy.
    """
    from tsu_tpu_torch.ops.checkerboard_bonds_kernel import checkerboard_sweeps_bonds_kernel

    if collect not in ("states", "observables"):
        raise ValueError(f"collect must be 'states' or 'observables', got {collect!r}")
    device = lattice0.device
    weights = color_bond_weights(torch.as_tensor(Jh, dtype=torch.float32, device=device),
                                 torch.as_tensor(Jv, dtype=torch.float32, device=device),
                                 field, periodic)
    base = int(torch.randint(0, 2**30, (), generator=generator))
    red, black = split_checkerboard(lattice0.to(torch.float32))

    def sweeps(i, red, black, n):
        return checkerboard_sweeps_bonds_kernel(to_int32(base + i * SEED_STRIDE), red, black,
                                                weights, temperature, n, periodic=periodic)

    red, black = sweeps(0, red, black, n_burnin)
    R, C = lattice0.shape
    if collect == "states":
        out = torch.empty((n_samples, R, C), dtype=lattice0.dtype, device=device)
    else:
        ms = torch.empty(n_samples, dtype=torch.float64, device=device)
        es = torch.empty(n_samples, dtype=torch.float64, device=device)
    for i in range(n_samples):
        red, black = sweeps(1 + i, red, black, n_sweeps)
        if collect == "states":
            out[i] = merge_checkerboard(red, black)
        else:
            ms[i] = (red.sum(dtype=torch.float64) + black.sum(dtype=torch.float64)) / (R * C)
            es[i] = lattice_energy_bonds_planes(red, black, weights, periodic=periodic)
    return out if collect == "states" else {"magnetization": ms, "energy": es}


def _in_pm1_or_zero(J: torch.Tensor) -> bool:
    profiling.count("host_syncs")
    return bool(((J == -1) | (J == 0) | (J == 1)).all())


def discrete_table_applicable(Jh, Jv, field) -> bool:
    """True when the ±J threshold-table path is exact: every bond in
    {-1, 0, +1} and a zero field, so the local field stays on the integers
    -4..4 that the 9-entry table covers. A non-zero field, even an integer
    one, moves it to ±5, off the table."""
    return (_in_pm1_or_zero(torch.as_tensor(Jh)) and _in_pm1_or_zero(torch.as_tensor(Jv))
            and float(field) == 0.0)


def anneal_lattice_bonds(seed: int, lattice0: torch.Tensor, Jh, Jv, *, T_initial=5.0,
                         T_final=0.05, n_steps: int = 1000, field=0.0, periodic: bool = True,
                         schedule=None, track_every: int = 1):
    """Simulated annealing of lattice0 with per-bond couplings, one sweep of
    the bond half-sweep kernel per temperature of ``schedule`` (default
    n_steps temperatures geometric from T_initial to T_final), the best
    state tracked every ``track_every`` sweeps. Returns (best (R, C) float32
    lattice, its ``lattice_energy_bonds`` as a float64 0-d tensor), both on
    lattice0's device.

    Bonds in {-1, 0, +1} with a zero field take the discrete mode (code
    planes, bfloat16 spins, a 24-bit table per sweep), others the continuous
    one (float32 weights and spins). Chunk i of ``track_every`` sweeps draws
    from the stream id seed + i * SEED_STRIDE, its half-sweeps keyed
    (fold_seed(id, colour), sweep within the chunk).
    """
    from tsu_tpu_torch.ops.checkerboard_bonds_kernel import bond_kernel_weights, bond_sweeps

    device = lattice0.device
    Jh = torch.as_tensor(Jh, dtype=torch.float32, device=device)
    Jv = torch.as_tensor(Jv, dtype=torch.float32, device=device)
    if schedule is None:
        schedule = np.geomspace(T_initial, T_final, n_steps)
    schedule = np.asarray(schedule, np.float32)
    n_steps = len(schedule)
    discrete = discrete_table_applicable(Jh, Jv, field)
    weights = color_bond_weights(Jh, Jv, field, periodic)
    kernel_weights = bond_kernel_weights(weights, discrete)
    tables = sigmoid_table(1.0, 0.0, torch.from_numpy(schedule)).to(device) if discrete else None
    red, black = split_checkerboard(lattice0.to(torch.bfloat16 if discrete else torch.float32))
    best_r, best_b = red, black
    best_e = lattice_energy_bonds_planes(red, black, weights, periodic=periodic)
    for i, g in enumerate(range(0, n_steps, track_every)):
        n = min(track_every, n_steps - g)
        chunk_seed = to_int32(seed + i * SEED_STRIDE)
        keys = [[bond_key(chunk_seed, c, k) for c in (0, 1)] for k in range(n)]
        red, black = bond_sweeps(red, black, kernel_weights, keys,
                                 temperatures=schedule[g:g + n],
                                 tables=None if tables is None else tables[g:g + n],
                                 periodic=periodic)
        e = lattice_energy_bonds_planes(red, black, weights, periodic=periodic)
        better = e < best_e
        best_r = torch.where(better, red, best_r)
        best_b = torch.where(better, black, best_b)
        best_e = torch.minimum(e, best_e)
    lattice = merge_checkerboard(best_r, best_b).float()
    return lattice, lattice_energy_bonds(lattice, Jh, Jv, field, periodic=periodic)


def dense_from_bonds(Jh, Jv, periodic: bool = True) -> np.ndarray:
    """Dense (N, N) float64 coupling matrix of the bond planes, N = R * C,
    site (r, c) at index r * C + c: the oracle's input for exact
    enumeration. Open boundaries drop the bonds that cross an edge. The
    bonds may be numpy arrays or tensors on any device; each bond is added
    in the reference's order, so the matrix equals its bit for bit."""
    Jh, Jv = (b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
              for b in (Jh, Jv))
    R, C = Jh.shape
    site = np.arange(R * C)
    r, c = np.divmod(site, C)
    right = r * C + (c + 1) % C
    down = ((r + 1) % R) * C + c
    keep_h = (c + 1 < C) | periodic
    keep_v = (r + 1 < R) | periodic
    # Per site, in order: its right bond both ways, then its down bond both ways.
    rows = np.stack([site, right, site, down], axis=1)
    cols = np.stack([right, site, down, site], axis=1)
    vals = np.stack([Jh.ravel(), Jh.ravel(), Jv.ravel(), Jv.ravel()], axis=1)
    keep = np.stack([keep_h, keep_h, keep_v, keep_v], axis=1)
    J = np.zeros((R * C, R * C), dtype=np.float64)
    np.add.at(J, (rows[keep], cols[keep]), vals[keep].astype(np.float64))
    return J
