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
draws from a key.
"""

from __future__ import annotations

import torch

from tsu_tpu_torch.ops.checkerboard import wrap_halos


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
        if not (bool(((w == -1) | (w == 0) | (w == 1)).all()) and not bool(f.any())):
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
