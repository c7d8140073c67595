"""Checkerboard (red/black) Gibbs sweeps for 2-D Ising lattices, plain PyTorch.

Counterpart of ``tsu_tpu/ops/checkerboard.py``: the compact layout, the
neighbour sums and the 9-entry threshold tables (:func:`sigmoid_table`,
:func:`sigmoid_table16`) that the lattice kernels and their plain versions
share, and the plain heat-bath path with an exact sigmoid and uniforms from a
``torch.Generator``.

Layout: for row i, red plane column j2 holds lattice column 2*j2 + (i % 2);
black plane column j2 holds 2*j2 + 1 - (i % 2). Horizontal neighbours of a
red site are black-plane columns {j2 - 1 + (i % 2), j2 + (i % 2)}; vertical
neighbours are the black plane at rows i±1, same column j2. In this layout an
open boundary is a zero halo in compact index space and a periodic one a wrap.
"""

from __future__ import annotations

import torch


def _table(J: float, field: float, temperature, scale: float) -> torch.Tensor:
    k = torch.arange(-4, 5, dtype=torch.float32)
    T = torch.as_tensor(temperature, dtype=torch.float32).cpu()[..., None]
    p = torch.sigmoid(2.0 * (J * k + field) / T)
    return torch.clamp(p * scale, 0, scale - 1).to(torch.int32)


def sigmoid_table(J: float, field: float, temperature) -> torch.Tensor:
    """(..., 9) int32 24-bit thresholds for neighbour sums -4..4, one row per
    temperature; computed on the CPU in float32."""
    return _table(J, field, temperature, 16777216.0)


def sigmoid_table16(J: float, field: float, temperature) -> torch.Tensor:
    """(..., 9) int32 16-bit thresholds matching the 16-bit uniforms of the
    fused sweep; computed on the CPU in float32."""
    return _table(J, field, temperature, 65536.0)


def _row_is_even(R: int, device) -> torch.Tensor:
    return (torch.arange(R, device=device) % 2 == 0)[:, None]


def split_checkerboard(lattice: torch.Tensor):
    """(..., R, C) lattice -> (red, black) planes of shape (..., R, C/2)."""
    R, C = lattice.shape[-2:]
    if C % 2:
        raise ValueError("lattice width must be even for checkerboard layout")
    even_cols = lattice[..., :, 0::2]
    odd_cols = lattice[..., :, 1::2]
    row_is_even = _row_is_even(R, lattice.device)
    red = torch.where(row_is_even, even_cols, odd_cols)
    black = torch.where(row_is_even, odd_cols, even_cols)
    return red, black


def merge_checkerboard(red: torch.Tensor, black: torch.Tensor) -> torch.Tensor:
    """Inverse of split_checkerboard: (..., R, C/2) x2 -> (..., R, C)."""
    R, C2 = red.shape[-2:]
    row_is_even = _row_is_even(R, red.device)
    even_cols = torch.where(row_is_even, red, black)
    odd_cols = torch.where(row_is_even, black, red)
    out = torch.stack([even_cols, odd_cols], dim=-1)
    return out.reshape(*red.shape[:-1], 2 * C2)


def neighbor_sum_half_halo(other: torch.Tensor, up_row: torch.Tensor,
                           down_row: torch.Tensor, update_red: bool,
                           periodic_cols: bool) -> torch.Tensor:
    """4-neighbour sum for every site of one colour, given the other colour's
    plane (..., R, C/2) and its vertical halo rows (..., 1, C/2): the wrap
    rows of a periodic lattice, zeros for an open one. R must be even."""
    R, C2 = other.shape[-2:]
    row_is_even = _row_is_even(R, other.device)

    up = torch.cat([up_row, other[..., :-1, :]], dim=-2)
    down = torch.cat([other[..., 1:, :], down_row], dim=-2)
    left_shift = torch.roll(other, 1, dims=-1)    # brings column j2-1 to j2
    right_shift = torch.roll(other, -1, dims=-1)  # brings column j2+1 to j2

    if update_red:
        horiz = torch.where(row_is_even, left_shift + other, other + right_shift)
    else:
        horiz = torch.where(row_is_even, other + right_shift, left_shift + other)

    if not periodic_cols:
        # Replace a sum whose shifted operand wrapped around the lattice edge
        # by the in-bounds neighbour alone.
        col = torch.arange(C2, device=other.device)[None, :]
        if update_red:
            wrap_left = row_is_even & (col == 0)
            wrap_right = ~row_is_even & (col == C2 - 1)
        else:
            wrap_left = ~row_is_even & (col == 0)
            wrap_right = row_is_even & (col == C2 - 1)
        horiz = torch.where(wrap_left | wrap_right, other, horiz)

    return up + down + horiz


def neighbor_sum_half_halo2d(other: torch.Tensor, up_row: torch.Tensor,
                             down_row: torch.Tensor, left_col: torch.Tensor,
                             right_col: torch.Tensor, update_red: bool) -> torch.Tensor:
    """4-neighbour sum with halos on all four sides (a shard of a row and
    column sharded lattice). ``left_col``/``right_col`` are (..., R, 1): the
    compact columns next to the shard's first and last one (the neighbour
    shard's, the wrap columns, or zeros at an open edge, which add nothing,
    so nothing is masked). The row-parity rule does not depend on the
    column offset, so any split of the compact columns works."""
    R = other.shape[-2]
    row_is_even = _row_is_even(R, other.device)
    up = torch.cat([up_row, other[..., :-1, :]], dim=-2)
    down = torch.cat([other[..., 1:, :], down_row], dim=-2)
    left_shift = torch.cat([left_col, other[..., :, :-1]], dim=-1)
    right_shift = torch.cat([other[..., :, 1:], right_col], dim=-1)
    if update_red:
        horiz = torch.where(row_is_even, left_shift + other, other + right_shift)
    else:
        horiz = torch.where(row_is_even, other + right_shift, left_shift + other)
    return up + down + horiz


def halfstep_with_halo2d(generator: torch.Generator, other, up_row, down_row,
                         left_col, right_col, update_red, temperature, J, field):
    """Heat-bath resample of one colour of a shard with four-sided halos.

    ``generator`` must live on ``other``'s device.
    """
    nbr = neighbor_sum_half_halo2d(other, up_row, down_row, left_col, right_col,
                                   update_red)
    p_up = torch.sigmoid(2.0 * (J * nbr.float() + field) / temperature)
    u = torch.rand(other.shape, generator=generator, device=other.device)
    return torch.where(u < p_up, 1.0, -1.0).to(other.dtype)


def wrap_halos(plane: torch.Tensor, periodic: bool):
    """Single-device vertical halo rows: periodic wrap or zeros (open)."""
    if periodic:
        return plane[..., -1:, :], plane[..., :1, :]
    z = torch.zeros_like(plane[..., :1, :])
    return z, z


def neighbor_sum_half(other: torch.Tensor, update_red: bool,
                      periodic: bool) -> torch.Tensor:
    """Single-device neighbour sum (wrapped or open boundaries)."""
    up_row, down_row = wrap_halos(other, periodic)
    return neighbor_sum_half_halo(other, up_row, down_row, update_red, periodic)


def halfstep_with_halo(generator: torch.Generator, other, up_row, down_row,
                       update_red, temperature, J, field, periodic_cols):
    """Heat-bath resample of one colour plane given the other + halo rows.

    ``generator`` must live on ``other``'s device.
    """
    nbr = neighbor_sum_half_halo(other, up_row, down_row, update_red,
                                 periodic_cols)
    p_up = torch.sigmoid(2.0 * (J * nbr.float() + field) / temperature)
    u = torch.rand(other.shape, generator=generator, device=other.device)
    return torch.where(u < p_up, 1.0, -1.0).to(other.dtype)


def checkerboard_sweeps_planes(generator: torch.Generator, red, black,
                               temperature, n_sweeps: int, *, J=1.0,
                               field=0.0, periodic=True):
    """n_sweeps full red/black sweeps on compact planes; returns (red, black).

    ``temperature``: a scalar, or an (n_sweeps,) per-sweep schedule.
    """
    temps = torch.as_tensor(temperature, dtype=torch.float32).reshape(-1).to(
        black.device).broadcast_to((n_sweeps,))
    for k in range(n_sweeps):
        up, down = wrap_halos(black, periodic)
        red = halfstep_with_halo(generator, black, up, down, True, temps[k],
                                 J, field, periodic)
        up, down = wrap_halos(red, periodic)
        black = halfstep_with_halo(generator, red, up, down, False, temps[k],
                                   J, field, periodic)
    return red, black


def checkerboard_sweeps(generator: torch.Generator, lattice, temperature,
                        n_sweeps: int, *, J=1.0, field=0.0, periodic=True):
    """n_sweeps full checkerboard sweeps on a (R, C) spin lattice."""
    red, black = split_checkerboard(lattice)
    red, black = checkerboard_sweeps_planes(
        generator, red, black, temperature, n_sweeps, J=J, field=field,
        periodic=periodic)
    return merge_checkerboard(red, black)


def lattice_energy_batch(lattice: torch.Tensor, *, J=1.0, field=0.0,
                         periodic=True) -> torch.Tensor:
    """Stencil Ising energy over (..., R, C); reduces the trailing 2 axes.

    float64, so that sums past 2^24 stay exact.
    """
    s = lattice.to(torch.float64)
    dims = (-2, -1)
    if periodic:
        bond = (s * torch.roll(s, -1, -1)).sum(dims) + (
            s * torch.roll(s, -1, -2)).sum(dims)
    else:
        bond = (s[..., :, :-1] * s[..., :, 1:]).sum(dims) + (
            s[..., :-1, :] * s[..., 1:, :]).sum(dims)
    return -J * bond - field * s.sum(dims)


def plane_energy_batch(red: torch.Tensor, black: torch.Tensor, *, J=1.0,
                       field=0.0, periodic=True) -> torch.Tensor:
    """lattice_energy_batch of merge_checkerboard(red, black), taken from the
    (..., R, C/2) planes without merging them: every bond joins a red site to
    a black one, so the bond sum is red times its black neighbour sum. The
    products are small integers, exact in the planes' dtype; the sums are
    float64."""
    dims = (-2, -1)
    bond = (red * neighbor_sum_half(black, True, periodic)).sum(dims, dtype=torch.float64)
    e = -J * bond
    if field:
        e = e - field * (red.sum(dims, dtype=torch.float64) + black.sum(dims, dtype=torch.float64))
    return e


def sample_lattice(generator: torch.Generator, lattice0, *, n_samples: int,
                   temperature, J=1.0, field=0.0, n_burnin: int = 100,
                   n_sweeps: int = 1, periodic: bool = True,
                   collect: str = "states"):
    """Boltzmann-sample a 2-D lattice with the plain checkerboard Gibbs path.

    collect="states": returns (n_samples, R, C) spin configurations.
    collect="observables": returns a dict of per-sample magnetization per
    spin and total energy.
    """
    if collect not in ("states", "observables"):
        raise ValueError(f"collect must be 'states' or 'observables', got {collect!r}")
    red, black = split_checkerboard(lattice0)
    red, black = checkerboard_sweeps_planes(
        generator, red, black, temperature, n_burnin, J=J, field=field,
        periodic=periodic)
    states = []
    for _ in range(n_samples):
        red, black = checkerboard_sweeps_planes(
            generator, red, black, temperature, n_sweeps, J=J, field=field,
            periodic=periodic)
        states.append(merge_checkerboard(red, black))
    states = torch.stack(states)
    if collect == "states":
        return states
    R, C = lattice0.shape[-2:]
    return {
        "magnetization": states.to(torch.float64).sum((-2, -1)) / (R * C),
        "energy": lattice_energy_batch(states, J=J, field=field,
                                       periodic=periodic),
    }
