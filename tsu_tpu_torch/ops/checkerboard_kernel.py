"""Exact-sigmoid checkerboard half-sweeps on a hand-written CUDA kernel.

Counterpart of ``tsu_tpu/ops/checkerboard_pallas.py``. ``halfsweep`` wraps
the kernel of ``tsu_tpu_torch/csrc/checkerboard_halfsweep.cu``: on a CUDA
tensor it launches the kernel, on a CPU tensor it runs
``halfsweep_reference``, the plain PyTorch version. The kernel computes the
nine values p can take in a launch once per block and compares each site's
uniform with a 24-bit threshold (:func:`halfsweep_thresholds`), which gives
the same result as comparing it with p.

A half-sweep resamples one colour of the compact planes from the other
colour's (R, C/2) plane and its halos: the rows above its first and below
its last row (the wrap rows of one lattice, the neighbour shard's rows, or
zeros at an open edge) and, for a shard of a column-sharded lattice, the
compact columns left and right of it. p = sigmoid(2 * (J * nbr + field) / T)
in float32 and the site is +1 if u24 * 2^-24 < p. torch's, JAX's and
CUDA's ``exp`` may differ by an ulp, so two right implementations may
disagree where |u - p| is within ``CONTINUOUS_BAND``; everywhere else they
agree (:func:`halfsweep_band` marks those sites).

Uniforms are 24 bits: the top 24 bits of the site's Philox4x32-10 word at
counter (global row, global col // 4) under the launch's key, or injected
(R, C/2) int32 in [0, 2^24). A sweep keys its half-sweep of colour c as
(fold_seed(seed, c), sweep) (:func:`~tsu_tpu_torch.rng.bond_key`).
The TPU kernel's row blocks and its 8-row and 128-lane halo tiles are TPU
tiling and have no counterpart.
"""

from __future__ import annotations

import torch

from tsu_tpu_torch.ops._build import (
    CONTINUOUS_BAND,
    MAX_ROWS,
    PLANE_DTYPES,
    call,
    check_on,
    library,
)
from tsu_tpu_torch.ops.checkerboard import (
    neighbor_sum_half_halo,
    neighbor_sum_half_halo2d,
    wrap_halos,
)
from tsu_tpu_torch.rng import MASK32, bond_key, philox_words

_U24_SCALE = 1.0 / 16777216.0

__all__ = ["CONTINUOUS_BAND", "checkerboard_sweeps_planes_kernel", "halfsweep",
           "halfsweep_band", "halfsweep_reference", "halfsweep_thresholds"]


def _check(other, up_row, down_row, left_col, right_col, uniforms, row0: int, col0: int):
    """Raise unless the operands fit the kernel: other (R, C2) float32 or
    bfloat16 with R even; halo rows C2 values and column halos R values of
    other's dtype; uniforms (R, C2) int32; offsets >= 0, the row offset
    even."""
    if other.dim() != 2 or other.dtype not in PLANE_DTYPES:
        raise ValueError(f"the other plane must be 2-D float32 or bfloat16, got "
                         f"{tuple(other.shape)} {other.dtype}")
    R, C2 = other.shape
    if R < 2 or R % 2 or R > MAX_ROWS or C2 < 1:
        raise ValueError(f"plane shape must be (even R in 2..{MAX_ROWS}, C/2 >= 1), got {(R, C2)}")
    if row0 % 2 or row0 < 0 or col0 < 0:
        raise ValueError(f"a shard must start on an even global row and a column >= 0, got "
                         f"{(row0, col0)}")
    if (left_col is None) != (right_col is None):
        raise ValueError("left_col and right_col must be given together")
    for name, t, n in (("up_row", up_row, C2), ("down_row", down_row, C2),
                       ("left_col", left_col, R), ("right_col", right_col, R)):
        if t is not None and (t.numel() != n or t.dtype != other.dtype):
            raise ValueError(f"{name} must hold {n} values of {other.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if uniforms is not None and (uniforms.shape != (R, C2) or uniforms.dtype != torch.int32):
        raise ValueError(f"uniforms must be {(R, C2)} int32, got "
                         f"{tuple(uniforms.shape)} {uniforms.dtype}")


def _column_stride(name: str, col, R: int) -> int:
    """The elements between the R values of a column halo, which lie along
    one dimension: a contiguous (R,) or (R, 1) tensor, or an (R, 1) column of
    the neighbour shard's plane read in place."""
    dims = [d for d, n in enumerate(col.shape) if n != 1]
    if len(dims) != 1 or col.shape[dims[0]] != R:
        raise ValueError(f"{name} must be a column of {R} values, got {tuple(col.shape)}")
    return col.stride(dims[0])


def _kernel_operands(other, up_row, down_row, left_col, right_col, uniforms) -> tuple:
    """Raise unless every operand lies on ``other``'s device, contiguous but
    for the column halos, which may be strided columns; returns the column
    halos' strides (0 without them)."""
    check_on(other.device, other=other, up_row=up_row, down_row=down_row, uniforms=uniforms)
    strides = []
    for name, col in (("left_col", left_col), ("right_col", right_col)):
        if col is None:
            strides.append(0)
            continue
        if col.device != other.device:
            raise ValueError(f"{name} must lie on {other.device}")
        strides.append(_column_stride(name, col, other.shape[0]))
    return tuple(strides)


def halfsweep_thresholds(J: float, field: float, temperature) -> torch.Tensor:
    """The kernel's threshold table, (9,) int64: entry nbr + 4, nbr = -4..4,
    is t = ceil(p * 2^24) of the float32 p = 1 / (1 + exp(-2 (J nbr + field)
    / T)), in 0..2^24 (0 where p is 0 or not a number). u24 * 2^-24 and
    p * 2^24 are exact in float32, so u24 < t exactly when u24 * 2^-24 < p."""
    n = torch.arange(-4, 5, dtype=torch.float32)
    T = torch.full((), float(temperature), dtype=torch.float32)
    local = n * float(J) + float(field)
    p = 1.0 / (1.0 + torch.exp(-(2.0 * local) / T))
    t = torch.ceil(p * 16777216.0).to(torch.int64)
    return torch.where(p > 0, t, 0)


def _probability(other, up_row, down_row, left_col, right_col, update_red, periodic,
                 J, field, temperature) -> torch.Tensor:
    """float32 p = sigmoid(2 * (J * nbr + field) / T) of every site."""
    R, C2 = other.shape
    o = other.float()
    up, down = up_row.float().reshape(1, C2), down_row.float().reshape(1, C2)
    if left_col is not None:
        nbr = neighbor_sum_half_halo2d(o, up, down, left_col.float().reshape(R, 1),
                                       right_col.float().reshape(R, 1), update_red)
    else:
        nbr = neighbor_sum_half_halo(o, up, down, update_red, periodic)
    # T as a tensor on the plane's device, so that the division by T is a
    # true division on every device.
    T = torch.full((), float(temperature), dtype=torch.float32, device=other.device)
    return torch.sigmoid(2.0 * (J * nbr + field) / T)


def _u24(key, R: int, C2: int, row0: int, col0: int, device) -> torch.Tensor:
    rows = row0 + torch.arange(R, dtype=torch.int64)
    return philox_words(key[0], key[1], R, C2, device=device, rows=rows, col0=col0) >> 8


def halfsweep_reference(other, up_row, down_row, *, update_red: bool, temperature,
                        J: float = 1.0, field: float = 0.0, periodic: bool = True,
                        key=(0, 0), row0: int = 0, col0: int = 0, left_col=None,
                        right_col=None, uniforms=None):
    """Plain PyTorch version of the half-sweep kernel; returns the new plane
    of the updated colour."""
    _check(other, up_row, down_row, left_col, right_col, uniforms, row0, col0)
    R, C2 = other.shape
    u24 = uniforms if uniforms is not None else _u24(key, R, C2, row0, col0, other.device)
    p = _probability(other, up_row, down_row, left_col, right_col, update_red, periodic,
                     J, field, temperature)
    return torch.where(u24.float() * _U24_SCALE < p, 1.0, -1.0).to(other.dtype)


def halfsweep(other, up_row, down_row, *, update_red: bool, temperature, J: float = 1.0,
              field: float = 0.0, periodic: bool = True, key=(0, 0), row0: int = 0,
              col0: int = 0, left_col=None, right_col=None, uniforms=None):
    """One half-sweep; returns the new plane of the updated colour (red if
    ``update_red``) in ``other``'s dtype.

    ``other``: (R, C2) float32 or bfloat16 plane of the other colour, R
    even. ``up_row``/``down_row``: (1, C2) halo rows above row 0 and below
    row R-1. ``left_col``/``right_col``: optional (R, 1) column halos, both
    or neither; with them the horizontal edges are theirs and ``periodic``
    no longer matters. ``key``: the Philox key (k0, k1) as ints;
    ``row0``/``col0``: the plane's global offsets (row0 even), which the
    draws are keyed by. ``uniforms``: optional (R, C2) int32 replacing the
    generator. A CUDA tensor launches the kernel, and
    ``halfsweep.launches`` grows by one; a CPU tensor runs
    :func:`halfsweep_reference`. Every operand lies on ``other``'s device,
    contiguous but for the column halos, which may be strided columns: an
    (R, 1) view of the neighbour shard's plane is read in place. The kernel
    takes ``other`` to hold +-1 and the halos +-1 or 0.
    """
    if other.device.type == "cpu":
        return halfsweep_reference(other, up_row, down_row, update_red=update_red,
                                   temperature=temperature, J=J, field=field,
                                   periodic=periodic, key=key, row0=row0, col0=col0,
                                   left_col=left_col, right_col=right_col, uniforms=uniforms)
    if other.device.type != "cuda":
        raise ValueError(f"halfsweep runs on cpu or cuda tensors, got {other.device}")
    _check(other, up_row, down_row, left_col, right_col, uniforms, row0, col0)
    left_stride, right_stride = _kernel_operands(other, up_row, down_row, left_col, right_col,
                                                 uniforms)
    R, C2 = other.shape
    out = torch.empty_like(other)
    call(library("checkerboard_halfsweep").tsu_halfsweep, other.device, other, out, up_row,
         down_row, left_col, right_col, left_stride, right_stride, uniforms, R, C2,
         int(update_red), int(periodic), float(J), float(field), float(temperature), row0, col0,
         key[0] & MASK32, key[1] & MASK32, int(other.dtype == torch.bfloat16))
    halfsweep.launches += 1
    return out


halfsweep.launches = 0


def halfsweep_band(other, up_row, down_row, *, update_red: bool, temperature,
                   J: float = 1.0, field: float = 0.0, periodic: bool = True, key=(0, 0),
                   row0: int = 0, col0: int = 0, left_col=None, right_col=None,
                   uniforms=None) -> torch.Tensor:
    """Boolean mask of the sites of a half-sweep whose uniform lies within
    CONTINUOUS_BAND of its probability, where implementations of ``exp`` may
    disagree."""
    R, C2 = other.shape
    u24 = uniforms if uniforms is not None else _u24(key, R, C2, row0, col0, other.device)
    p = _probability(other, up_row, down_row, left_col, right_col, update_red, periodic,
                     J, field, temperature)
    return (u24.double() * _U24_SCALE - p.double()).abs() <= CONTINUOUS_BAND


def checkerboard_sweeps_planes_kernel(seed: int, red, black, temperature, n_sweeps: int, *,
                                      J: float = 1.0, field: float = 0.0,
                                      periodic: bool = True, uniforms=None):
    """n_sweeps full sweeps of one lattice (red, then black), two half-sweep
    launches a sweep; returns (red, black).

    Sweep k's half-sweep of colour c draws from (fold_seed(seed, c), k).
    ``uniforms``: optional (n_sweeps, 2, R, C2) int32 in [0, 2^24), [k, 0]
    for the red update of sweep k and [k, 1] for the black one.
    """
    if uniforms is not None:
        uniforms = torch.as_tensor(uniforms, dtype=torch.int32, device=black.device)
        if uniforms.shape != (n_sweeps, 2, *black.shape):
            raise ValueError(f"uniforms must be (n_sweeps, 2, R, C2), got {tuple(uniforms.shape)}")
    kw = dict(temperature=temperature, J=J, field=field, periodic=periodic)
    for k in range(n_sweeps):
        u = (None, None) if uniforms is None else uniforms[k]
        red = halfsweep(black, *wrap_halos(black, periodic), update_red=True,
                        key=bond_key(seed, 0, k), uniforms=u[0], **kw)
        black = halfsweep(red, *wrap_halos(red, periodic), update_red=False,
                          key=bond_key(seed, 1, k), uniforms=u[1], **kw)
    return red, black
