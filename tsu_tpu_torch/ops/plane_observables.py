"""A sample's magnetization and energy from a lattice's compact planes on a
hand-written CUDA kernel.

``plane_observables`` launches K11, ``tsu_tpu_torch/csrc/plane_observables.cu``,
once a sample: it reads the red and black planes (``ops/checkerboard.py``'s
layout) once, sums the spins and the bonds in integers, and writes m = spin /
N and E = -J bond - field spin in float64 into one row of two device
tensors, with no read from the host. Its plain version is the merge and
``lattice_energy_batch`` of those planes, whose float64 sums are the same
integers, so the two agree bit for bit; ``IsingGrid.sample_observables``
runs that on the CPU and K11 on the card. This wrapper takes CUDA tensors
only and raises on any other. K11 replaces no Pallas kernel: the JAX package
takes these observables with XLA ops.
"""

from __future__ import annotations

import torch

from tsu_tpu_torch.ops._build import MAX_BATCH, call, library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # K11's codes
THREADS, STRIP = 256, 8     # a block's threads and a thread's rows, as the source has them
SITES_A_BLOCK = THREADS * STRIP * 8   # compact sites a block takes: a 16-byte bf16 load a row
MAX_BLOCKS = 1024           # blocks a lattice; more sites are walked by each thread in turn


def blocks(R: int, C2: int) -> int:
    """K11's blocks for each (R, C2) lattice of a launch."""
    return max(1, min(MAX_BLOCKS, -(-R * C2 // SITES_A_BLOCK)))


def _planes(red, black) -> tuple:
    """(B, R, C2) of the planes, or ValueError, before anything is built."""
    if red.dtype not in _DTYPES or black.dtype != red.dtype:
        raise ValueError(f"planes must be float32 or bfloat16 alike, got {red.dtype} and "
                         f"{black.dtype}")
    if red.shape != black.shape or red.dim() not in (2, 3):
        raise ValueError(f"red and black must be one (R, C2) or (B, R, C2) shape, got "
                         f"{tuple(red.shape)} and {tuple(black.shape)}")
    B, R, C2 = (1, *red.shape) if red.dim() == 2 else red.shape
    if R < 2 or R % 2 or C2 < 1:
        raise ValueError(f"plane shape must be (even R >= 2, C/2 >= 1), got {(R, C2)}")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"a launch takes 1 to {MAX_BATCH} lattices, got {B}")
    return B, R, C2


def observables_scratch(shape, device) -> torch.Tensor:
    """K11's zeroed int64 scratch on ``device`` for planes of ``shape``,
    (R, C2) or (B, R, C2): each block's two partial sums and a ticket a
    lattice. Each launch leaves the tickets at zero, so one scratch serves
    every launch on such planes in one stream."""
    *batch, R, C2 = shape
    B = batch[0] if batch else 1
    return torch.zeros(B * (2 * blocks(R, C2) + 1), dtype=torch.int64, device=device)


def plane_observables(red, black, m, e, index: int, scratch, *, J: float, field: float = 0.0,
                      periodic: bool = True):
    """One launch of K11: write lattice b's magnetization per spin and total
    energy into ``m`` and ``e`` at flat position ``index * B + b``.

    ``red``, ``black``: (R, C2) or (B, R, C2) float32 or bfloat16 planes of
    spins, R even. ``m``, ``e``: float64 rows of B values, ``index`` the
    row written. ``scratch``: :func:`observables_scratch` of these planes.
    Every tensor contiguous on one CUDA device. The energy is -J times the
    nearest-neighbour bond sum (wrapped, or open) less ``field`` times the
    spin sum. Adds one to ``plane_observables.launches``.
    """
    B, R, C2 = _planes(red, black)
    dev = red.device
    for name, x in (("red", red), ("black", black), ("m", m), ("e", e), ("scratch", scratch)):
        if x.device.type != "cuda" or x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on the planes' CUDA device, got "
                             f"{x.device}")
    if m.dtype != torch.float64 or e.dtype != torch.float64 or m.shape != e.shape \
            or m.numel() % B:
        raise ValueError(f"m and e must be float64 rows of {B}, got {m.dtype} {tuple(m.shape)} "
                         f"and {e.dtype} {tuple(e.shape)}")
    if not 0 <= index < m.numel() // B:
        raise ValueError(f"index {index} outside the {m.numel() // B} rows of m and e")
    n = blocks(R, C2)
    if scratch.dtype != torch.int64 or scratch.numel() != B * (2 * n + 1):
        raise ValueError(f"scratch must be {B * (2 * n + 1)} int64, got {scratch.numel()} "
                         f"{scratch.dtype}")
    call(library("plane_observables").tsu_plane_observables, dev, red, black, m, e, scratch,
         _DTYPES[red.dtype], B, R, C2, int(periodic), n, index, float(J), float(field))
    plane_observables.launches += 1


plane_observables.launches = 0
