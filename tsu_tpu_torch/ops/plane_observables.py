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

``plane_sums`` is K11's shard mode, for one row shard of a lattice sharded
over several cards (``parallel/lattice.py``): the shard's spin sum and bond
sum, int64, into one row of a tensor on its card, the black rows above and
below the shard given as halo rows. The caller adds the shards' sums and
forms m and E from them. On the CPU it runs ``plane_sums_reference``.
"""

from __future__ import annotations

import torch

from tsu_tpu_torch.ops._build import MAX_BATCH, call, library
from tsu_tpu_torch.ops.checkerboard import neighbor_sum_half_halo

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


def plane_sums_reference(red, black, up, down, *, periodic: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K11's shard mode: the (spin sum, bond sum) of
    a row shard's (R, C2) planes, an int64 (2,) tensor. ``up`` and ``down``
    hold the C2 black sites of the rows above and below the shard; each bond
    is counted at its red site."""
    r, b = red.to(torch.int64), black.to(torch.int64)
    nbr = neighbor_sum_half_halo(b, up.reshape(1, -1).to(torch.int64),
                                 down.reshape(1, -1).to(torch.int64), True, periodic)
    return torch.stack([r.sum() + b.sum(), (r * nbr).sum()])


def plane_sums(red, black, up, down, sums, index: int, scratch=None, *, periodic: bool = True):
    """The spin and bond sums of one row shard into ``sums[index]``.

    ``red``, ``black``: (R, C2) float32 or bfloat16 planes of the shard, R
    even. ``up``, ``down``: the black rows above and below it, C2 values of
    the planes' dtype each (zeros at an open lattice's edge). ``sums``: an
    int64 (rows, 2) tensor. ``periodic`` wraps the columns. On the card one
    launch of K11's shard mode, with ``scratch`` the
    :func:`observables_scratch` of the (R, C2) planes, every tensor
    contiguous on one CUDA device, and ``plane_sums.launches`` grows by one;
    on the CPU :func:`plane_sums_reference`."""
    _, R, C2 = _planes(red, black)
    if red.dim() != 2:
        raise ValueError(f"a shard is one (R, C2) plane pair, got {tuple(red.shape)}")
    for name, x in (("up", up), ("down", down)):
        if x.numel() != C2 or x.dtype != red.dtype:
            raise ValueError(f"{name} must be {C2} values of {red.dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if sums.dtype != torch.int64 or sums.dim() != 2 or sums.shape[1] != 2 \
            or not 0 <= index < sums.shape[0]:
        raise ValueError(f"sums must be int64 (rows, 2) with row {index}, got "
                         f"{tuple(sums.shape)} {sums.dtype}")
    dev = red.device
    if dev.type == "cpu":
        sums[index] = plane_sums_reference(red, black, up, down, periodic=periodic)
        return
    for name, x in (("red", red), ("black", black), ("up", up), ("down", down), ("sums", sums),
                    ("scratch", scratch)):
        if x is None or x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on the planes' CUDA device, got "
                             f"{None if x is None else x.device}")
    n = blocks(R, C2)
    if scratch.dtype != torch.int64 or scratch.numel() != 2 * n + 1:
        raise ValueError(f"scratch must be {2 * n + 1} int64, got {scratch.numel()} "
                         f"{scratch.dtype}")
    call(library("plane_observables").tsu_plane_sums, dev, red, black, up, down, sums, scratch,
         _DTYPES[red.dtype], R, C2, int(periodic), n, index)
    plane_sums.launches += 1


plane_sums.launches = 0
