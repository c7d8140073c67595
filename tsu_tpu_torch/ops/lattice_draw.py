"""A lattice's random start drawn on its device, shard by shard.

``draw_planes`` launches K12, ``tsu_tpu_torch/csrc/lattice_draw.cu``, on a
CUDA device: it writes the +-1 red and black compact planes
(``ops/checkerboard.py``'s layout) of rows [row0, row0 + R) of a lattice,
each site from the Philox word of its global coordinates under
``rng.draw_key(base)``, so a lattice sharded by rows over several cards is
drawn on them without ever existing whole. On the CPU it runs
``draw_planes_reference``, the same draw in PyTorch, which K12 equals bit for
bit. K12 replaces no Pallas kernel: the JAX package draws its lattices on
the host.
"""

from __future__ import annotations

import torch

from tsu_tpu_torch.ops._build import PLANE_DTYPES, call, library
from tsu_tpu_torch.rng import draw_key, philox_words

THREADS = 256               # a block's threads, as the source has them
BLOCKS_AN_SM = 8            # blocks a multiprocessor; a block walks rows that far apart


def _check(R: int, C2: int, row0: int, dtype):
    if dtype not in PLANE_DTYPES:
        raise ValueError(f"planes must be float32 or bfloat16, got {dtype}")
    if R < 1 or C2 < 1 or row0 < 0 or row0 + R >= 2**31:
        raise ValueError(f"need R >= 1, C/2 >= 1, 0 <= row0 and row0 + R < 2^31, got "
                         f"R={R}, C/2={C2}, row0={row0}")


def draw_planes_reference(base: int, R: int, C2: int, *, row0: int = 0, device=None,
                          dtype=torch.bfloat16):
    """Plain PyTorch version of K12: (red, black), (R, C2) planes of rows
    [row0, row0 + R). Compact site (r, c) reads the Philox word of global row
    row0 + r and compact column c under ``draw_key(base)``: red is +1 iff
    bit 15 of the word is clear, black +1 iff bit 31 is."""
    _check(R, C2, row0, dtype)
    k0, k1 = draw_key(base)
    rows = row0 + torch.arange(R, dtype=torch.int64)
    words = philox_words(k0, k1, R, C2, device=device, rows=rows)
    red = torch.where((words & 0x8000) == 0, 1.0, -1.0).to(dtype)
    black = torch.where((words & 0x80000000) == 0, 1.0, -1.0).to(dtype)
    return red, black


def draw_planes(base: int, R: int, C2: int, *, row0: int = 0, device=None,
                dtype=torch.bfloat16):
    """Rows [row0, row0 + R) of the red and black planes of the lattice that
    ``base`` draws, (R, C2) each on ``device``. A CUDA device launches K12
    once, and ``draw_planes.launches`` grows by one; the CPU runs
    :func:`draw_planes_reference`."""
    device = torch.device(device if device is not None else "cpu")
    if device.type == "cpu":
        return draw_planes_reference(base, R, C2, row0=row0, device=device, dtype=dtype)
    if device.type != "cuda":
        raise ValueError(f"draw_planes runs on cpu or cuda devices, got {device}")
    _check(R, C2, row0, dtype)
    red = torch.empty((R, C2), dtype=dtype, device=device)
    black = torch.empty_like(red)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    k0, k1 = draw_key(base)
    call(library("lattice_draw").tsu_lattice_draw, device, red, black,
         int(dtype == torch.bfloat16), R, C2, row0, k0, k1, max(1, min(R, sms * BLOCKS_AN_SM)))
    draw_planes.launches += 1
    return red, black


draw_planes.launches = 0
