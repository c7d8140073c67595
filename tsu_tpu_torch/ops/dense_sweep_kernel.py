"""The dense colour sweep of a batch of chains on a hand-written CUDA kernel.

``dense_colour_sweep`` launches K10, ``tsu_tpu_torch/csrc/dense_colour_sweep.cu``,
once a sweep: every colour of a :class:`~tsu_tpu_torch.samplers.gibbs.ColourPlan`
in plan order, for every chain, in place. Its plain version is
``samplers/gibbs.py:colour_sweep`` (the eager loop of ``colour_step``), which
the CPU runs; this wrapper takes CUDA tensors only and raises on any other.
K10 replaces no Pallas kernel: the JAX package's dense engine runs XLA
matrix products on one-hot tables.

A chain is one block that walks the plan's rows in order with a ring of
four rows in flight in shared memory, its bits in registers, and one
barrier a colour (the source's note says why). :func:`geometry` fixes the
block from the plan's size and widest colour, or says that K10 cannot take
the plan, and :func:`blocks_at_once` how many such blocks the card runs at
once, which the route rule (``samplers/gibbs.py:dense_route``) reads.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from tsu_tpu_torch.ops._build import call, cuda_index, library

SMEM_OPTIN = 232_448        # dynamic shared memory a block may opt in to on an H100
CHUNKS = (1, 2)             # 16-byte column pieces a thread that the kernel is built for
BLOCKS = (128, 256, 512)    # threads a block that the kernel is built for


class Geometry(NamedTuple):
    """A K10 launch: ``threads`` a block, ``chunks`` 16-byte column pieces
    a thread and ``smem`` bytes of dynamic shared memory a block."""

    threads: int
    chunks: int
    smem: int


def smem_bytes(threads: int, chunks: int, widest: int, n: int) -> int:
    """A block's dynamic shared memory for a plan of ``n`` sites: a ring of
    4 rows' pieces, the owned columns' bits, uniforms, h and diag, two
    buffers of the warps' partial sums of a colour's sites, and the colours'
    ends (at most n)."""
    return 4 * (8 * 4 * threads * chunks + 2 * widest * (threads // 32) + n)


def geometry(n: int, widest: int) -> Optional[Geometry]:
    """The launch of K10 for a plan of ``n`` sites whose widest colour has
    ``widest`` sites: the fewest pieces a thread, in the smallest block that
    holds the plan's columns. None when no launch fits (more than 4,096
    sites, or a colour's partial sums too wide for shared memory). At 4,096
    sites x 64 chains on an H100 a sweep took 2.92 ms with 512 threads of 2
    pieces, 2.92 with 1,024 of 1, 3.85 with 256 of 4 and 6.85 with 128 of 8
    (chip_smoke.py phase 44's shape)."""
    if n < 1 or widest < 1:
        return None
    ldj = -(-n // 4) * 4
    for chunks in CHUNKS:
        fits = [nt for nt in BLOCKS if 4 * nt * chunks >= ldj]
        if fits:
            smem = smem_bytes(fits[0], chunks, widest, n)
            if smem > SMEM_OPTIN:
                return None
            return Geometry(fits[0], chunks, smem)
    return None


@functools.cache
def _blocks_per_sm(index: int, geom: Geometry) -> int:
    per_sm = ctypes.c_int(0)
    call(library("dense_colour_sweep").tsu_dense_colour_sweep_blocks_per_sm, index,
         geom.threads, geom.chunks, geom.smem, ctypes.byref(per_sm))
    return per_sm.value


def blocks_at_once(n: int, widest: int, device) -> int:
    """The K10 blocks (a block a chain) that CUDA ``device`` runs at once
    for a plan of ``n`` sites whose widest colour has ``widest``: its SMs
    times the blocks an SM holds by the card's occupancy calculator, which
    counts registers as well as threads and shared memory. 0 where no K10
    launch fits the plan (:func:`geometry`), without asking the card."""
    geom = geometry(n, widest)
    if geom is None:
        return 0
    index = cuda_index(device)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * _blocks_per_sm(index, geom)


def _check(states, u, T, J, h, diag, ends):
    chains, n = states.shape if states.dim() == 2 else (0, 0)
    want = {"states": (states, (chains, n), torch.float32),
            "u": (u, (chains, n), torch.float32),
            "T": (T, None, torch.float32), "J": (J, None, torch.float32),
            "h": (h, (n,), torch.float32), "diag": (diag, (n,), torch.float32),
            "ends": (ends, None, torch.int32)}
    for name, (x, shape, dtype) in want.items():
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, (x, _, _) in want.items():
        if x.device.type != "cuda" or x.device != states.device:
            raise ValueError(f"{name} must be on one CUDA device with states, got {x.device}")
    if chains < 1 or n < 1:
        raise ValueError(f"states must be (chains >= 1, n >= 1), got {tuple(states.shape)}")
    if T.numel() != chains:
        raise ValueError(f"T must hold {chains} temperatures, got {T.numel()}")
    if J.dim() != 2 or J.shape[0] != n or J.shape[1] < n or J.shape[1] % 4 \
            or J.data_ptr() % 16:
        raise ValueError(f"J must be (n, ldj) with ldj >= n a multiple of 4, 16-byte aligned, "
                         f"got {tuple(J.shape)}")
    if ends.dim() != 1 or not 1 <= ends.numel() <= n:
        raise ValueError(f"ends must be (n_colors,) with 1 <= n_colors <= {n}, got "
                         f"{tuple(ends.shape)}")


def dense_colour_sweep(plan, states, u, T):
    """One launch of K10: one colour sweep of every chain of ``plan``, in place.

    ``plan``: a :class:`~tsu_tpu_torch.samplers.gibbs.ColourPlan`, whose
    ``fused_operands()`` give the couplings, fields, diagonal, colours' ends
    and widest colour, so that the ends and the widest colour the kernel's
    shared memory is sized for come from one plan. ``states``, ``u``:
    (chains, n) float32 bits and uniforms in plan order; ``T``: (chains, 1)
    or (chains,) float32 temperatures. Every tensor contiguous on one CUDA
    device. Returns ``states`` and adds one to ``dense_colour_sweep.launches``.
    """
    J, h, diag, ends, widest = plan.fused_operands()
    _check(states, u, T, J, h, diag, ends)
    chains, n = states.shape
    geom = geometry(n, widest)
    if geom is None:
        raise ValueError(f"no K10 launch fits {n} sites with a colour of {widest}")
    call(library("dense_colour_sweep").tsu_dense_colour_sweep, states.device, states, u, T, J, h,
         diag, ends, chains, n, J.shape[1], ends.numel(), widest, geom.threads, geom.chunks,
         geom.smem)
    dense_colour_sweep.launches += 1
    return states


dense_colour_sweep.launches = 0
