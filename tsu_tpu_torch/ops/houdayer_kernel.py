"""Houdayer cluster moves of a batch of replica pairs on a hand-written CUDA
kernel.

``houdayer_cluster_kernel`` launches K9, ``tsu_tpu_torch/csrc/houdayer_cluster.cu``,
one launch a move. ``houdayer_cluster`` takes it on a CUDA tensor and
``houdayer_cluster_reference``, the plain PyTorch version, on a CPU tensor;
there is no fallback from one to the other. K9 replaces
no Pallas kernel: the JAX package grows the cluster with ``lax.while_loop``
(``tsu_tpu/samplers/tempering_ladder.py``), and the plain version grows it
from the host, a few dozen tensor operations a step.

The move of pair i: take the overlap q = s1 s2 of its two replicas (q = -1
where the float32 product of the two planes' values is negative), pick the
k-th q = -1 site, red plane first and row-major, with k = min(floor(u[i] *
count), count - 1) in float64, grow the 4-connected q = -1 cluster holding
it, and negate the cluster in both replicas. A pair with no q = -1 site is
left as it is. Both versions grow the cluster step by step, a step being a
red then a black half-step, to the first step that changes nothing, so they
give the same planes bit for bit and the same count of steps.

K9 writes each pair's step count to an output of its launch. While tracing,
``houdayer_cluster`` adds the batch's largest into a counter on the card
(``growth_steps``), which the callers read: a read waits for the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tsu_tpu_torch import profiling
from tsu_tpu_torch.ops._build import call, cuda_index, library
from tsu_tpu_torch.ops.checkerboard import wrap_halos

GROWTH_CHECK = 16   # the plain version's growth steps between fixed-point tests
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.float64: 3}   # K9's codes
_U_DTYPES = (torch.float32, torch.float64)
_STEPS = {}         # the step counter of each CUDA device, by index


def _neighbor_or(mask, update_red: bool, periodic: bool):
    """4-neighbour OR across the checkerboard bipartition: the neighbours of
    one colour's sites are on the other colour's plane. A boolean mask has
    no weights to zero, so an open lattice masks the horizontal wraps."""
    R, C2 = mask.shape[-2:]
    row_is_even = (torch.arange(R, device=mask.device) % 2 == 0)[:, None]
    pick = row_is_even if update_red else ~row_is_even
    up_row, down_row = wrap_halos(mask, periodic)
    up = torch.cat([up_row, mask[..., :-1, :]], dim=-2)
    down = torch.cat([mask[..., 1:, :], down_row], dim=-2)
    left_shift = torch.roll(mask, 1, dims=-1)
    right_shift = torch.roll(mask, -1, dims=-1)
    if not periodic:
        j = torch.arange(C2, device=mask.device)
        # left_shift feeds only picked rows, whose left neighbour wraps at
        # j == 0; right_shift only the others, wrapping at j == C2 - 1.
        left_shift = left_shift & (j != 0)
        right_shift = right_shift & (j != C2 - 1)
    left = torch.where(pick, left_shift, mask)
    right = torch.where(pick, mask, right_shift)
    return up | down | left | right


def houdayer_cluster_reference(u, r1, b1, r2, b2, periodic: bool, *,
                               check_every: int = GROWTH_CHECK):
    """Plain PyTorch version of K9: returns ((r1, b1, r2, b2) moved, the
    growth steps run). The cluster grows until a step changes nothing,
    tested every ``check_every`` steps (each test waits for the card), so
    the steps run are the kernel's count rounded up to a multiple of
    ``check_every``; ``check_every=1`` gives the kernel's count."""
    qr = (r1.float() * r2.float()) < 0
    qb = (b1.float() * b2.float()) < 0
    B = qr.shape[0]
    flat = torch.cat([qr.reshape(B, -1), qb.reshape(B, -1)], dim=1)
    count = flat.sum(dim=1)
    k = torch.minimum((u.to(torch.float64) * count).long(), (count - 1).clamp(min=0))
    seed = flat & (torch.cumsum(flat, dim=1) == (k + 1)[:, None])
    nred = qr[0].numel()
    m_red, m_black = seed[:, :nred].view_as(qr), seed[:, nred:].view_as(qb)
    steps = 0
    while True:
        with profiling.annotate("houdayer.grow_block"):
            profiling.count("houdayer.growth_steps", check_every)
            steps += check_every
            for _ in range(check_every):
                prev_red, prev_black = m_red, m_black
                m_red = m_red | (qr & _neighbor_or(m_black, True, periodic))
                m_black = m_black | (qb & _neighbor_or(m_red, False, periodic))
            # Each torch.equal reads its answer back from the device.
            red_still = torch.equal(m_red, prev_red)
            profiling.count("host_syncs", 1 + red_still)
            if red_still and torch.equal(m_black, prev_black):
                break
    return (torch.where(m_red, -r1, r1), torch.where(m_black, -b1, b1),
            torch.where(m_red, -r2, r2), torch.where(m_black, -b2, b2)), steps


def growth_steps(device) -> torch.Tensor:
    """The 0-d int64 counter on CUDA ``device`` to which, while tracing,
    every move of :func:`houdayer_cluster` there adds the growth steps of its
    slowest pair. Zero it with ``zero_()``; reading it waits for the card."""
    index = cuda_index(device)
    if index not in _STEPS:
        _STEPS[index] = torch.zeros((), dtype=torch.int64, device=torch.device("cuda", index))
    return _STEPS[index]


@functools.cache
def _smem_limit(index: int) -> int:
    """Bytes of dynamic shared memory a K9 block may take on card ``index``."""
    got = ctypes.c_int()
    call(library("houdayer_cluster").tsu_houdayer_smem_limit, index, ctypes.byref(got))
    return got.value


def _check(u, planes):
    r1 = planes[0]
    if r1.device.type != "cuda" or r1.dim() != 3 or r1.dtype not in _DTYPES:
        raise ValueError(f"planes must be (B, R, C2) float32, bfloat16, float16 or float64 "
                         f"on a CUDA device, got {tuple(r1.shape)} {r1.dtype} on {r1.device}")
    B, R, C2 = r1.shape
    if min(B, R, C2) < 1 or 2 * R * C2 >= 2**31:
        raise ValueError(f"planes must be (B >= 1, R >= 1, C2 >= 1) with 2 R C2 < 2^31, got "
                         f"{tuple(r1.shape)}")
    for name, x in zip(("r1", "b1", "r2", "b2"), planes):
        if x.shape != r1.shape or x.dtype != r1.dtype:
            raise ValueError(f"{name} must be {tuple(r1.shape)} {r1.dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != r1.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {r1.device}")
    if u.shape != (B,) or u.dtype not in _U_DTYPES or u.device != r1.device \
            or not u.is_contiguous():
        raise ValueError(f"u must be ({B},) float32 or float64 on {r1.device}, got "
                         f"{tuple(u.shape)} {u.dtype} on {u.device}")


def houdayer_cluster_kernel(u, r1, b1, r2, b2, periodic: bool):
    """One launch of K9: a Houdayer move of B replica pairs on the card.

    ``r1, b1, r2, b2``: the (B, R, C2) red and black planes of each pair's
    two replicas, contiguous CUDA tensors of one floating dtype (float32,
    bfloat16, float16 or float64). ``u``: (B,) uniforms in [0, 1), float32
    or float64, on their device, u[i] picking pair i's seed. Returns ((r1,
    b1, r2, b2) moved, steps), steps the (B,) int32 growth steps of each
    pair, and adds one to ``houdayer_cluster_kernel.launches``. A pair's bit
    planes live in shared memory where they fit, else in a global scratch.
    """
    planes = (r1, b1, r2, b2)
    _check(u, planes)
    B, R, C2 = r1.shape
    W = -(-C2 // 32)
    scratch = None
    if 16 * R * W > _smem_limit(cuda_index(r1.device)):
        scratch = torch.empty((B, 4, R, W), dtype=torch.int32, device=r1.device)
    outs = [torch.empty_like(x) for x in planes]
    steps = torch.empty(B, dtype=torch.int32, device=r1.device)
    call(library("houdayer_cluster").tsu_houdayer_cluster, r1.device, *planes, *outs, u,
         int(u.dtype == torch.float64), _DTYPES[r1.dtype], B, R, C2, int(periodic), scratch,
         steps)
    houdayer_cluster_kernel.launches += 1
    return tuple(outs), steps


houdayer_cluster_kernel.launches = 0


def houdayer_cluster(u, r1, b1, r2, b2, periodic: bool):
    """One Houdayer move of B replica pairs; returns the four moved planes.

    A CUDA tensor launches K9 (:func:`houdayer_cluster_kernel`) and, while
    tracing, adds its slowest pair's growth steps into :func:`growth_steps`.
    A CPU tensor runs :func:`houdayer_cluster_reference`, which counts its
    steps itself.
    """
    if r1.device.type == "cpu":
        return houdayer_cluster_reference(u, r1, b1, r2, b2, periodic)[0]
    planes, steps = houdayer_cluster_kernel(u, r1, b1, r2, b2, periodic)
    if profiling.tracing():
        growth_steps(r1.device).add_(steps.max())
    return planes
