"""The fused sweep with parts taken out, to attribute its time to them.

Counterpart of ``make_kernel(mode)`` in ``scripts/kernel_decomposition.py``,
which times the TPU's fused kernel against variants of it with progressively
less work. Here the variants are K1's strip body under a mode template
parameter in ``tsu_tpu_torch/csrc/checkerboard_fused.cu``, on K1's grid and
Philox keys (one word per site, lo16 for red, hi16 for black):

- ``prng_only``: red = +1 where lo16 < 32768, black where hi16 < 32768; the
  words of the sites a strip owns only, nothing read;
- ``prng_grouped``: the same planes from the strips' draw pattern, including
  the words K1 redraws for their halo rows (the reference's 8-row-group
  seeding has no GPU counterpart; its port isolates the halo redraws);
- ``nomath``: red = +1 where lo16 < (up + centre + down) * 1000 + 32768, the
  black plane's vertical neighbours and centre at the red site (wrapped, or 0
  outside an open lattice), and black = red; no horizontal partner, table or
  second colour. The reference's neighbour rows sit two apart, an artefact
  of its 2-row halo tiles; these are the rows K1 reads.

``decomposition_sweep`` launches a variant on a CUDA tensor (the count
``decomposition_sweep.launches`` grows by one) and runs
``decomposition_sweep_reference``, the plain PyTorch version that the kernel
matches bit for bit, on a CPU tensor. The full sweep itself is
:func:`~tsu_tpu_torch.ops.checkerboard_fused.fused_sweep`.
"""

from __future__ import annotations

import torch

from tsu_tpu_torch.ops._build import PLANE_DTYPES, call, check_on, library
from tsu_tpu_torch.ops.checkerboard import wrap_halos
from tsu_tpu_torch.rng import MASK32, fold_seed, philox_words

MODES = {"prng_only": 1, "prng_grouped": 2, "nomath": 3}


def _check(mode, black, uniforms):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if black.dim() != 2 or black.dtype not in PLANE_DTYPES:
        raise ValueError(f"black must be an (R, C2) float32 or bfloat16 plane, got "
                         f"{tuple(black.shape)} {black.dtype}")
    R, C2 = black.shape
    if R < 2 or R % 2 or C2 < 1:
        raise ValueError(f"plane shape must be (even R >= 2, C/2 >= 1), got {(R, C2)}")
    if uniforms is not None and (uniforms.shape != (2, R, C2) or uniforms.dtype != torch.int32):
        raise ValueError(f"uniforms must be {(2, R, C2)} int32, got "
                         f"{tuple(uniforms.shape)} {uniforms.dtype}")


def decomposition_sweep_reference(mode: str, black: torch.Tensor, *, seed: int = 0,
                                  sweep: int = 0, periodic: bool = True,
                                  uniforms: torch.Tensor | None = None):
    """Plain PyTorch version of a decomposition variant; returns (red, black).
    ``uniforms``: optional (2, R, C2) int32 in [0, 2^16) standing for the
    words' lo16 ([0]) and hi16 ([1]) halves."""
    _check(mode, black, uniforms)
    R, C2 = black.shape
    if uniforms is None:
        words = philox_words(fold_seed(seed), sweep, R, C2, device=black.device)
        lo, hi = words & 0xFFFF, words >> 16
    else:
        lo, hi = uniforms[0], uniforms[1]
    if mode == "nomath":
        b = black.float()
        up, down = wrap_halos(b, periodic)
        nbr = torch.cat([up, b[:-1]]) + b + torch.cat([b[1:], down])
        red = torch.where(lo < nbr.long() * 1000 + 32768, 1.0, -1.0)
        return red.to(black.dtype), red.to(black.dtype)
    red = torch.where(lo < 32768, 1.0, -1.0).to(black.dtype)
    return red, torch.where(hi < 32768, 1.0, -1.0).to(black.dtype)


def decomposition_sweep(mode: str, black: torch.Tensor, *, seed: int = 0, sweep: int = 0,
                        periodic: bool = True, uniforms: torch.Tensor | None = None):
    """One launch of the decomposition variant ``mode`` on K1's grid and
    keys (fold_seed(seed), sweep); returns new (red, black) planes. ``black``:
    (R, C2) float32 or bfloat16, R even. A CUDA tensor launches the kernel,
    and ``decomposition_sweep.launches`` grows by one; a CPU tensor runs
    :func:`decomposition_sweep_reference`."""
    if black.device.type == "cpu":
        return decomposition_sweep_reference(mode, black, seed=seed, sweep=sweep,
                                             periodic=periodic, uniforms=uniforms)
    if black.device.type != "cuda":
        raise ValueError(f"decomposition_sweep runs on cpu or cuda tensors, got {black.device}")
    _check(mode, black, uniforms)
    check_on(black.device, black=black, uniforms=uniforms)
    red_out, black_out = torch.empty_like(black), torch.empty_like(black)
    call(library("checkerboard_fused").tsu_decomposition_sweep, black.device, MODES[mode], black,
         red_out, black_out, uniforms, *black.shape, int(periodic), fold_seed(seed) & MASK32,
         sweep & MASK32, int(black.dtype == torch.bfloat16))
    decomposition_sweep.launches += 1
    return red_out, black_out


decomposition_sweep.launches = 0
