"""Seeds, generators and the counter-based Philox4x32-10 of the sweep kernel.

``tsu_tpu`` splits JAX keys; the port draws host-side randomness (initial
lattices, per-call seed bases) from an explicit CPU ``torch.Generator``, so a
seed gives the same draws whatever device the lattice lives on.

Inside the fused sweep every site takes one 32-bit word from Philox4x32-10
(Salmon et al., SC'11) keyed by ``(fold_seed(base), sweep)`` with counter
``(row, col // 4, 0, 0)``; the site's word is output ``col % 4``. The word
depends only on the site's global coordinates, so any thread block that
redraws a halo site draws what the site's owner drew. ``philox_words`` is the
plain PyTorch version of the generator in
``tsu_tpu_torch/csrc/checkerboard_fused.cu`` and matches it bit for bit;
``sweep_keys`` builds the per-lattice keys of the batched kernel.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

MASK32 = 0xFFFFFFFF

_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85


def as_generator(seed: Union[int, torch.Generator, None]) -> torch.Generator:
    """A CPU generator seeded with ``seed``; fresh entropy when None. A CPU
    generator passes through as it is."""
    if isinstance(seed, torch.Generator):
        if seed.device.type != "cpu":
            raise ValueError(f"host draws need a CPU generator, got one on {seed.device}")
        return seed
    gen = torch.Generator(device="cpu")
    if seed is None:
        gen.seed()
    else:
        gen.manual_seed(int(seed))
    return gen


def to_int32(x: int) -> int:
    """Wrap a Python int to the signed 32-bit range (two's complement)."""
    return ((int(x) + 2**31) & MASK32) - 2**31


def fold_seed(*components: int) -> int:
    """Mix int32 seed components into one int32 stream id.

    Bit-exact with ``tsu_tpu.ops.checkerboard_pallas.fold_seed``: the same
    splitmix32-style avalanche chain, done on host ints masked to 32 bits.
    """
    h = 0x9E3779B9
    for v in components:
        h = (h + (int(v) & MASK32)) & MASK32
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & MASK32
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & MASK32
        h ^= h >> 16
    return to_int32(h)


def sweep_keys(seeds, sweeps) -> torch.Tensor:
    """Keys ``(fold_seed(seed), sweep)`` of the batched fused sweep for
    broadcast-compatible integer arrays ``seeds`` and ``sweeps``, as a
    (..., 2) int32 CPU tensor; the kernel reads each int32 as the uint32 of
    the same bits."""
    folded = np.vectorize(fold_seed, otypes=[np.int64])(np.asarray(seeds, np.int64))
    folded, sweeps = np.broadcast_arrays(folded, np.asarray(sweeps, np.int64))
    keys = np.stack([folded, (sweeps + 2**31) % 2**32 - 2**31], axis=-1)
    return torch.from_numpy(keys.astype(np.int32))


def _mulhilo(m: int, a: torch.Tensor):
    """(hi, lo) 32-bit halves of m * a for a uint32 held in int64.

    The full product needs 64 unsigned bits, which int64 cannot hold, so
    ``a`` is split into 16-bit halves whose partial products stay below 2^48.
    """
    x = (a & 0xFFFF) * m
    y = (a >> 16) * m
    lo = (((y & 0xFFFF) << 16) + x) & MASK32
    hi = (y + (x >> 16)) >> 16
    return hi, lo


def philox4x32(counter, key0, key1):
    """Philox4x32-10 on int64 tensors holding uint32 values.

    ``counter`` is four broadcast-compatible tensors and each key an int or
    an int64 tensor that broadcasts with them; returns the four output words
    as int64 tensors in [0, 2^32).
    """
    x0, x1, x2, x3 = counter
    k0, k1 = key0 & MASK32, key1 & MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M0, x0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, x2)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & MASK32
        k1 = (k1 + _PHILOX_W1) & MASK32
    return x0, x1, x2, x3


def philox_words(key0, key1, R: int, C2: int, device=None) -> torch.Tensor:
    """(R, C2) int64 words in [0, 2^32): site (r, c) gets output c % 4 of
    Philox4x32-10 at counter (r, c // 4, 0, 0) under key (key0, key1).

    Keys are ints, or int64 tensors of shape (B, 1, 1) holding uint32 values
    for a batch of B keys, which gives (B, R, C2) words.
    """
    Q = -(-C2 // 4)
    rows = torch.arange(R, dtype=torch.int64, device=device)[:, None]
    quads = torch.arange(Q, dtype=torch.int64, device=device)[None, :]
    zero = torch.zeros((R, Q), dtype=torch.int64, device=device)
    words = torch.broadcast_tensors(
        *philox4x32((rows + zero, quads + zero, zero, zero), key0, key1))
    return torch.stack(words, dim=-1).flatten(-2)[..., :C2]
