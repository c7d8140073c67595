"""Philox4x32-10 (Salmon et al., SC'11) and the seed folding, in plain
PyTorch on int64 tensors that hold uint32 values.

These are the published generator and a splitmix32-style fold, written out
again for the benchmark's reference: site (r, q) of a word grid takes output
q % 4 of Philox at counter (r, q // 4, 0, 0). Products of two uint32 values
are taken in int64, which wraps modulo 2**64, so their high and low 32 bits
come out right after a mask.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
M0, M1 = 0xD2511F53, 0xCD9E8D57      # Philox4x32 multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85      # Weyl key increments


def to_int32(x: int) -> int:
    """A Python int wrapped to the signed 32-bit range."""
    return ((int(x) + 2**31) & MASK32) - 2**31


def fold(*components):
    """Mix seed components (ints or int64 tensors that broadcast) into one
    stream id, a signed 32-bit value: per component h += c, then the
    avalanche h ^= h >> 16, h *= 0x85EBCA6B, h ^= h >> 13, h *= 0xC2B2AE35,
    h ^= h >> 16, from h = 0x9E3779B9. Returns an int for int components,
    else an int64 tensor."""
    tensors = [c for c in components if isinstance(c, torch.Tensor)]
    h = torch.tensor(0x9E3779B9, dtype=torch.int64,
                     device=tensors[0].device if tensors else None)
    for c in components:
        h = (h + (torch.as_tensor(c, dtype=torch.int64, device=h.device) & MASK32)) & MASK32
        h = h ^ (h >> 16)
        h = (h * 0x85EBCA6B) & MASK32
        h = h ^ (h >> 13)
        h = (h * 0xC2B2AE35) & MASK32
        h = h ^ (h >> 16)
    h = ((h + 2**31) & MASK32) - 2**31
    return h if tensors else int(h)


def philox(c0, c1, c2, c3, k0, k1):
    """Ten Philox4x32 rounds on counters (c0, c1, c2, c3) under key (k0, k1),
    each an int or an int64 tensor of uint32 values; returns the four words."""
    k0, k1 = k0 & MASK32, k1 & MASK32
    for _ in range(10):
        p0, p1 = c0 * M0, c2 * M1
        c0, c1, c2, c3 = ((p1 >> 32) & MASK32) ^ c1 ^ k0, p1 & MASK32, \
            ((p0 >> 32) & MASK32) ^ c3 ^ k1, p0 & MASK32
        k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
    return c0, c1, c2, c3


def words(k0, k1, rows: int, cols: int, device=None) -> torch.Tensor:
    """(..., rows, cols) int64 words: entry (r, q) is output q % 4 of Philox
    at counter (r, q // 4, 0, 0). ``k0`` and ``k1`` are ints or int64
    tensors whose shapes broadcast against (rows, 1), giving the leading
    axes."""
    quads = -(-cols // 4)
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    q = torch.arange(quads, dtype=torch.int64, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    out = philox(r + 0 * q, q + 0 * r, zero, zero, k0, k1)
    shape = torch.broadcast_shapes(*(o.shape for o in out))
    return torch.stack([o.expand(shape) for o in out], dim=-1).flatten(-2)[..., :cols]
