"""Carry state from the JAX package into the port.

``tsu_tpu`` keeps a lattice as a numpy-convertible (R, C) array or as a pair
of compact (R, C/2) planes, its bond state as per-colour weight or code
planes, and its ``IsingConfig`` as a frozen dataclass. These helpers turn
each into the port's tensors and config without importing ``tsu_tpu``:
callers hand over numpy arrays and plain fields.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from tsu_tpu_torch.config import ConfigurationError, IsingConfig
from tsu_tpu_torch.ops.checkerboard import split_checkerboard


def planes_from_numpy(red, black, *, device=None, dtype=torch.float32):
    """A pair of (R, C/2) planes (numpy or array-like) as tensors."""
    red = torch.tensor(np.asarray(red), dtype=dtype, device=device)
    black = torch.tensor(np.asarray(black), dtype=dtype, device=device)
    if red.shape != black.shape or red.dim() < 2:
        raise ConfigurationError(
            f"planes must share one (..., R, C/2) shape, got "
            f"{tuple(red.shape)} and {tuple(black.shape)}")
    return red, black


def lattice_to_planes(lattice, *, device=None, dtype=torch.float32):
    """An (R, C) lattice (numpy or array-like) as the port's (red, black)."""
    return split_checkerboard(
        torch.tensor(np.asarray(lattice), dtype=dtype, device=device))


def config_from_fields(fields) -> IsingConfig:
    """An IsingConfig from the fields of the JAX package's IsingConfig: the
    object itself (any object with those attributes) or a mapping."""
    names = [f.name for f in dataclasses.fields(IsingConfig)]
    if isinstance(fields, Mapping):
        unknown = set(fields) - set(names)
        if unknown:
            raise ConfigurationError(f"unknown IsingConfig fields: {sorted(unknown)}")
        return IsingConfig(**fields)
    return IsingConfig(**{n: getattr(fields, n) for n in names})


def _tensor(a, device):
    """A numpy-convertible array as a tensor; bfloat16 arrays (which
    torch.from_numpy does not take) stay bfloat16, exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(a, device=device)


def bond_weights_from_numpy(weights, *, device=None) -> dict:
    """The JAX package's bond state as the port's: ``{"red", "black"}``
    each either the 5-tuple (w_up, w_down, w_left, w_right, f) of
    ``color_bond_weights`` (float32 or bfloat16 planes, kept in their
    dtype) or the code plane of ``pack_bond_codes`` (stored there as
    bfloat16 values 0..170, here as uint8)."""
    out = {}
    for color in ("red", "black"):
        planes = weights[color]
        if isinstance(planes, (tuple, list)):
            if len(planes) != 5:
                raise ConfigurationError(f"{color} weights need 5 planes, got {len(planes)}")
            out[color] = tuple(_tensor(w, device) for w in planes)
            continue
        code = np.asarray(planes, np.float32)
        if code.ndim != 2 or not np.all((code == np.round(code)) & (code >= 0) & (code <= 170)):
            raise ConfigurationError(f"{color} code plane must be 2-D integers 0..170")
        out[color] = torch.tensor(code.astype(np.uint8), device=device)
    return out
