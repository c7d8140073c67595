"""Carry state from the JAX package into the port.

``tsu_tpu`` keeps a lattice as a numpy-convertible (R, C) array or as a pair
of compact (R, C/2) planes, its bond state as per-colour weight or code
planes, a dense model as numpy (J, h), a sparse graph as ELL arrays, its
``IsingConfig`` and ``TSUConfig`` as frozen dataclasses, a continuous state
as a flat vector or a (n_chains, dim) array, a BNN posterior as its data and
fields, and a mean-field fit as (mu, rho). These helpers turn each into the
port's tensors, models and configs without importing ``tsu_tpu``: callers
hand over numpy arrays and plain fields.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from tsu_tpu_torch.config import ConfigurationError, IsingConfig
from tsu_tpu_torch.energy import BNNPosterior, DenseBoltzmann
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


def config_from_fields(fields, cls=IsingConfig):
    """A config of class ``cls`` (``IsingConfig`` or ``TSUConfig``) from the
    fields of the JAX package's config of that name: the object itself (any
    object with those attributes) or a mapping."""
    names = [f.name for f in dataclasses.fields(cls)]
    if isinstance(fields, Mapping):
        unknown = set(fields) - set(names)
        if unknown:
            raise ConfigurationError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
        return cls(**fields)
    return cls(**{n: getattr(fields, n) for n in names})


def states_from_numpy(x, *, device=None) -> torch.Tensor:
    """A continuous state, a flat (dim,) vector (a BNN's theta) or a
    (n_chains, dim) start, as a float32 tensor of the same shape."""
    return torch.tensor(np.asarray(x, np.float32), device=device)


def bnn_posterior_from_numpy(x, y, sizes, activation: str = "relu", prior_std: float = 1.0,
                             noise_std: float = 0.1, *, device=None) -> BNNPosterior:
    """The JAX package's ``BNNPosterior`` from its data (x (N, d_in), y (N,
    d_out)) and fields; the data become float32 tensors on ``device``."""
    return BNNPosterior(states_from_numpy(x, device=device), states_from_numpy(y, device=device),
                        tuple(int(s) for s in sizes), activation, float(prior_std),
                        float(noise_std))


def meanfield_from_numpy(mu, rho, *, device=None):
    """The JAX package's ``MeanFieldParams`` (mu, rho) as the port's."""
    from tsu_tpu_torch.samplers.vi import MeanFieldParams

    return MeanFieldParams(states_from_numpy(mu, device=device),
                           states_from_numpy(rho, device=device))


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


def dense_model_from_numpy(J, h, *, kind: str = "ising", config=None, seed=None, device=None):
    """A dense model from numpy (J, h): an ``IsingModel`` over spins
    (``kind="ising"``, with ``config`` and ``seed``) or a ``DenseBoltzmann``
    energy over bits (``kind="boltzmann"``) with float32 tensors on
    ``device``."""
    J = np.asarray(J, np.float32)
    h = np.asarray(h, np.float32).reshape(-1)
    if J.ndim != 2 or J.shape != (h.shape[0], h.shape[0]):
        raise ConfigurationError(f"J must be (n, n) and h (n,), got {J.shape} and {h.shape}")
    if kind == "boltzmann":
        return DenseBoltzmann(torch.tensor(J, device=device), torch.tensor(h, device=device))
    if kind != "ising":
        raise ConfigurationError(f"kind must be 'ising' or 'boltzmann', got {kind!r}")
    from tsu_tpu_torch.models.ising import IsingModel

    model = IsingModel(J.shape[0], config=config, seed=seed, device=device)
    model.J = J.copy()
    model.h = h.copy()
    return model


def ell_from_numpy(neighbor_idx, neighbor_w, *, device=None):
    """The JAX package's ELL arrays ((N, K) indices padded with N, (N, K)
    weights) as the port's int64 and float32 tensors."""
    idx = np.asarray(neighbor_idx)
    w = np.asarray(neighbor_w, np.float32)
    if idx.ndim != 2 or idx.shape != w.shape:
        raise ConfigurationError(f"ELL arrays must share one (N, K) shape, got "
                                 f"{idx.shape} and {w.shape}")
    return (torch.tensor(idx.astype(np.int64), device=device),
            torch.tensor(w, device=device))
