"""Checkpoint and resume of sampler state.

Counterpart of ``tsu_tpu/checkpoint.py``. A state is a flat dict whose
values are tensors, numpy arrays, ints, floats or generator states
(``torch.Generator.get_state()``, a uint8 tensor). There is no orbax here:
a path ending in ``.npz`` is written with ``numpy.savez``, any other with
``torch.save``. ``step`` puts the file in a subdirectory named by the step
(``<path>/<step>``, or ``<path without .npz>/<step>.npz``). A file is
written under a temporary name in its directory and renamed, so a write
that is killed never leaves a half-written checkpoint behind.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np
import torch


def checkpoint_file(path: str, step: Optional[int] = None) -> str:
    """The file that ``save_state(path, state, step)`` writes."""
    path = os.path.abspath(path)
    if step is None:
        return path
    if path.endswith(".npz"):
        return os.path.join(path[:-4], f"{step}.npz")
    return os.path.join(path, str(step))


def checkpoint_exists(path: str, step: Optional[int] = None) -> bool:
    return os.path.isfile(checkpoint_file(path, step))


def _plain(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(value))
    if isinstance(value, (bool, int, float, np.integer, np.floating)):
        return value.item() if isinstance(value, (np.integer, np.floating)) else value
    raise TypeError(f"cannot checkpoint a value of type {type(value).__name__}")


def save_state(path: str, state: dict, step: Optional[int] = None) -> str:
    """Write the flat dict ``state``; returns the file written."""
    target = checkpoint_file(path, step)
    directory = os.path.dirname(target) or "."
    os.makedirs(directory, exist_ok=True)
    plain = {k: _plain(v) for k, v in state.items()}
    fd, tmp = tempfile.mkstemp(prefix=".ckpt-", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            if target.endswith(".npz"):
                np.savez(f, **{k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                               for k, v in plain.items()})
            else:
                torch.save(plain, f)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def _like(value, example):
    """``value`` (a CPU tensor, numpy array or Python number) in the form of
    ``example``."""
    if isinstance(example, torch.Tensor):
        t = torch.as_tensor(np.asarray(value) if not isinstance(value, torch.Tensor) else value)
        return t.to(device=example.device, dtype=example.dtype)
    if isinstance(example, np.ndarray):
        arr = value.numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        return arr.astype(example.dtype, copy=False)
    if isinstance(example, bool):
        return bool(value)
    if isinstance(example, (int, np.integer)):
        return int(value)
    if isinstance(example, (float, np.floating)):
        return float(value)
    raise TypeError(f"cannot restore into a value of type {type(example).__name__}")


def restore_state(path: str, example: dict, step: Optional[int] = None) -> dict:
    """Read a state written by :func:`save_state`. ``example`` names the keys
    and gives each value's form: a tensor's device and dtype, a numpy
    array's dtype, or a Python int or float."""
    target = checkpoint_file(path, step)
    if target.endswith(".npz"):
        with np.load(target) as data:
            stored = {k: data[k] for k in data.files}
    else:
        stored = torch.load(target, map_location="cpu", weights_only=True)
    missing = set(example) - set(stored)
    if missing:
        raise KeyError(f"checkpoint {target} lacks {sorted(missing)}")
    return {k: _like(stored[k], v) for k, v in example.items()}
