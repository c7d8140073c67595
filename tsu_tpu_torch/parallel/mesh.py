"""Device meshes of the single-controller sharded paths.

Counterpart of ``tsu_tpu/parallel/mesh.py``. A :class:`Mesh` is an array of
``torch.device``s shaped (replica, chains, row, col), with the reference's
axis names. One process drives every shard: a shard's tensors live on its
mesh device for the whole run and the halo rows between shards are copies
from one device to another. A device may appear more than once, so several
shards share one card (``make_mesh(rows=4, devices=["cuda:0"] * 4)``) or the
CPU (``devices=["cpu"] * 4``, as the tests run); the same code places the
shards on four cards when four are given.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np
import torch

AXES = ("replica", "chains", "row", "col")


class Mesh:
    """``devices``: an object array of ``torch.device``s of shape
    (replica, chains, row, col); ``shape`` maps each axis name to its
    size."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray):
        if devices.ndim != len(AXES):
            raise ValueError(f"a mesh is {len(AXES)}-D {AXES}, got shape {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {sorted({str(d) for d in self.devices.flat})})"


def make_mesh(replica: int = 1, chains: int = 1, rows: int = 1, cols: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A Mesh with axes ("replica", "chains", "row", "col") over the first
    replica * chains * rows * cols of ``devices`` (default every visible
    CUDA device). A device may repeat in ``devices``. Raises ValueError when
    the mesh needs more devices than it is given."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = replica * chains * rows * cols
    if n > len(devices):
        raise ValueError(f"mesh {replica}x{chains}x{rows}x{cols} needs {n} devices, "
                         f"have {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(replica, chains, rows, cols))


def plan_lattice_mesh(n_devices: int, shape, *, replica: int = 1, chains: int = 1,
                      devices: Optional[Sequence] = None) -> Mesh:
    """Spatial mesh for one (R, C) lattice, preferring row-only sharding.

    Row-only sharding runs the fused sweep in shard mode, one launch per
    sweep and shard; column sharding runs the two-launch streaming
    half-sweep with column halos. Picks the largest row count that divides
    the spatial device budget and R with an even shard height, and puts the
    rest on the column axis with a RuntimeWarning.
    """
    spatial = n_devices // (replica * chains)
    if spatial * replica * chains != n_devices:
        raise ValueError(f"replica*chains={replica * chains} must divide {n_devices}")
    R, C = shape
    rows = max((r for r in range(1, spatial + 1)
                if spatial % r == 0 and R % r == 0 and (R // r) % 2 == 0), default=1)
    cols = spatial // rows
    if cols > 1:
        warnings.warn(
            f"lattice {R}x{C} over {spatial} spatial devices needs column sharding "
            f"({rows}x{cols}): sweeps run the two-launch streaming half-sweep, not the "
            "fused sweep", RuntimeWarning, stacklevel=2)
        if (C // 2) % cols != 0:
            raise ValueError(f"compact columns C/2={C // 2} not divisible by {cols}")
    return make_mesh(replica, chains, rows, cols, devices)


def mesh_info(mesh: Mesh) -> dict:
    """Topology summary for logs and measurement records."""
    return {
        "axes": mesh.shape,
        "n_devices": mesh.size,
        "platform": mesh.devices.flat[0].type,
    }


def multihost_initialize(**kwargs):
    """The multi-host runtime is not ported: one process drives every shard
    of a mesh on one host."""
    raise NotImplementedError(
        "multihost_initialize is not ported to tsu_tpu_torch yet (slice 8, the "
        "multi-host runtime, of ROADMAP.md)")
