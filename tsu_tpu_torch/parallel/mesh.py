"""Device meshes of the sharded paths, in one process or across processes.

Counterpart of ``tsu_tpu/parallel/mesh.py``. A :class:`Mesh` is an array of
``torch.device``s shaped (replica, chains, row, col), with the reference's
axis names, and beside it the rank of the process that holds each entry.

One process (no :func:`multihost_initialize`): every entry's rank is 0 and
that process drives every shard; a shard's tensors live on its mesh device
for the whole run and the halo rows between shards are copies from one
device to another. A device may appear more than once, so several shards
share one card (``make_mesh(rows=4, devices=["cuda:0"] * 4)``) or the CPU
(``devices=["cpu"] * 4``, as the tests run); the same code places the
shards on four cards when four are given.

Several processes (after :func:`multihost_initialize`, one process per rank
under ``torchrun``): ``make_mesh``'s default is the global mesh, one entry
per rank on that rank's device, and ``ranks=`` places several entries on
one rank. Each rank builds and sweeps only the shards it holds and trades
halos with the others through ``parallel.distributed``.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from tsu_tpu_torch.parallel import distributed

AXES = ("replica", "chains", "row", "col")


class Mesh:
    """``devices``: an object array of ``torch.device``s of shape
    (replica, chains, row, col); ``ranks``: an int array of that shape, the
    process that holds each entry (default all 0, one process); ``shape``
    maps each axis name to its size."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray, ranks: Optional[np.ndarray] = None):
        if devices.ndim != len(AXES):
            raise ValueError(f"a mesh is {len(AXES)}-D {AXES}, got shape {devices.shape}")
        self.devices = devices
        self.ranks = np.zeros(devices.shape, dtype=np.int64) if ranks is None else ranks
        if self.ranks.shape != devices.shape:
            raise ValueError(f"ranks {self.ranks.shape} must match devices {devices.shape}")

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        where = sorted({str(d) for d in self.devices.flat})
        if self.ranks.any():
            return f"Mesh({self.shape}, {where}, ranks {self.ranks.reshape(-1).tolist()})"
        return f"Mesh({self.shape}, {where})"


def make_mesh(replica: int = 1, chains: int = 1, rows: int = 1, cols: int = 1,
              devices: Optional[Sequence] = None, ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A Mesh with axes ("replica", "chains", "row", "col") over the first
    replica * chains * rows * cols of ``devices``, held by ``ranks`` (one
    rank per device, default all 0).

    Default ``devices``: in one process every visible CUDA device; after
    :func:`multihost_initialize`, each rank's device (gathered when the
    runtime formed), held by that rank, or with ``ranks`` given the device
    of each of those ranks. A device may repeat in ``devices``. Raises
    ValueError when the mesh needs more devices than it is given, or names
    a rank outside the process group."""
    rt = distributed.runtime()
    if devices is None and rt is not None:
        ranks = list(range(rt.world_size)) if ranks is None else list(ranks)
        devices = [rt.devices[r] for r in ranks]
    elif devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    ranks = [0] * len(devices) if ranks is None else [int(r) for r in ranks]
    if len(ranks) != len(devices):
        raise ValueError(f"{len(ranks)} ranks for {len(devices)} devices")
    if any(r < 0 or r >= distributed.world_size() for r in ranks):
        raise ValueError(f"ranks {ranks} outside the process group of "
                         f"{distributed.world_size()} (multihost_initialize forms it)")
    n = replica * chains * rows * cols
    if n > len(devices):
        raise ValueError(f"mesh {replica}x{chains}x{rows}x{cols} needs {n} devices, "
                         f"have {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    shape = (replica, chains, rows, cols)
    return Mesh(grid.reshape(shape), np.asarray(ranks[:n], dtype=np.int64).reshape(shape))


def plan_lattice_mesh(n_devices: int, shape, *, replica: int = 1, chains: int = 1,
                      devices: Optional[Sequence] = None) -> Mesh:
    """Spatial mesh for one (R, C) lattice, preferring row-only sharding.

    Row-only sharding runs the fused sweep in shard mode, one launch per
    sweep and shard; column sharding runs the two-launch streaming
    half-sweep with column halos. Picks the largest row count that divides
    the spatial device budget and R with an even shard height, and puts the
    rest on the column axis with a RuntimeWarning. After
    :func:`multihost_initialize` the default ``devices`` are the ranks', so
    ``n_devices`` is the world size.
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
    """Topology summary for logs and measurement records: the axes, the
    devices' count and platform, and the runtime's processes, hosts and
    backend (1, 1 and None in one process)."""
    return {
        "axes": mesh.shape,
        "n_devices": mesh.size,
        "platform": mesh.devices.flat[0].type,
        "n_processes": distributed.world_size(),
        "n_hosts": distributed.n_hosts(),
        "backend": distributed.backend(),
    }


def multihost_initialize(**kwargs) -> distributed.Runtime:
    """Start the multi-process runtime (``torch.distributed``), once per
    process, before building meshes that span processes. The counterpart of
    the reference's ``jax.distributed.initialize`` wrapper; the keyword
    arguments are :func:`tsu_tpu_torch.parallel.distributed.initialize`'s
    (``init_method``, ``rank``, ``world_size``, ``backend``, ``device``),
    by default ``torchrun``'s environment. Raises when called twice or when
    the process group cannot form; nothing runs on in one process."""
    return distributed.initialize(**kwargs)
