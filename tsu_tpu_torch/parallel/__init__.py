"""Device-mesh parallelism: replicas and spatial lattice sharding, driven by
one controller (counterpart of ``tsu_tpu/parallel/``).

* ``replica`` axis: parallel tempering with the rungs' replicas spread over
  the devices (:func:`parallel_tempering_replica_sharded`).
* ``row`` and ``col`` axes: one large lattice cut into shards that exchange
  halo rows and columns before each kernel launch.
* ``chains`` axis: annealed SMC with the particles sharded
  (:func:`annealed_smc_sharded`), equal to the one-shard run bit for bit.

A mesh may hold one device several times, so one card (or the CPU) carries
a sharded run; on several cards the halos are device-to-device copies. The
reference's multi-host runtime waits for slice 8 (ROADMAP.md).
"""

from tsu_tpu_torch.parallel.lattice import sharded_checkerboard_sweeps, sharded_lattice_sample
from tsu_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    mesh_info,
    multihost_initialize,
    plan_lattice_mesh,
)
from tsu_tpu_torch.parallel.smc_sharded import annealed_smc_sharded
from tsu_tpu_torch.parallel.tempering_sharded import parallel_tempering_replica_sharded

__all__ = [
    "Mesh",
    "annealed_smc_sharded",
    "make_mesh",
    "mesh_info",
    "multihost_initialize",
    "parallel_tempering_replica_sharded",
    "plan_lattice_mesh",
    "sharded_checkerboard_sweeps",
    "sharded_lattice_sample",
]
