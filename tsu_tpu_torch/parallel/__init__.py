"""Device-mesh parallelism: replicas and spatial lattice sharding, in one
process or across processes (counterpart of ``tsu_tpu/parallel/``).

* ``replica`` axis: parallel tempering with the rungs' replicas spread over
  the devices (:func:`parallel_tempering_replica_sharded`).
* ``row`` and ``col`` axes: one large lattice cut into shards that exchange
  halo rows and columns before each kernel launch.
* ``chains`` axis: annealed SMC with the particles sharded
  (:func:`annealed_smc_sharded`), equal to the one-shard run bit for bit.

In one process a mesh may hold one device several times, so one card (or
the CPU) carries a sharded run; on several cards the halos are
device-to-device copies. After :func:`multihost_initialize` (one process
per rank under ``torchrun``, :mod:`~tsu_tpu_torch.parallel.distributed`)
the same entry points run over a mesh that spans processes and hosts: each
rank holds and sweeps its own shards, halos between ranks go through
``torch.distributed`` (NCCL across cards, gloo where ranks share one), and
every rank returns the one-process result at the same seed.
"""

from tsu_tpu_torch.parallel import distributed
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
    "distributed",
    "make_mesh",
    "mesh_info",
    "multihost_initialize",
    "parallel_tempering_replica_sharded",
    "plan_lattice_mesh",
    "sharded_checkerboard_sweeps",
    "sharded_lattice_sample",
]
