"""Lattice samplers of the port: annealing and parallel tempering on the
batched fused sweep (counterparts of ``tsu_tpu/samplers/``)."""

from tsu_tpu_torch.samplers.annealing import anneal_lattice, make_schedule
from tsu_tpu_torch.samplers.tempering import parallel_tempering_lattice

__all__ = ["anneal_lattice", "make_schedule", "parallel_tempering_lattice"]
