"""Lattice samplers of the port: annealing, parallel tempering and the
spin-glass ladder tools on the batched sweep kernels (counterparts of
``tsu_tpu/samplers/``)."""

from tsu_tpu_torch.samplers.annealing import (
    anneal_lattice,
    anneal_spin_glass,
    discrete_table_applicable,
    make_schedule,
    pure_pm1_applicable,
)
from tsu_tpu_torch.samplers.tempering import parallel_tempering_bonds, parallel_tempering_lattice
from tsu_tpu_torch.samplers.tempering_ladder import (
    build_tempering_ladder,
    houdayer_move,
    predict_swap_acceptance,
    pt_ground_state_search,
)

__all__ = [
    "anneal_lattice",
    "anneal_spin_glass",
    "build_tempering_ladder",
    "discrete_table_applicable",
    "houdayer_move",
    "make_schedule",
    "parallel_tempering_bonds",
    "parallel_tempering_lattice",
    "predict_swap_acceptance",
    "pt_ground_state_search",
    "pure_pm1_applicable",
]
