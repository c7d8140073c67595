"""Samplers of the port (counterparts of ``tsu_tpu/samplers/``): dense Gibbs
sampling on colour sweeps, and annealing, parallel tempering and the
spin-glass ladder tools, dense and on the batched sweep kernels."""

from tsu_tpu_torch.samplers.annealing import (
    anneal_lattice,
    anneal_spin_glass,
    discrete_table_applicable,
    make_schedule,
    pure_pm1_applicable,
    simulated_annealing_dense,
)
from tsu_tpu_torch.samplers.gibbs import (
    GibbsSampler,
    blocked_sweeps,
    boltzmann_energy_batch,
    color_groups,
    dense_gibbs_sample,
    gibbs_sweeps,
)
from tsu_tpu_torch.samplers.tempering import (
    parallel_tempering_bonds,
    parallel_tempering_dense,
    parallel_tempering_lattice,
)
from tsu_tpu_torch.samplers.tempering_ladder import (
    build_tempering_ladder,
    houdayer_move,
    predict_swap_acceptance,
    pt_ground_state_search,
)

__all__ = [
    "GibbsSampler",
    "anneal_lattice",
    "anneal_spin_glass",
    "blocked_sweeps",
    "boltzmann_energy_batch",
    "build_tempering_ladder",
    "color_groups",
    "dense_gibbs_sample",
    "discrete_table_applicable",
    "gibbs_sweeps",
    "houdayer_move",
    "make_schedule",
    "parallel_tempering_bonds",
    "parallel_tempering_dense",
    "parallel_tempering_lattice",
    "predict_swap_acceptance",
    "pt_ground_state_search",
    "pure_pm1_applicable",
    "simulated_annealing_dense",
]
