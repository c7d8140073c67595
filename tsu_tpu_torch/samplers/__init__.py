"""Samplers of the port (counterparts of ``tsu_tpu/samplers/``): dense Gibbs
sampling on colour sweeps; annealing, parallel tempering and the spin-glass
ladder tools, dense and on the batched sweep kernels; and the continuous
samplers (Langevin, MALA, HMC, NUTS, annealed SMC, mean-field VI), whose
step loops replay as CUDA graphs on the card (``loop.py``)."""

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
from tsu_tpu_torch.samplers.hmc import sample_hmc, sample_hmc_adaptive
from tsu_tpu_torch.samplers.langevin import make_langevin_step, sample_langevin
from tsu_tpu_torch.samplers.mala import sample_mala
from tsu_tpu_torch.samplers.nuts import sample_nuts
from tsu_tpu_torch.samplers.smc import annealed_smc, systematic_resample_indices
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
from tsu_tpu_torch.samplers.vi import MeanFieldParams, fit_meanfield_vi

__all__ = [
    "GibbsSampler",
    "MeanFieldParams",
    "annealed_smc",
    "fit_meanfield_vi",
    "make_langevin_step",
    "sample_hmc",
    "sample_hmc_adaptive",
    "sample_langevin",
    "sample_mala",
    "sample_nuts",
    "systematic_resample_indices",
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
