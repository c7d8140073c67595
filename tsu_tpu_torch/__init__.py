"""tsu_tpu_torch — the PyTorch and CUDA port of tsu_tpu.

The port grows slice by slice beside the JAX package (see ROADMAP.md). It
imports torch, numpy and scipy, never JAX and never ``tsu_tpu``. Its hot
loops are CUDA kernels for Hopper built at first use: the fused checkerboard
sweep of one lattice, of a batch of lattices and of a shard; the bond
half-sweep of one lattice and of a batch of replicas; the resident
multi-sweep kernel (S sweeps in one launch); and the exact-sigmoid
half-sweep of a lattice or a shard. ``tsu_tpu_torch.parallel`` drives
sharded runs over a mesh of devices from one process. Dense Boltzmann
machines, Ising models on any graph and MAX-CUT sample and anneal on colour
sweeps replayed as CUDA graphs (``samplers/gibbs.py``), sparse graphs on
ELL arrays (``ops/sparse_ising.py``); ``checkpoint`` saves and resumes
long runs. Continuous energies sample by Langevin dynamics
(``ThermalSamplingUnit``), MALA, HMC, NUTS, annealed SMC and mean-field VI,
their step loops replayed as CUDA graphs (``samplers/loop.py``), behind the
reference's sampler API (``GaussianSampler``, ``sample_gaussian``, ...).
Entry points run on
the card unless the caller passes ``device="cpu"``, which runs the plain
PyTorch versions.
"""

from tsu_tpu_torch.api import (
    Backend,
    BayesianSampler,
    GaussianSampler,
    MaxCutProblem,
    MultimodalSampler,
    OptimizationProblem,
    Sampler,
    SamplingResult,
    compare_samplers,
    optimize,
    sample_gaussian,
    sample_multimodal,
)
from tsu_tpu_torch.config import (
    ConfigurationError,
    GibbsConfig,
    IsingConfig,
    SamplingError,
    TSUConfig,
    TSUError,
)
from tsu_tpu_torch.core import ProbabilisticNeuron, ThermalSamplingUnit, validate_distribution
from tsu_tpu_torch.energy import BNNPosterior, MixtureOfGaussians, Quadratic
from tsu_tpu_torch.models.ising import (
    IsingChain,
    IsingGrid,
    IsingModel,
    demonstrate_phase_transition,
)
from tsu_tpu_torch.ops.checkerboard_resident import resident_anneal, resident_sweeps
from tsu_tpu_torch.parallel import (
    annealed_smc_sharded,
    make_mesh,
    mesh_info,
    plan_lattice_mesh,
    sharded_checkerboard_sweeps,
    sharded_lattice_sample,
)
from tsu_tpu_torch.samplers import (
    GibbsSampler,
    MeanFieldParams,
    anneal_spin_glass,
    annealed_smc,
    build_tempering_ladder,
    fit_meanfield_vi,
    parallel_tempering_bonds,
    pt_ground_state_search,
    sample_hmc,
    sample_hmc_adaptive,
    sample_langevin,
    sample_mala,
    sample_nuts,
)

__all__ = [
    "BNNPosterior",
    "Backend",
    "BayesianSampler",
    "ConfigurationError",
    "GaussianSampler",
    "GibbsConfig",
    "GibbsSampler",
    "IsingChain",
    "IsingConfig",
    "IsingGrid",
    "IsingModel",
    "MaxCutProblem",
    "MeanFieldParams",
    "MixtureOfGaussians",
    "MultimodalSampler",
    "OptimizationProblem",
    "ProbabilisticNeuron",
    "Quadratic",
    "Sampler",
    "SamplingError",
    "SamplingResult",
    "TSUConfig",
    "TSUError",
    "ThermalSamplingUnit",
    "anneal_spin_glass",
    "annealed_smc",
    "annealed_smc_sharded",
    "build_tempering_ladder",
    "compare_samplers",
    "demonstrate_phase_transition",
    "fit_meanfield_vi",
    "make_mesh",
    "mesh_info",
    "optimize",
    "parallel_tempering_bonds",
    "plan_lattice_mesh",
    "pt_ground_state_search",
    "resident_anneal",
    "resident_sweeps",
    "sample_gaussian",
    "sample_hmc",
    "sample_hmc_adaptive",
    "sample_langevin",
    "sample_mala",
    "sample_multimodal",
    "sample_nuts",
    "sharded_checkerboard_sweeps",
    "sharded_lattice_sample",
    "validate_distribution",
]
