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
Bayesian neural networks train by SVI and anchored ensembles on graphed
loops (``models/ml.py``), beside the probabilistic layers of the API, the
hardware models, profiling hooks and the benchmark suites
(``tsu_tpu_torch.benchmarks``). The command line (``cli``), the demos
(``demos``), the plots (``visualization``: matplotlib and plotly are
imported only when a plot is drawn), the tools of ``tsu_tpu_torch.tools``
and the graft entry (``graft_entry``) sit on top. The namespace carries
every name of ``tsu_tpu``. Entry points run on the card unless the caller
passes ``device="cpu"``, which runs the plain PyTorch versions.
"""

from tsu_tpu_torch.api import (
    Backend,
    BayesianSampler,
    BernoulliActivation,
    GaussianSampler,
    MaxCutProblem,
    MultimodalSampler,
    OptimizationProblem,
    ProbabilisticLayer,
    ProbabilisticModel,
    Sampler,
    SamplingResult,
    StochasticLinear,
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
from tsu_tpu_torch.hardware import (
    ConservativeEstimator,
    GPUHardwareSpec,
    HardwareEmulator,
    HardwarePerformanceEstimator,
    TPUHardwareSpec,
    TSUHardwareSpec,
)
from tsu_tpu_torch.models.ising import (
    IsingChain,
    IsingGrid,
    IsingModel,
    demonstrate_phase_transition,
)
from tsu_tpu_torch.models.ml import (
    AnchoredEnsembleRegressor,
    BayesianLinear,
    BayesianNetwork,
    BayesianRegressor,
    PosteriorSample,
    PredictionResult,
    StochasticLayer,
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
from tsu_tpu_torch.visualization import (
    plot_active_learning_curve,
    plot_energy_landscape_2d,
    plot_interactive_energy_landscape,
    plot_ising_state,
    plot_phase_transition,
    plot_predictions_with_uncertainty,
    plot_sampling_diagnostics,
    plot_uncertainty_vs_error,
)

# Alias of the reference's namespace.
TSU = ThermalSamplingUnit

__version__ = "0.5.0"

__all__ = [
    "AnchoredEnsembleRegressor",
    "BNNPosterior",
    "Backend",
    "BayesianLinear",
    "BayesianNetwork",
    "BayesianRegressor",
    "BayesianSampler",
    "BernoulliActivation",
    "ConfigurationError",
    "ConservativeEstimator",
    "GPUHardwareSpec",
    "GaussianSampler",
    "GibbsConfig",
    "GibbsSampler",
    "HardwareEmulator",
    "HardwarePerformanceEstimator",
    "IsingChain",
    "IsingConfig",
    "IsingGrid",
    "IsingModel",
    "MaxCutProblem",
    "MeanFieldParams",
    "MixtureOfGaussians",
    "MultimodalSampler",
    "OptimizationProblem",
    "PosteriorSample",
    "PredictionResult",
    "ProbabilisticLayer",
    "ProbabilisticModel",
    "ProbabilisticNeuron",
    "Quadratic",
    "Sampler",
    "SamplingError",
    "SamplingResult",
    "StochasticLayer",
    "StochasticLinear",
    "TPUHardwareSpec",
    "TSU",
    "TSUConfig",
    "TSUError",
    "TSUHardwareSpec",
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
    "plot_active_learning_curve",
    "plot_energy_landscape_2d",
    "plot_interactive_energy_landscape",
    "plot_ising_state",
    "plot_phase_transition",
    "plot_predictions_with_uncertainty",
    "plot_sampling_diagnostics",
    "plot_uncertainty_vs_error",
    "pt_ground_state_search",
    "quick_demo",
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


def quick_demo(device=None):
    """A quick demonstration of the core capabilities on ``device``
    (default the card): Gaussian sampling and a 16x16 Ising grid."""
    import numpy as np

    from tsu_tpu_torch.config import resolve_device

    dev = resolve_device(device)
    print("tsu_tpu_torch quick demo")
    print("=" * 40)
    sampler = GaussianSampler(mu=0.0, sigma=1.0,
                              backend=Backend.CPU if dev.type == "cpu" else Backend.CUDA)
    result = sampler.sample(n_samples=1000)
    print(f"Gaussian sampling: mean={np.mean(result.samples):+.3f} "
          f"std={np.std(result.samples):.3f} "
          f"({result.metadata['samples_per_second']:.0f} samples/s)")
    grid = IsingGrid((16, 16), coupling_strength=1.0, device=dev)
    samples = grid.sample(n_samples=64, temperature=1.5)
    print(f"Ising 16x16 @ T=1.5: |M|={abs(grid.magnetization(samples)):.3f}")
    print("Demo complete.")
