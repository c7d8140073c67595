#!/usr/bin/env python3
"""Drive the PyTorch port (tsu_tpu_torch) once on one NVIDIA GPU and check it.

Run from the repository root:

    python3 chip_smoke.py

Phases, each of which raises on failure:
 1. print the card (nvidia-smi name and power limit), torch and CUDA versions,
    and build the fused-sweep, the bond, the resident and the half-sweep
    kernels (and the earlier bodies of the last two) from
    tsu_tpu_torch/csrc, one nvcc per source, all at once;
 2. kernel against its plain PyTorch version with injected uniforms, bit for
    bit: 3 sweeps over a temperature schedule at 4096^2 bf16 periodic, at
    1002x1000 f32 open and at 4096x4094 bf16 (C/2 = 2047, not a multiple of
    4: the kernel's site-by-site path) open and periodic;
 3. the same in Philox mode: 2 sweeps at 4096^2 and 4096x4094 bf16;
 4. statistics: 4x4 periodic at T=2.5 against exact enumeration, T=1e9 at
    1024^2 against m=0, T=2.0 at 512^2 against Onsager's magnetization;
 5. the main path, IsingGrid((4096, 4096), periodic=True).sample(...), with
    a count of kernel launches;
 6. kernel and plain times per sweep at 4096^2 bf16, timed with CUDA events:
    the kernel through fused_sweeps (one host launch per sweep, as the
    headline runs it) and from a CUDA graph of 1000 launches;
 7. the batched kernel against its plain version, bit for bit, at the shape
    and tables of each batched path: injected uniforms over 3 sweeps and
    Philox mode over 2 at 16 x 1024^2 bf16 (the phase scan's 16
    temperatures), 2 x 4096^2 bf16 (rows of the anneal's schedule, keyed by
    its global sweep counter) and 64 x 256^2 bf16 (the tempering ladder);
    injected uniforms at 3 x 1002x1000 f32 open, and 2 x 4096x4094 bf16 open
    and periodic (C/2 = 2047), injected and Philox; and element b of one
    batched launch against the single-lattice kernel under seed b;
 8. statistics of the batched paths: a 4x4 ensemble and the cold rung of a
    4x4 tempering ladder against exact enumeration, decorrelated members at
    one temperature, a 16x16 anneal to the ground state;
 9. the batched paths at full size, each with its launch counts and wall
    time: the phase scan (16 x 1024^2), IsingGrid((4096, 4096))
    .find_ground_state(1000) and tempering over 64 rungs of 256^2, with
    physics checks, and each at 16x16 equal on cuda and on cpu;
10. batched kernel and plain times per sweep at 16 x 1024^2 bf16, the kernel
    launched one by one and from a CUDA graph of 1000 launches;
11. the bond kernels against their plain versions at the spin-glass paths'
    shapes: K4 discrete (packed, pure) at 4096^2 bf16 on the anneal's
    schedule rows, injected over 3 sweeps and Philox over 2, bit for bit;
    K4 continuous at 4096^2 f32 with Gaussian bonds and a field, half-sweep
    by half-sweep, equal outside the stated band (its size printed); K4 at
    4096x4094 (C/2 = 2047, the kernel's site-by-site path), discrete bf16
    periodic and continuous f32 open, injected and Philox; K4 at
    1002x1000 f32 open in both modes; K5 discrete at 284 x 256^2 (a ladder of
    142 rungs x 2 copies) and 64 x 256^2 bf16, injected and Philox; and
    element b of one K5 launch against K4 under the matching key;
12. spin-glass statistics: a 4x4 +-J instance against enumeration through
    IsingGrid(bonds).sample (continuous) and the cold rung of a 4-rung
    parallel_tempering_bonds (discrete); a gauge-transformed ferromagnet at
    512^2, T = 2.0, against Onsager's magnetization in both modes;
13. the spin-glass paths at full width, each with its wall time and launch
    counts: IsingGrid(4096^2, Gaussian bonds).sample_observables(4) (280 K4
    launches), IsingGrid(4096^2, +-J).find_ground_state(3000) (6,000 K4
    launches), parallel_tempering_bonds over 64 rungs of 256^2 (600 K5
    launches), build_tempering_ladder at 256^2 then pt_ground_state_search
    with 2 copies and Houdayer moves (K5 only); and each at 16x16 equal on
    cuda and on cpu;
14. bond kernel and plain times per half-sweep: K4 discrete at 4096^2 bf16
    and at 4096x4094, K4 continuous at 4096^2 f32, K5 discrete at
    284 x 256^2 and 64 x 256^2 bf16; the kernel's time from a CUDA graph of
    1000 launches (the JSON line's "ms") and launched one by one;
15. the resident kernel (K6 at one table, K7 over a schedule, each one
    launch per call) against its plain version, bit for bit: injected
    uniforms over 3 sweeps at 4096^2 bf16 periodic and at 1002x1000 f32
    open, Philox mode over 2 sweeps at 4096^2 and 8192^2 bf16, and both
    modes at the tiles' edge cases: 4x4 periodic bf16 and f32 (bands of one
    row), 130x250 f32 open (C/2 = 125, a ragged last word) and 4096^2 f32;
    each decomposition variant of K1 (K8: prng_only, prng_grouped, nomath)
    against its plain version at 4096^2 bf16, injected and Philox;
16. resident statistics: 4x4 through K6 against exact enumeration, 512^2
    at T = 2.0 through K6 against Onsager's magnetization, K7's 64^2
    anneal below -1.85 per site, and kernel_bench's --check moments of K6
    against K1 at 128^2;
17. this slice's paths at full width, each from zeroed counts: the tools
    kernel_bench (all rows, 4096^2 bf16, 500 sweeps a call), bench (the
    headline K1 row and the EA K4 row) and kernel_decomposition (4096^2
    bf16, 500 sweeps), and resident_anneal at 4096^2 bf16 over a 1000-sweep
    schedule from T = 5 to 0.05, with launch counts (one K6 launch per
    resident_sweeps call, one K7 launch per anneal);
18. K6 and K7 ms per sweep at 4096^2 bf16 (a 500-sweep call / 500) beside
    K1's and the plain versions', in turns with the grid-stride body of
    csrc/checkerboard_resident_gridstride.cu (old, new, new, old); the
    grid (blocks, dynamic shared bytes a block, rows a band); the
    cost of the barriers and halo exchanges (K6 on one row a block); and
    each K8 variant's ms per sweep;
19. the exact-sigmoid half-sweep (K3) against its first body
    (csrc/checkerboard_halfsweep_scalar.cu) at every site, the band included,
    and against its plain version outside the stated band (its size
    printed), half-sweep by half-sweep, injected 24-bit uniforms and Philox:
    4096^2 f32 periodic, 4096^2 bf16, 1002x1000 f32 open, three 2048x2048
    shards (rows 2048.., compact columns 1026.. with random row and column
    halos; compact columns 1024.. with the columns read in place from a
    wider plane, strided; the open top-left corner, whose up row and left
    column are zeros), and R in (2, 6, 10) x C/2 in (1, 3, 4, 5, 33), both
    dtypes, periodic and open, with and without column halos; K1's shard
    mode against its plain
    version, bit for bit, on 1024x4096 shards (interior periodic, the top and
    bottom of an open lattice), injected and Philox;
20. sharded == unsharded at 4096^2, bit for bit at one seed: 4 row shards
    (K1 in shard mode, bf16) and 2 x 2 shards (K3, f32) against the one-shard
    run, periodic and open;
21. sharded statistics: 4x4 through sharded_lattice_sample on 2 row shards
    (K1) and on 2 x 2 shards (K3) against exact enumeration, and 512^2 at
    T = 2.0 on 2 x 2 shards against Onsager's magnetization;
22. this slice's paths at full width, each from zeroed counts, with its wall
    and launch counts: IsingGrid(4096^2).sample_observables(4) on
    make_mesh(rows=4, devices=[cuda:0] * 4) (560 K1 launches) and on rows=2,
    cols=2 (1,120 K3 launches; every column halo a view of the neighbour
    shard's plane, no copy), and parallel_tempering_replica_sharded with
    64 rungs of 256^2 over replica=4 (1,200 K2 launches); each at 16x16
    equal on cuda and on cpu;
23. K3 ms per half-sweep at 4096^2 f32 and bf16 and on a 2048x2048 f32
    shard with strided column halos, from CUDA graphs, in turns with its
    first body (first, this, this, first), beside its plain version; K1's
    shard mode ms per sweep of a 1024x4096 bf16 shard from a CUDA graph; the
    host time of one sharded sweep at 4096^2 on one card, halo exchange
    included, on each mesh;
24. dense statistics on the card, each through the device route (checked
    with last_route): a 10-spin random-J Boltzmann machine through
    GibbsSampler (checkerboard, and sequential with an initial state), a
    12-spin periodic IsingChain, a 3x5 periodic IsingGrid (the dense
    fall-back) and parallel_tempering_dense on 10 spins, against exact
    enumeration;
25. the colour sweep replayed from its CUDA graph against the eager colour
    loop on the same uniforms: a 4,096-spin SK instance (J_ij = ±1/sqrt(n),
    4,096 colours), 8 chains, 2 sweeps, equal at every site outside the
    1e-6 band around the threshold (the band's sites counted);
26. the dense paths at full width: ms per 4,096-spin sweep eager and
    graphed (CUDA events) and the host's launch calls per sweep of each; the
    wall of IsingModel(4096).sample(64) with 8 chains, of a 63x65 periodic
    IsingGrid.sample(64) (4,095 spins, the dense fall-back) and of
    optimize(MaxCutProblem(W)) on G(2000, 0.5), its cut beside the native
    greedy bound (3 restarts);
27. maxcut_sparse at the optimization suite's size (100,000 nodes, 500,000
    edges drawn as the suite draws them, 2,000 steps, 8 chains, after one
    warm-up call): the ELL build's seconds, the anneal's wall, the host's
    launch calls per step and the cut, which must reach the native greedy
    bound (3 restarts);
28. resume on the card, each run killed after its first snapshot and
    resumed, equal to the uninterrupted run bit for bit: sparse_anneal
    (10,000 nodes, 4 chunks), anneal_spin_glass (256^2 ±J, 3 restarts),
    pt_ground_state_search (64^2 ±J, 40 iterations, a snapshot every 10)
    and sharded_lattice_sample on 2 x 2 shards of one card;
29. each continuous step loop (Langevin BAOAB and Euler-Maruyama, MALA's
    burn-in and main loops, on a mixture and on a 97-parameter BNN
    posterior, HMC, adaptive HMC, NUTS, annealed SMC, mean-field VI) on
    one set of draws: its CUDA graph replay == its eager loop on the card
    bit for bit, and the card's eager loop == the CPU's within 1e-4, at 4
    chains x dim 4;
30. continuous statistics on the card: Langevin, MALA, HMC, adaptive HMC
    and NUTS against the moments of N(0, 1) in dim 4 and of the
    anisotropic Gaussian of tests/test_nuts.py; annealed SMC's log Z
    against -d ln 3 (16,384 particles, dim 10); VI against the mean-field
    optimum of a correlated 2-D Gaussian; p_bit and sample_categorical
    rates; every route "graph";
31. the continuous paths at their users' sizes, each from zeroed kernel
    counts (no lattice kernel may run) with its wall, host launch calls a
    step, idle share under the profiler, route ("graph", else the run
    fails) and physics: the README quick start (62,600 BAOAB steps of 16
    chains, the KS test), the scaling suite's Langevin row (1,024 chains x
    dim 10), MALA on the full-Bayes row's 1,153-parameter BNN posterior
    (16 chains, 3,000 burn-in, 32 draws; accept rate in [0.4, 0.75], the
    energy lower than the start's), NUTS (max_depth 8) and adaptive HMC on
    it, annealed_smc at 16,384 x 10 and annealed_smc_sharded on 4 shards of
    one card (== the unsharded run bit for bit), fit_meanfield_vi on the
    posterior (the ELBO improves) and optimize's annealed-Langevin fallback
    on a torch objective in dim 10;
32. ms per step of each sampler's loop, eager and graphed in turns, and
    the host's launch calls per step of each;
33. the BNN loops on one set of draws: forward_sample and elbo_loss on the
    card == on the CPU within 1e-5, 20 full-batch ELBO steps of a
    (1, 32, 32, 1) net on 100 points with n_mc 3, 50 steps of an anchored
    ensemble of 8 (1, 32, 32, 1) members on 80 points and the predictive
    (200 draws on 200 points): the card == the CPU (losses within 1e-5
    relative, the ensemble's 1e-4, parameters within 1e-4; the ensemble
    with tanh units, and with relu units over 20 steps, the 50 relu steps'
    difference logged), the graph replay == the eager loop on the card bit
    for bit, every graphed loop's route "graph";
34. the ML suite at full size, MLBenchmark(seed=0).run_all_benchmarks()
    (sinusoid and heteroscedastic 800 epochs, extrapolation 8 members x
    2,000 epochs, full Bayes 800 VI epochs then MALA with 16 chains, 3,000
    burn-in and 512 draws), each row in its band (coverage_95 in [0.85,
    1], sinusoid and full-Bayes r^2 > 0.9, extrapolation uncertainty ratio
    > 5 and coverage in [0.88, 1]) and every row's route "graph"; and
    measure_bnn_dp_scaling at its defaults on make_mesh's [cuda:0] * 4,
    whose 4 x 16,384-point split run must equal the same points on one
    device within 1e-4 relative;
35. measure_lattice_matched at 4096^2 x 2,500 sweeps (10,000 K1 launches
    in shard mode); the quick runner's checks (every row of the four
    suites, each row's route, K5's launches in spin_glass_ea alone, the
    quick-mode wall) run in phase 37 on the CLI's run of it;
36. ms per step of the BNN fit step, the ensemble step and a 200-draw
    predictive on 200 points, eager and graphed in turns, and the host's
    launch calls per step of each;
37. the command line at its users' sizes through cli.main, each command
    from zeroed counts with its wall, launches and output: version; sample
    at its defaults; ising-sweep at the phase scan's 16 temperatures x
    1024^2 (328 K2 launches; |M| > 0.9 at the coldest, < 0.2 at the
    hottest); anneal --size 4096 --steps 1000 (1,000 K2; below -1.85 per
    site, phase 9's bound);
    anneal --spin-glass at 4096^2, 3,000 steps, 2 restarts, checkpointed
    (12,000 K4; below -1.3 per site), then resumed from the snapshot
    (the same JSON, no launch); bnn at its defaults (9 predictions); bench
    --quick --no-save with phase 35's checks on the runner's result;
38. critical_ess's Tc_L64 (thin 6, 103,829 measurements padded to 120,000)
    and T3.0_L4096 (2,000 burn-in, 20,000 measurements, thin 1) rows at the
    script's settings, each with its K1 launches (840,000 and 40,000), its
    tau_int, ESS/s, run_over_tau and wall (<|m|> < 0.01 at T = 3.0, every
    tau finite and positive), the Wolff row at L = 64 (4,000 steps, host
    numpy in a second process started with phase 37) and the 4096^2
    projection at K1's rate measured here (one tools.bench headline call)
    beside the card's name;
39. demo_continuous_sampling (3 of 3 modes), demo_phase_transition (|M|
    within 0.1 of Onsager at T <= 2.0) and demo_bayesian_inference (the
    posterior mean within 0.1 of theta) on the card; pt_spin_glass_probe at
    its defaults (256^2, 2,000 iterations; K5 alone); scaling_projection's
    measured row (10,000 K1 launches in shard mode) and its projections;
    with matplotlib the demos' figures drawn on Agg into a temporary
    directory, without it a plot call's ImportError;
40. graft_entry: entry()'s sweep of 256^2 once (one K1 launch), then
    dryrun_multichip(4) on the visible card and cuda:0 repeated (K1's shard
    mode, K3, K2 and a data-parallel BNN step);
41. the multi-process runtime under ``python -m torch.distributed.run
    --standalone``, the ranks sharing the one card over gloo (the backend
    rule; with a card a rank, NCCL), each rank running
    tsu_tpu_torch.tools.multiprocess_check: on 4 ranks
    the README quick start (4096^2, T = 2.269, the default IsingConfig, 4
    samples) on 4 row shards (560 K1 shard-mode launches in all) and on
    2 x 2 (1,120 K3), replica-sharded tempering of 64 rungs x 256^2 over
    300 rounds (1,200 K2) and annealed_smc_sharded at 16,384 x 10 (and 10
    steps of it with rank 0's host launch calls a step counted under the
    profiler); on 2 ranks the quick start on 4 row
    shards, two a rank, and the same run checkpointed every 2 samples and
    stopped after its first snapshot, then resumed in this process;
    tsu_tpu_torch.tools.pod_scaling at its sizes on 4 ranks. Every rank's
    observables (rank 0's final planes), rungs, swaps, particles, weights
    and log Z == the one-process run's at the same seed, bit for bit, and
    the resumed run == the uninterrupted one; each run's wall, host ms a
    sweep, bytes and messages a halo exchange and launches per kernel;
    a rank that fails or a torchrun past its timeout fails the phase.

A "slice 4:", a "slice 5:", a "slice 6:", a "slice 7:" and a "slice 8:"
JSON log line carry those phases' numbers.
The last two lines are a JSON line per kernel (its time, launches, error,
plain version's time and its bound: the bytes it must move over 3.35 TB/s,
or for K6 and K7 the int32 instructions of their Philox calls over the
card's int32 rate, the byte bound beside it; the eight TPU kernels K1-K8
and their CUDA counterparts; K1 and K2 also carry graph_ms, their time from
a CUDA graph, K3 its time at bf16 and on the shard and its first body's
times, K4 its time at 4096x4094, K5 at 64 x 256^2, K6 and K7 the
grid-stride body's time, the barrier cost and the grid; K1-K5 the launches
of each slice-7 path that ran them, K1-K3 those of each slice-8 path,
summed over its ranks)
and the result line {"ok": true, "device": {...}}. Without CUDA the script
exits non-zero before printing either.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

from tsu_tpu_torch import (
    BNNPosterior,
    GibbsConfig,
    GibbsSampler,
    IsingChain,
    IsingConfig,
    IsingGrid,
    IsingModel,
    MaxCutProblem,
    MixtureOfGaussians,
    OptimizationProblem,
    Quadratic,
    ThermalSamplingUnit,
    TSUConfig,
    annealed_smc,
    annealed_smc_sharded,
    demonstrate_phase_transition,
    fit_meanfield_vi,
    optimize,
    sample_hmc,
    sample_hmc_adaptive,
    sample_langevin,
    sample_mala,
    sample_nuts,
    validate_distribution,
)
from tsu_tpu_torch import AnchoredEnsembleRegressor, BayesianRegressor, native
from tsu_tpu_torch import cli, demos, graft_entry, plot_phase_transition
from tsu_tpu_torch.benchmarks import BenchmarkRunner, MLBenchmark
from tsu_tpu_torch.benchmarks.scaling import (
    bnn_dp_row,
    measure_bnn_dp_scaling,
    measure_lattice_matched,
)
from tsu_tpu_torch.models import ml
from tsu_tpu_torch.ops import sparse_ising
from tsu_tpu_torch.models.lattice_sampler import sample_grid_ensemble
from tsu_tpu_torch.ops import _build
from tsu_tpu_torch.ops.checkerboard import (
    lattice_energy_batch,
    merge_checkerboard,
    plane_energy_batch,
    split_checkerboard,
    wrap_halos,
)
from tsu_tpu_torch.ops.checkerboard_fused import (
    fused_sweep,
    fused_sweep_batched,
    fused_sweep_batched_reference,
    fused_sweep_reference,
    fused_sweeps,
    sigmoid_table16,
)
from tsu_tpu_torch.ops.checkerboard_bonds import color_bond_weights, pack_bond_codes
from tsu_tpu_torch.ops.checkerboard_bonds_kernel import (
    CONTINUOUS_BAND,
    bond_halfsweep,
    bond_halfsweep_batched,
    bond_halfsweep_batched_reference,
    bond_halfsweep_reference,
    bond_key,
    bond_sweep_keys,
    checkerboard_sweeps_bonds_kernel,
    continuous_band,
)
from tsu_tpu_torch.ops.checkerboard_fused import sigmoid_table
from tsu_tpu_torch.ops.checkerboard_kernel import (
    halfsweep,
    halfsweep_band,
    halfsweep_reference,
)
from tsu_tpu_torch.ops.checkerboard_resident import (
    resident_anneal,
    resident_anneal_tables,
    resident_anneal_tables_reference,
    resident_grid,
    resident_sweeps,
    resident_sweeps_table,
    resident_sweeps_table_reference,
    tile_bounds,
)
from tsu_tpu_torch.ops.kernel_decomposition import (
    MODES,
    decomposition_sweep,
    decomposition_sweep_reference,
)
from tsu_tpu_torch.parallel import (
    lattice,
    make_mesh,
    parallel_tempering_replica_sharded,
    sharded_checkerboard_sweeps,
    sharded_lattice_sample,
)
from tsu_tpu_torch.oracle import wolff_chain
from tsu_tpu_torch.rng import fold_seed, sweep_keys
from tsu_tpu_torch.samplers import (
    anneal_spin_glass,
    build_tempering_ladder,
    parallel_tempering_dense,
    make_schedule,
    parallel_tempering_bonds,
    parallel_tempering_lattice,
    pt_ground_state_search,
)
from tsu_tpu_torch.samplers import annealing, tempering_ladder
from tsu_tpu_torch.samplers.gibbs import ColourPlan, DenseSweeper, colour_sweep
from tsu_tpu_torch.samplers.hmc import hmc_adaptive_loops, hmc_loop, run_hmc, run_hmc_adaptive
from tsu_tpu_torch.samplers.langevin import langevin_loop, run_langevin
from tsu_tpu_torch.samplers.loop import Draws
from tsu_tpu_torch.samplers.mala import CHUNK as MALA_CHUNK
from tsu_tpu_torch.samplers.mala import mala_loops, run_mala
from tsu_tpu_torch.samplers.nuts import nuts_loops, run_nuts
from tsu_tpu_torch.samplers.smc import run_smc, smc_loop
from tsu_tpu_torch.samplers.vi import run_vi, vi_loop
from tsu_tpu_torch.tools import (
    bench,
    critical_ess,
    halfsweep_bodies,
    kernel_bench,
    kernel_decomposition,
    pt_spin_glass_probe,
    resident_bodies,
    scaling_projection,
)
from tsu_tpu_torch.tools.profile_paths import (
    DENSE,
    FULL_BAYES,
    QUICK,
    SPARSE,
    bnn_start,
    full_bayes_posterior,
    profile_once,
    sk_couplings,
    suite_graph,
)
from tsu_tpu_torch.tools.timing import card, graph_ms, host_launches, host_ms
from tsu_tpu_torch.tools.timing import event_ms as time_sweeps

MAIN_SHAPE = (4096, 4096)
SCHEDULE = [2.269, 4.0, 0.5]
ENSEMBLE = (16, 1024, 1024)              # the phase scan's batch: 16 x 1024^2
SCAN_TEMPS = np.linspace(1.5, 3.5, ENSEMBLE[0])
PT_SHAPE, PT_RUNGS = (256, 256), 64
LADDER_BATCH = 284                       # spin_glass_ea's ladder: 142 rungs x 2 copies
EA_GS_DENSITY = -1.4015                  # 2-D +-J EA ground-state energy per site
RESIDENT_SWEEPS = 500                    # sweeps per timed resident call (kernel_bench's depth)
BENCH = dict(sweeps=5000, ea_sweeps=1000, calls=3, n_trials=3)   # tools.bench's defaults
HBM_BYTES_PER_S = 3.35e12                # H100 SXM device memory rate
INT32_OPS_PER_S = 132 * 64 * 1.98e9      # H100 SXM int32 lanes: 132 SMs x 64 x 1.98 GHz
PHILOX_INT32 = 40                        # int32 instructions of one Philox4x32-10 call in the
                                         # resident kernel's SASS (10 rounds of two IMAD.WIDE.U32
                                         # and two LOP3; the key schedule runs on uniform registers)
RESIDENT_SHAPES = (((4, 4), torch.bfloat16, True), ((4, 4), torch.float32, True),
                   ((130, 250), torch.float32, False), ((4096, 4096), torch.float32, True))
SHARD = (1024, 4096)                     # one of 4 row shards of MAIN_SHAPE
RAGGED_SHAPE = (4096, 4094)              # full width with C/2 = 2047, not a multiple of 4


def log(msg: str):
    print(msg, flush=True)


KERNELS = (fused_sweep, fused_sweep_batched, bond_halfsweep, bond_halfsweep_batched,
           resident_sweeps_table, resident_anneal_tables, decomposition_sweep, halfsweep)
NAMES = ("K1", "K2", "K4", "K5", "K6", "K7", "K8", "K3")


def reset_counts():
    for k in KERNELS:
        k.launches = 0


def counts():
    """Launches of K1, K2, K4, K5, K6, K7, K8 and K3 since the last reset."""
    return tuple(k.launches for k in KERNELS)


def expect(*leading) -> tuple:
    """A launch-count tuple: ``leading`` for K1, K2, ..., the rest zero."""
    return tuple(leading) + (0,) * (len(KERNELS) - len(leading))


def bound_ms(n_bytes: float) -> float:
    """The least time the card could take to move n_bytes of device memory."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def random_black(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    up = torch.rand(shape, generator=gen) < 0.5
    lat = torch.where(up, 1.0, -1.0).to(dtype)
    return split_checkerboard(lat)[1].contiguous().to(device)


def compare_chains(black, temps, periodic, uniforms=None, seed=0) -> float:
    """Run kernel and plain version sweep by sweep from one input; raise
    unless every plane agrees bit for bit. Returns the max abs difference."""
    b_k = b_p = black
    err = 0.0
    for k, T in enumerate(temps):
        table = sigmoid_table16(1.0, 0.1, T).to(black.device)
        u = None if uniforms is None else uniforms[k]
        r_k, b_k = fused_sweep(b_k, table, seed=seed, sweep=k, periodic=periodic, uniforms=u)
        r_p, b_p = fused_sweep_reference(b_p, table, seed=seed, sweep=k,
                                         periodic=periodic, uniforms=u)
        for a, b in ((r_k, r_p), (b_k, b_p)):
            err = max(err, float((a.float() - b.float()).abs().max()))
            if not torch.equal(a, b):
                raise AssertionError(
                    f"kernel != plain at sweep {k}: {int((a != b).sum())} sites differ "
                    f"(shape {tuple(black.shape)}, {black.dtype}, periodic={periodic}, "
                    f"injected={uniforms is not None})")
    torch.cuda.synchronize()
    return err


def batch_means(x: np.ndarray, n_batches: int = 50):
    b = x[: len(x) // n_batches * n_batches].reshape(n_batches, -1).mean(axis=1)
    return float(b.mean()), float(b.std(ddof=1) / np.sqrt(n_batches))


def exact_4x4(T: float):
    """<|m|> and <e> per site of the 4x4 periodic lattice by enumerating all
    2^16 states."""
    bits = (np.arange(2**16)[:, None] >> np.arange(16)) & 1
    s = (2 * bits - 1).reshape(-1, 4, 4).astype(np.float64)
    E = -(s * np.roll(s, -1, 2)).sum((1, 2)) - (s * np.roll(s, -1, 1)).sum((1, 2))
    w = np.exp(-(E - E.min()) / T)
    w /= w.sum()
    return float(w @ np.abs(s.mean((1, 2)))), float(w @ E) / 16


def phase_statistics(dev):
    T = 2.5
    grid = IsingGrid((4, 4), periodic=True, seed=1, device=dev,
                     config=IsingConfig(n_burnin=100, n_sweeps=1))
    s = grid.sample(n_samples=20000, temperature=T)
    m, se_m = batch_means(np.abs(s.mean(axis=1)).astype(np.float64))
    e, se_e = batch_means(grid.energies(s) / 16)
    m_x, e_x = exact_4x4(T)
    log(f"4x4 T=2.5: <|m|> {m:.5f} +- {se_m:.5f} (exact {m_x:.5f}); "
        f"<e> {e:.5f} +- {se_e:.5f} (exact {e_x:.5f})")
    if abs(m - m_x) > 4 * se_m or abs(e - e_x) > 4 * se_e:
        raise AssertionError("4x4 moments differ from exact enumeration by more than 4 SE")

    s = IsingGrid((1024, 1024), periodic=True, seed=2, device=dev,
                  config=IsingConfig(n_burnin=5, n_sweeps=1)).sample(
        n_samples=2, temperature=1e9)
    m_hot = float(np.abs(s.mean(axis=1)).max())
    log(f"1024^2 T=1e9: max |m| {m_hot:.6f}")
    if m_hot >= 0.01 or np.all(s == s[:, :1]):
        raise AssertionError("infinite-temperature lattice is not disordered")

    T = 2.0
    onsager = (1.0 - np.sinh(2.0 / T) ** -4) ** 0.125
    s = IsingGrid((512, 512), periodic=True, seed=3, device=dev,
                  config=IsingConfig(n_burnin=200, n_sweeps=5)).sample(
        n_samples=40, initial_state=np.ones(512 * 512), temperature=T)
    m = float(np.abs(s.mean(axis=1)).mean())
    log(f"512^2 T=2.0 ordered start: <|m|> {m:.5f} (Onsager {onsager:.5f})")
    if abs(m - onsager) > 0.01:
        raise AssertionError("512^2 magnetization differs from Onsager's by more than 0.01")


def phase_main_path(dev):
    cfg = IsingConfig()
    n_samples = 4
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = IsingGrid(MAIN_SHAPE, periodic=True, seed=0, device=dev)
    states = grid.sample(n_samples=n_samples, temperature=2.269)
    wall = time.perf_counter() - t0
    got = counts()
    launches = got[0]
    sweeps = cfg.n_burnin + n_samples * cfg.n_sweeps
    n = MAIN_SHAPE[0] * MAIN_SHAPE[1]
    log(f"main path: IsingGrid({MAIN_SHAPE}).sample(4) {wall:.3f} s wall, "
        f"{launches} launches for {sweeps} sweeps, "
        f"{sweeps * n / wall:.4e} flips/s end to end (init and copy-out included)")
    if got != expect(sweeps):
        raise AssertionError(f"expected {sweeps} kernel launches and 0 of the others, counted "
                             f"{got}")
    if states.shape != (n_samples, n) or not np.all(np.abs(states) == 1.0):
        raise AssertionError(f"bad states: shape {states.shape}")
    e = grid.energies(states) / n
    m = states.mean(axis=1)
    log(f"main path: e/site {e.tolist()}, m {m.tolist()}")
    if not (np.all(np.isfinite(e)) and np.all((e > -2.0) & (e < -1.0))):
        raise AssertionError("energy per site outside (-2, -1) after 140 sweeps at T_c")

    small = dict(periodic=True, seed=5, config=IsingConfig(n_burnin=20, n_sweeps=2))
    a = IsingGrid((64, 48), device=dev, **small).sample(3, temperature=2.269)
    b = IsingGrid((64, 48), device="cpu", **small).sample(3, temperature=2.269)
    if not np.array_equal(a, b):
        raise AssertionError("IsingGrid on cuda and on cpu differ for one seed")
    log("main path: 64x48 samples on cuda equal those on cpu bit for bit")
    return launches


def compare_batched(blacks, temps, periodic, seeds, sweeps, uniforms=None) -> float:
    """Run the batched kernel and its plain version sweep by sweep from one
    input; raise unless every plane agrees bit for bit. Returns the max abs
    difference.

    Sweep k of lattice b runs at temps[b], or temps[k, b] for a 2-D temps,
    under the key (fold_seed(seeds[b]), sweeps[k, b]); ``sweeps`` is (n, 1)
    or (n, B)."""
    tables = sigmoid_table16(1.0, 0.1, torch.as_tensor(temps, dtype=torch.float32))
    tables = tables.to(blacks.device)
    keys = sweep_keys(np.asarray(seeds)[None, :], sweeps).to(blacks.device)
    b_k = b_p = blacks
    err = 0.0
    for k in range(len(keys)):
        u = None if uniforms is None else uniforms[k]
        t = tables if tables.dim() == 2 else tables[k]
        r_k, b_k = fused_sweep_batched(b_k, t, keys[k], periodic=periodic, uniforms=u)
        r_p, b_p = fused_sweep_batched_reference(b_p, t, keys[k], periodic=periodic,
                                                 uniforms=u)
        for a, b in ((r_k, r_p), (b_k, b_p)):
            err = max(err, float((a.float() - b.float()).abs().max()))
            if not torch.equal(a, b):
                raise AssertionError(
                    f"batched kernel != plain at sweep {k}: {int((a != b).sum())} sites "
                    f"differ (shape {tuple(blacks.shape)}, {blacks.dtype}, "
                    f"periodic={periodic}, injected={uniforms is not None})")
    torch.cuda.synchronize()
    return err


def phase_batched_exact(dev, gen, cgen) -> float:
    # Each shape a batched path launches at, with its tables: the phase scan's
    # 16 temperatures; the anneal's schedule, a different row per lattice and
    # sweep, keyed by the global sweep counter; the tempering ladder. Then an
    # open f32 batch with a ragged last tile.
    at = np.array([[0, 999], [500, 830], [830, 500]])    # sweeps of a 1000-step anneal
    cases = [
        (ENSEMBLE, torch.bfloat16, True, SCAN_TEMPS, np.arange(3)[:, None]),
        ((2, *MAIN_SHAPE), torch.bfloat16, True, make_schedule(5.0, 0.05, 1000)[at], at),
        ((PT_RUNGS, *PT_SHAPE), torch.bfloat16, True, np.geomspace(1.8, 3.0, PT_RUNGS),
         np.arange(3)[:, None]),
        ((3, 1002, 1000), torch.float32, False, SCHEDULE, np.arange(3)[:, None]),
        ((2, *RAGGED_SHAPE), torch.bfloat16, False, SCHEDULE[:2], np.arange(3)[:, None]),
        ((2, *RAGGED_SHAPE), torch.bfloat16, True, SCHEDULE[:2], np.arange(3)[:, None]),
    ]
    err = 0.0
    for shape, dtype, periodic, temps, sweeps in cases:
        B, R, C = shape
        blacks = random_black(gen, shape, dtype, dev)
        U = torch.randint(0, 1 << 16, (3, B, 2, R, C // 2), generator=cgen, device=dev,
                          dtype=torch.int32)
        err = max(err, compare_batched(blacks, temps, periodic, np.arange(B), sweeps, U))
        del U
        log(f"phase 7: injected uniforms, {shape} {dtype} periodic={periodic}: "
            "kernel == plain over 3 sweeps")
        if periodic:
            seeds = torch.randint(0, 2**30, (B,), generator=gen).numpy()
            temps2 = temps[:2] if np.ndim(temps) == 2 else temps
            err = max(err, compare_batched(blacks, temps2, periodic, seeds, sweeps[:2]))
            log(f"phase 7: Philox mode, {shape} {dtype}: kernel == plain over 2 sweeps")

    B = ENSEMBLE[0]
    blacks = random_black(gen, ENSEMBLE, torch.bfloat16, dev)
    seeds = 1000 + 7 * np.arange(B)
    sweep = 3
    tables = sigmoid_table16(1.0, 0.0, torch.as_tensor(SCAN_TEMPS, dtype=torch.float32)).to(dev)
    keys = sweep_keys(seeds, sweep).to(dev)
    reds, news = fused_sweep_batched(blacks, tables, keys, periodic=True)
    for b in range(B):
        r1, b1 = fused_sweep(blacks[b], tables[b], seed=int(seeds[b]), sweep=sweep,
                             periodic=True)
        if not (torch.equal(r1, reds[b]) and torch.equal(b1, news[b])):
            raise AssertionError(f"batched kernel element {b} != single-lattice kernel")
        err = max(err, float((r1.float() - reds[b].float()).abs().max()),
                  float((b1.float() - news[b].float()).abs().max()))
    torch.cuda.synchronize()
    log(f"phase 7: each of the {B} elements of one batched launch == the "
        "single-lattice kernel under its seed")
    return err


def phase_batched_statistics(dev):
    T = 2.5
    gen = torch.Generator().manual_seed(21)
    out = sample_grid_ensemble(gen, torch.ones((8, 4, 4), device=dev), T,
                               n_samples=4000, n_burnin=100)
    m, se_m = batch_means(out["magnetization"].abs().mean(1).cpu().numpy())
    e, se_e = batch_means(out["energy"].mean(1).cpu().numpy() / 16)
    m_x, e_x = exact_4x4(T)
    log(f"ensemble 8 x 4x4 T=2.5: <|m|> {m:.5f} +- {se_m:.5f} (exact {m_x:.5f}); "
        f"<e> {e:.5f} +- {se_e:.5f} (exact {e_x:.5f})")
    if abs(m - m_x) > 4 * se_m or abs(e - e_x) > 4 * se_e:
        raise AssertionError("ensemble moments differ from exact enumeration by more than 4 SE")

    out = sample_grid_ensemble(gen, torch.ones((2, 8, 8), device=dev), [2.8, 2.8],
                               n_samples=40, n_burnin=30)
    m = out["magnetization"].cpu().numpy()
    if np.allclose(m[:, 0], m[:, 1]):
        raise AssertionError("ensemble members at one temperature gave the same trace")
    log("ensemble: two members at T=2.8 give different traces")

    T = 2.0
    cold, info = parallel_tempering_lattice(gen, (4, 4), temperatures=np.linspace(2.0, 3.0, 4),
                                            n_samples=5000, swap_interval=1, n_burnin=100,
                                            device=dev)
    m, se_m = batch_means(cold.double().mean((1, 2)).abs().cpu().numpy())
    e, se_e = batch_means(lattice_energy_batch(cold).cpu().numpy() / 16)
    m_x, e_x = exact_4x4(T)
    log(f"tempering 4 rungs 4x4, cold rung T=2.0: <|m|> {m:.5f} +- {se_m:.5f} "
        f"(exact {m_x:.5f}); <e> {e:.5f} +- {se_e:.5f} (exact {e_x:.5f}); swap "
        f"acceptance {info['swap_acceptance_rate']:.4f}")
    if abs(m - m_x) > 4 * se_m or abs(e - e_x) > 4 * se_e:
        raise AssertionError("cold rung differs from exact enumeration by more than 4 SE")

    _, e = IsingGrid((16, 16), periodic=True, seed=8, device=dev).find_ground_state(2000)
    log(f"16x16 anneal: best E {e}")
    if e != -512.0:
        raise AssertionError(f"16x16 anneal reached E = {e}, not the ground state -512")


def run_path(what, fn, want):
    """Run one path from zeroed counts; raise unless the launches of
    (K1, K2, K4, K5, K6, K7, K8, K3) are ``want`` (a function of the output,
    or a tuple of the leading counts, the rest zero). Returns (output,
    counts)."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    want = expect(*(want(out) if callable(want) else want))
    log(f"path {what}: {wall:.3f} s wall, launches " +
        ", ".join(f"{k} {n}" for k, n in zip(NAMES, got)))
    if got != want:
        raise AssertionError(f"{what}: expected launches {want}, counted {got}")
    return out, got


def same_on_cpu(what, fn, dev):
    a, b = fn(dev), fn(torch.device("cpu"))
    for x, y in zip(a, b):
        if not np.array_equal(np.asarray(x), np.asarray(y)):
            raise AssertionError(f"{what} at 16x16 differs between cuda and cpu for one seed")
    log(f"path {what}: 16x16 output on cuda equals that on cpu")


def phase_batched_paths(dev) -> int:
    size = ENSEMBLE[1]
    res, n_scan = run_path(f"phase scan {ENSEMBLE[0]} x {size}^2", lambda: (
        demonstrate_phase_transition(sizes=[size], temperatures=SCAN_TEMPS, n_samples=64,
                                     seed=0, device=dev)[size]), (0, 200 + 64 * 2, 0, 0))
    T_c = 2.0 / np.log(1.0 + np.sqrt(2.0))
    M = res["magnetization"]
    log(f"phase scan: T {np.round(SCAN_TEMPS, 4).tolist()}")
    log(f"phase scan: |M| {M.tolist()}")
    for T, m in zip(SCAN_TEMPS, M):
        onsager = (1.0 - np.sinh(2.0 / T) ** -4) ** 0.125 if T < T_c else 0.0
        if (T <= 2.0 and abs(m - onsager) > 0.01) or (T >= 3.0 and m >= 0.05):
            raise AssertionError(f"phase scan |M| {m} at T={T} (Onsager {onsager})")

    grid = IsingGrid(MAIN_SHAPE, periodic=True, seed=0, device=dev)
    (state, e), n_anneal = run_path(f"ground state 2 x {MAIN_SHAPE}, 1000 steps",
                                    lambda: grid.find_ground_state(n_steps=1000),
                                    (0, 1000, 0, 0))
    n = MAIN_SHAPE[0] * MAIN_SHAPE[1]
    log(f"anneal: best e/site {e / n}")
    if not e / n < -1.85 or grid.energy(state) != e or state.shape != (n,):
        raise AssertionError(f"anneal: e/site {e / n}, energy of the returned state "
                             f"{grid.energy(state)}, shape {state.shape}")

    R = PT_RUNGS
    (cold, info), n_pt = run_path(f"tempering {R} x {PT_SHAPE}, 300 rounds", lambda: (
        parallel_tempering_lattice(torch.Generator().manual_seed(0), PT_SHAPE,
                                   temperatures=np.geomspace(1.8, 3.0, R), n_samples=200,
                                   swap_interval=10, n_burnin=100, device=dev)), (0, 300, 0, 0))
    rung_e = info["energies"][100:].mean(0)
    log(f"tempering: {info['swap_accepts']} of {info['swap_attempts']} swaps accepted; "
        f"mean E of the 8 coldest rungs {rung_e[:8].mean()}, of the 8 hottest {rung_e[-8:].mean()}")
    shapes = {"cold": tuple(cold.shape), "energies": info["energies"].shape,
              "final_states": info["final_states"].shape,
              "pair_acceptance": info["pair_acceptance"].shape,
              "pair_attempts": info["pair_attempts"].shape}
    if shapes != {"cold": (200, *PT_SHAPE), "energies": (300, R),
                  "final_states": (R, *PT_SHAPE), "pair_acceptance": (R - 1,),
                  "pair_attempts": (R - 1,)}:
        raise AssertionError(f"tempering: shapes {shapes}")
    if info["swap_accepts"] <= 0 or not rung_e[:8].mean() < rung_e[-8:].mean():
        raise AssertionError("tempering: no swap accepted, or cold rungs not below hot ones")

    same_on_cpu("phase scan", lambda d: list(demonstrate_phase_transition(
        sizes=[16], temperatures=[1.5, 2.5, 3.5], n_samples=4, seed=3, device=d)[16].values()),
        dev)
    same_on_cpu("ground state", lambda d: IsingGrid(
        (16, 16), periodic=True, seed=4, device=d).find_ground_state(50), dev)

    def pt_small(d):
        cold, info = parallel_tempering_lattice(5, (16, 16), temperatures=[2.0, 2.3, 2.6],
                                                n_samples=10, swap_interval=2, n_burnin=5,
                                                device=d)
        return [cold.cpu(), info["energies"], info["final_states"], info["pair_attempts"],
                info["pair_acceptance"]]
    same_on_cpu("tempering", pt_small, dev)
    return n_scan[1] + n_anneal[1] + n_pt[1]


def phase_timing_batched(dev, name):
    gen = torch.Generator().manual_seed(9)
    blacks = random_black(gen, ENSEMBLE, torch.bfloat16, dev)
    tables = sigmoid_table16(1.0, 0.0, torch.as_tensor(SCAN_TEMPS, dtype=torch.float32)).to(dev)
    keys = sweep_keys(np.arange(ENSEMBLE[0])[None, :], np.arange(1000)[:, None]).to(dev)

    def run(sweep):
        def go(n):
            b = blacks
            for k in range(n):
                _, b = sweep(b, tables, keys[k], periodic=True)
        return go

    kernel, plain = run(fused_sweep_batched), run(fused_sweep_batched_reference)
    kernel(10)
    plain(2)
    ms = time_sweeps(kernel, 1000)
    g_ms = graph_ms(kernel, 1000)
    plain_ms = time_sweeps(plain, 20)
    n = ENSEMBLE[0] * ENSEMBLE[1] * ENSEMBLE[2]
    log(f"timing {ENSEMBLE} bf16 periodic on {name}: batched kernel {ms:.6f} ms/sweep "
        f"({n / ms * 1e3:.4e} flips/s, 1000 sweeps), {g_ms:.6f} ms/sweep ({n / g_ms * 1e3:.4e} "
        f"flips/s, a CUDA graph of 1000), plain {plain_ms:.6f} ms/sweep "
        f"({n / plain_ms * 1e3:.4e} flips/s, 20 sweeps)")
    return ms, g_ms, plain_ms


def phase_timing(dev, name):
    gen = torch.Generator().manual_seed(6)
    black = random_black(gen, MAIN_SHAPE, torch.bfloat16, dev)
    red = torch.empty_like(black)
    table = sigmoid_table16(1.0, 0.0, 2.269).to(dev)

    def kernel(n):
        fused_sweeps(7, red, black, 2.269, n, periodic=True)

    def plain(n):
        b = black
        for k in range(n):
            _, b = fused_sweep_reference(b, table, seed=7, sweep=k, periodic=True)

    def chained(n):                     # no host copy: a CUDA graph can capture it
        b = black
        for k in range(n):
            _, b = fused_sweep(b, table, seed=7, sweep=k, periodic=True)

    kernel(10)
    plain(2)
    ms = time_sweeps(kernel, 1000)
    g_ms = graph_ms(chained, 1000)
    plain_ms = time_sweeps(plain, 20)
    n = MAIN_SHAPE[0] * MAIN_SHAPE[1]
    log(f"timing 4096^2 bf16 periodic on {name}: kernel {ms:.6f} ms/sweep "
        f"({n / ms * 1e3:.4e} flips/s, 1000 sweeps of fused_sweeps), {g_ms:.6f} ms/sweep "
        f"({n / g_ms * 1e3:.4e} flips/s, a CUDA graph of 1000), plain {plain_ms:.6f} ms/sweep "
        f"({n / plain_ms * 1e3:.4e} flips/s, 20 sweeps)")
    return ms, g_ms, plain_ms


def pm1_bonds(gen: torch.Generator, shape):
    """+-J bond planes (Jh, Jv), float32 CPU tensors."""
    return tuple(torch.where(torch.rand(shape, generator=gen) < 0.5, 1.0, -1.0) for _ in range(2))


def gauss_bonds(gen: torch.Generator, shape):
    return tuple(torch.randn(shape, generator=gen) for _ in range(2))


def compare_bond_halves(other, weights, steps, periodic, uniforms=None):
    """K4 and its plain version half-sweep by half-sweep from one shared
    input; each step is (colour, key, mode) and starts from the kernel's
    last output. Discrete steps must agree bit for bit; continuous ones
    everywhere outside CONTINUOUS_BAND. Returns (max abs difference outside
    the band, sites in the band, of them the sites that differ)."""
    err, n_band, n_differ = 0.0, 0, 0
    for i, (color, key, mode) in enumerate(steps):
        u = None if uniforms is None else uniforms[i]
        w = weights["red" if color == 0 else "black"]
        kw = dict(update_red=color == 0, key=key, periodic=periodic, uniforms=u, **mode)
        got = bond_halfsweep(other, w, **kw)
        want = bond_halfsweep_reference(other, w, **kw)
        outside = torch.ones_like(got, dtype=torch.bool)
        if "temperature" in mode:
            band = continuous_band(other, w, update_red=color == 0, key=key, periodic=periodic,
                                   uniforms=u, temperature=mode["temperature"])
            n_band += int(band.sum())
            n_differ += int(((got != want) & band).sum())
            outside = ~band
        e = float(((got.float() - want.float()).abs() * outside).max())
        if e:
            raise AssertionError(
                f"K4 != plain at half-sweep {i}: {int(((got != want) & outside).sum())} sites "
                f"differ outside the band (shape {tuple(other.shape)}, {other.dtype}, "
                f"periodic={periodic}, mode {list(mode)}, injected={uniforms is not None})")
        err = max(err, e)
        other = got
    torch.cuda.synchronize()
    return err, n_band, n_differ


def compare_bond_batched(others, weights, keys, modes, periodic, uniforms=None) -> float:
    """K5 and its plain version over len(keys) discrete sweeps from one input,
    half-sweep by half-sweep; raise unless equal bit for bit. Returns the
    max abs difference."""
    err = 0.0
    for k in range(keys.shape[0]):
        for c, color in enumerate(("red", "black")):
            u = None if uniforms is None else uniforms[k, c]
            kw = dict(update_red=c == 0, periodic=periodic, uniforms=u, **modes)
            got = bond_halfsweep_batched(others, weights[color], keys[k, c], **kw)
            want = bond_halfsweep_batched_reference(others, weights[color], keys[k, c], **kw)
            err = max(err, float((got.float() - want.float()).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(
                    f"K5 != plain at sweep {k} {color}: {int((got != want).sum())} sites differ "
                    f"(shape {tuple(others.shape)}, injected={uniforms is not None})")
            others = got
    torch.cuda.synchronize()
    return err


def phase_bond_exact(dev, gen, cgen):
    """Phase 11; returns (K4 max abs err, K4 band sites, K4 band sites that
    differ, K5 max abs err)."""
    R, C = MAIN_SHAPE
    Jh, Jv = pm1_bonds(gen, MAIN_SHAPE)
    codes = pack_bond_codes(color_bond_weights(Jh.to(dev), Jv.to(dev), 0.0, True))
    at = [0, 1500, 2999]                                     # rows of a 3000-step anneal
    tables = sigmoid_table(1.0, 0.0, torch.from_numpy(make_schedule(5.0, 0.05, 3000)[at])).to(dev)
    steps = [(c, bond_key(77, c, k), {"table": tables[k]}) for k in range(3) for c in (0, 1)]
    black = random_black(gen, MAIN_SHAPE, torch.bfloat16, dev)
    U = torch.randint(0, 1 << 24, (6, R, C // 2), generator=cgen, device=dev, dtype=torch.int32)
    err4, _, _ = compare_bond_halves(black, codes, steps, True, U)
    del U
    err4 = max(err4, compare_bond_halves(black, codes, steps[:4], True)[0])
    log(f"phase 11: K4 discrete packed pure {MAIN_SHAPE} bf16 on anneal schedule rows: "
        "kernel == plain, injected over 3 sweeps and Philox over 2")

    Jh, Jv = gauss_bonds(gen, MAIN_SHAPE)
    field = 0.3 * torch.randn(MAIN_SHAPE, generator=gen)
    weights = color_bond_weights(Jh.to(dev), Jv.to(dev), field.to(dev), True)
    steps = [(c, bond_key(78, c, k), {"temperature": 1.5}) for k in range(2) for c in (0, 1)]
    e, n_band, n_differ = compare_bond_halves(random_black(gen, MAIN_SHAPE, torch.float32, dev),
                                              weights, steps, True)
    err4 = max(err4, e)
    log(f"phase 11: K4 continuous {MAIN_SHAPE} f32, Gaussian bonds and field, T=1.5, 4 "
        f"half-sweeps: equal outside the band |u - p| <= {CONTINUOUS_BAND}; {n_band} of "
        f"{4 * R * C // 2} site updates in the band, {n_differ} of them differ")

    # C/2 = 2047: the kernel's site-by-site path, a ragged last group and a
    # warp past the plane's edge.
    R, C = RAGGED_SHAPE
    Jh, Jv = pm1_bonds(gen, RAGGED_SHAPE)
    codes = pack_bond_codes(color_bond_weights(Jh.to(dev), Jv.to(dev), 0.0, True))
    steps = [(c, bond_key(80, c, k), {"table": tables[k]}) for k in range(2) for c in (0, 1)]
    black = random_black(gen, RAGGED_SHAPE, torch.bfloat16, dev)
    U = torch.randint(0, 1 << 24, (4, R, C // 2), generator=cgen, device=dev, dtype=torch.int32)
    for u in (U, None):
        err4 = max(err4, compare_bond_halves(black, codes, steps, True, u)[0])
    Jh, Jv = gauss_bonds(gen, RAGGED_SHAPE)
    field = 0.3 * torch.randn(RAGGED_SHAPE, generator=gen)
    weights = color_bond_weights(Jh.to(dev), Jv.to(dev), field.to(dev), False)
    steps = [(c, bond_key(81, c, k), {"temperature": 1.5}) for k in range(2) for c in (0, 1)]
    black = random_black(gen, RAGGED_SHAPE, torch.float32, dev)
    for u in (U, None):
        e, b, d = compare_bond_halves(black, weights, steps, False, u)
        err4, n_band, n_differ = max(err4, e), n_band + b, n_differ + d
    del U
    log(f"phase 11: K4 at {RAGGED_SHAPE} (C/2 = {C // 2}): discrete bf16 periodic == plain and "
        "continuous f32 open == plain outside the band, over 2 sweeps, injected and Philox")

    R, C = 1002, 1000
    for mode in ("codes", "continuous"):
        if mode == "codes":
            Jh, Jv = pm1_bonds(gen, (R, C))
            Jh = torch.where(torch.rand((R, C), generator=gen) < 0.3, 0.0, Jh)
            w = pack_bond_codes(color_bond_weights(Jh.to(dev), Jv.to(dev), 0.0, False))
            modes = [{"table": sigmoid_table(1.0, 0.0, T).to(dev)} for T in (0.7, 2.5)]
        else:
            Jh, Jv = gauss_bonds(gen, (R, C))
            w = color_bond_weights(Jh.to(dev), Jv.to(dev), 0.0, False)
            modes = [{"temperature": T} for T in (0.7, 2.5)]
        steps = [(c, bond_key(79, c, k), modes[k]) for k in range(2) for c in (0, 1)]
        black = random_black(gen, (R, C), torch.float32, dev)
        U = torch.randint(0, 1 << 24, (4, R, C // 2), generator=cgen, device=dev,
                          dtype=torch.int32)
        for u in (U, None):
            e, b, d = compare_bond_halves(black, w, steps, False, u)
            err4, n_band, n_differ = max(err4, e), n_band + b, n_differ + d
        log(f"phase 11: K4 {mode} (1002, 1000) f32 open: kernel == plain over 2 sweeps, "
            "injected and Philox")

    err5 = 0.0
    Jh, Jv = pm1_bonds(gen, PT_SHAPE)
    codes = pack_bond_codes(color_bond_weights(Jh.to(dev), Jv.to(dev), 0.0, True))
    ladder = np.geomspace(0.3, 2.0, LADDER_BATCH // 2)
    for B, temps in ((LADDER_BATCH, np.tile(ladder, 2)), (PT_RUNGS, np.geomspace(1.2, 2.0, PT_RUNGS))):
        blacks = random_black(gen, (B, *PT_SHAPE), torch.bfloat16, dev)
        modes = {"tables": sigmoid_table(1.0, 0.0, torch.tensor(temps, dtype=torch.float32)).to(dev)}
        keys = bond_sweep_keys(torch.randint(0, 2**30, (B,), generator=gen).numpy(), 2).to(dev)
        U = torch.randint(0, 1 << 24, (2, 2, B, *PT_SHAPE[:1], PT_SHAPE[1] // 2), generator=cgen,
                          device=dev, dtype=torch.int32)
        err5 = max(err5, compare_bond_batched(blacks, codes, keys, modes, True, U),
                   compare_bond_batched(blacks, codes, keys, modes, True))
        log(f"phase 11: K5 discrete ({B}, {PT_SHAPE[0]}, {PT_SHAPE[1]}) bf16: kernel == plain "
            "over 2 sweeps, injected and Philox")

    outs = bond_halfsweep_batched(blacks, codes["red"], keys[1, 0], update_red=True, **modes)
    for b in range(PT_RUNGS):
        one = bond_halfsweep(blacks[b], codes["red"], update_red=True,
                             key=tuple(int(x) & 0xFFFFFFFF for x in keys[1, 0, b]),
                             table=modes["tables"][b])
        if not torch.equal(one, outs[b]):
            raise AssertionError(f"K5 element {b} != K4 under its key")
    torch.cuda.synchronize()
    log(f"phase 11: each of the {PT_RUNGS} elements of one K5 launch == K4 under its key")
    return err4, n_band, n_differ, err5


def exact_bonds_4x4(Jh, Jv, T: float):
    """<e> per site and <m^2> of a periodic 4x4 bond instance, by enumerating
    all 2^16 states."""
    bits = (np.arange(2**16)[:, None] >> np.arange(16)) & 1
    s = (2 * bits - 1).reshape(-1, 4, 4).astype(np.float64)
    E = -(Jh * s * np.roll(s, -1, 2)).sum((1, 2)) - (Jv * s * np.roll(s, -1, 1)).sum((1, 2))
    w = np.exp(-(E - E.min()) / T)
    w /= w.sum()
    return float(w @ E) / 16, float(w @ s.mean((1, 2)) ** 2)


def check_moments(what, e, m2, exact):
    (e, se_e), (m2, se_m2) = batch_means(e), batch_means(m2)
    log(f"{what}: <e> {e:.5f} +- {se_e:.5f} (exact {exact[0]:.5f}); <m^2> {m2:.5f} +- "
        f"{se_m2:.5f} (exact {exact[1]:.5f})")
    if abs(e - exact[0]) > 4 * se_e or abs(m2 - exact[1]) > 4 * se_m2:
        raise AssertionError(f"{what}: moments differ from exact enumeration by more than 4 SE")


def phase_bond_statistics(dev):
    gen = torch.Generator().manual_seed(31)
    Jh, Jv = (x.numpy() for x in pm1_bonds(gen, (4, 4)))
    T = 1.5
    exact = exact_bonds_4x4(Jh, Jv, T)
    grid = IsingGrid((4, 4), periodic=True, seed=1, device=dev, bonds=(Jh, Jv),
                     config=IsingConfig(n_burnin=100, n_sweeps=1))
    s = grid.sample(n_samples=10000, temperature=T)
    check_moments(f"4x4 +-J T={T}, IsingGrid(bonds).sample (continuous)",
                  grid.energies(s) / 16, s.mean(axis=1).astype(np.float64) ** 2, exact)
    cold, info = parallel_tempering_bonds(gen, Jh, Jv, temperatures=np.linspace(T, 2.5, 4),
                                          n_samples=5000, swap_interval=1, n_burnin=100,
                                          device=dev)
    if not info["discrete_table_path"]:
        raise AssertionError("+-J tempering did not take the discrete mode")
    check_moments(f"4x4 +-J, cold rung of 4-rung parallel_tempering_bonds (discrete), swap "
                  f"acceptance {info['swap_acceptance_rate']:.4f}",
                  grid.energies(cold.cpu().numpy()) / 16,
                  cold.double().mean((1, 2)).cpu().numpy() ** 2, exact)

    # A ferromagnet in a random gauge tau: J_ij = tau_i tau_j, started at
    # s = tau. |sum tau_i s_i| / N is then the ferromagnet's |m|.
    T, L = 2.0, 512
    onsager = (1.0 - np.sinh(2.0 / T) ** -4) ** 0.125
    tau = torch.where(torch.rand((L, L), generator=gen) < 0.5, 1.0, -1.0)
    Jh, Jv = tau * torch.roll(tau, -1, 1), tau * torch.roll(tau, -1, 0)
    s = IsingGrid((L, L), periodic=True, seed=3, device=dev, bonds=(Jh.numpy(), Jv.numpy()),
                  config=IsingConfig(n_burnin=200, n_sweeps=5)).sample(
        n_samples=40, initial_state=tau.numpy().reshape(-1), temperature=T)
    m_cont = float(np.abs((s * tau.numpy().reshape(1, -1)).mean(axis=1)).mean())
    codes = pack_bond_codes(color_bond_weights(Jh.to(dev), Jv.to(dev)))
    red, black = split_checkerboard(tau.to(dev, torch.bfloat16))
    red, black = checkerboard_sweeps_bonds_kernel(1, red, black, codes, T, 200, discrete=True)
    ms = []
    for i in range(40):
        red, black = checkerboard_sweeps_bonds_kernel(2 + i, red, black, codes, T, 5,
                                                      discrete=True)
        ms.append(abs(float((merge_checkerboard(red, black).float() * tau.to(dev)).mean())))
    m_disc = float(np.mean(ms))
    log(f"gauge-transformed ferromagnet {L}^2 T={T}: <|m_gauge|> continuous {m_cont:.5f}, "
        f"discrete {m_disc:.5f} (Onsager {onsager:.5f})")
    if abs(m_cont - onsager) > 0.01 or abs(m_disc - onsager) > 0.01:
        raise AssertionError("gauge-transformed ferromagnet differs from Onsager's |m| by more "
                             "than 0.01")


def ladder_launches(n_iters: int, quench: int):
    """K5 launches of build_tempering_ladder (pilot 128 + 128 sweeps;
    feedback rounds of 32 + 128 iterations of 2 sweeps) and of
    pt_ground_state_search (n_iters sweeps and the quench), two half-sweeps
    a sweep."""
    def count(out):
        rounds = out[1]["feedback_rounds_run"]
        return (0, 0, 0, 2 * (256 + rounds * 160 * 2 + n_iters + quench))
    return count


def ladder_then_search(gen, Jh, Jv, dev, n_iters=500, quench=64, feedback_iters=128):
    temps, info = build_tempering_ladder(
        gen, Jh, Jv, T_min=0.3, T_max=2.0, target_acceptance=0.3, accept_floor=0.2,
        feedback_iters=feedback_iters, feedback_burnin=feedback_iters // 4, device=dev)
    out = pt_ground_state_search(gen, Jh, Jv, temperatures=temps, n_iters=n_iters, n_sweeps=1,
                                 n_copies=2, houdayer_every=10, quench_sweeps=quench, device=dev)
    return temps, info, out


def phase_bond_paths(dev):
    """Phase 13; returns the K4 and K5 launches of the paths."""
    gen = torch.Generator().manual_seed(41)
    n = MAIN_SHAPE[0] * MAIN_SHAPE[1]
    cfg = IsingConfig()
    grid = IsingGrid(MAIN_SHAPE, periodic=True, seed=0, device=dev,
                     bonds=tuple(x.numpy() for x in gauss_bonds(gen, MAIN_SHAPE)))
    want = 2 * (cfg.n_burnin + 4 * cfg.n_sweeps)
    obs, c1 = run_path(f"sample_observables(4), Gaussian bonds {MAIN_SHAPE}",
                       lambda: grid.sample_observables(n_samples=4, temperature=1.0),
                       (0, 0, want, 0))
    log(f"sample_observables: m {obs['magnetization'].tolist()}, e/site "
        f"{(obs['energy'] / n).tolist()}")
    if (obs["energy"].shape != (4,) or not np.all(np.isfinite(obs["energy"]))
            or not np.all(np.abs(obs["magnetization"]) < 0.05)
            or not np.all((obs["energy"] / n > -2.0) & (obs["energy"] / n < 0.0))):
        raise AssertionError("Gaussian spin glass observables out of range")

    grid = IsingGrid(MAIN_SHAPE, periodic=True, seed=0, device=dev,
                     bonds=tuple(x.numpy() for x in pm1_bonds(gen, MAIN_SHAPE)))
    (state, e), c2 = run_path(f"find_ground_state(3000), +-J {MAIN_SHAPE}",
                              lambda: grid.find_ground_state(n_steps=3000), (0, 0, 6000, 0))
    log(f"spin-glass anneal: best e/site {e / n} (literature ground state {EA_GS_DENSITY})")
    if (not EA_GS_DENSITY - 0.005 <= e / n <= -1.35 or grid.energy(state) != e
            or state.shape != (n,)):
        raise AssertionError(f"spin-glass anneal: e/site {e / n}, energy of the returned state "
                             f"{grid.energy(state)}, shape {state.shape}")

    Jh, Jv = (x.numpy() for x in pm1_bonds(gen, PT_SHAPE))
    (cold, info), c3 = run_path(
        f"parallel_tempering_bonds {PT_RUNGS} x {PT_SHAPE}, 300 rounds",
        lambda: parallel_tempering_bonds(torch.Generator().manual_seed(0), Jh, Jv,
                                         temperatures=np.geomspace(1.2, 2.0, PT_RUNGS),
                                         n_samples=200, swap_interval=10, n_burnin=100,
                                         device=dev), (0, 0, 0, 600))
    rung_e = info["energies"][100:].mean(0)
    log(f"bond tempering: {info['swap_accepts']} of {info['swap_attempts']} swaps accepted; "
        f"mean E of the 8 coldest rungs {rung_e[:8].mean()}, of the 8 hottest "
        f"{rung_e[-8:].mean()}")
    if (info["swap_accepts"] <= 0 or not rung_e[:8].mean() < rung_e[-8:].mean()
            or tuple(cold.shape) != (200, *PT_SHAPE) or not info["discrete_table_path"]):
        raise AssertionError("bond tempering: no swap accepted, cold rungs not below hot ones, "
                             "or a wrong shape or mode")

    (temps, linfo, out), c4 = run_path(
        f"build_tempering_ladder + pt_ground_state_search {PT_SHAPE}, 2 copies, 500 iterations",
        lambda: ladder_then_search(torch.Generator().manual_seed(1), Jh, Jv, dev),
        ladder_launches(500, 64))
    log(f"ladder: {linfo['n_rungs']} rungs, {linfo['feedback_rounds_run']} feedback rounds, "
        f"measured pair acceptance min {linfo['measured_pair_acceptance'].min():.3f}; search: "
        f"swap acceptance {out['swap_acceptance_rate']:.4f}, best e/site "
        f"{out['energy_per_site']} (literature {EA_GS_DENSITY})")
    if (not EA_GS_DENSITY - 0.005 <= out["energy_per_site"] <= -1.35
            or not 0.1 <= out["swap_acceptance_rate"] <= 0.6):
        raise AssertionError("ground-state search: e/site or swap acceptance out of range")

    small = np.random.default_rng(3)
    g16 = small.normal(size=(2, 16, 16)).astype(np.float32)
    p16 = small.choice([-1.0, 1.0], (2, 16, 16)).astype(np.float32)
    same_on_cpu("sample (Gaussian bonds)", lambda d: [IsingGrid(
        (16, 16), periodic=True, seed=6, device=d, bonds=g16,
        config=IsingConfig(n_burnin=10, n_sweeps=2)).sample(3, temperature=1.2)], dev)
    same_on_cpu("find_ground_state (+-J)", lambda d: IsingGrid(
        (16, 16), periodic=True, seed=7, device=d, bonds=p16).find_ground_state(60), dev)

    def pt_small(d):
        cold, info = parallel_tempering_bonds(8, *p16, temperatures=[0.8, 1.2, 1.8],
                                              n_samples=6, swap_interval=2, n_burnin=4, device=d)
        return [cold.cpu(), info["energies"], info["final_states"], info["pair_attempts"]]
    same_on_cpu("parallel_tempering_bonds", pt_small, dev)

    def search_small(d):
        temps, info, out = ladder_then_search(torch.Generator().manual_seed(9), *p16, d,
                                              n_iters=20, quench=4, feedback_iters=8)
        return [temps, out["best_state"], out["best_energy"], out["pair_attempts"]]
    same_on_cpu("build_tempering_ladder + pt_ground_state_search", search_small, dev)
    return c1[2] + c2[2], c3[3] + c4[3]


def chain_ms(halfsweep, other, weights, n, timer=time_sweeps, **mode):
    """ms per half-sweep of n chained half-sweeps (red, black, ...) under
    ``timer``."""
    def go(count):
        o = other
        for k in range(count):
            color = k % 2
            o = halfsweep(o, weights["red" if color == 0 else "black"], update_red=color == 0,
                          **{name: (f(k) if callable(f) else f) for name, f in mode.items()})
    go(4)
    return timer(go, n)


def timings(kernel, plain, other, weights, mode):
    """(kernel ms under a CUDA graph, kernel ms launched one by one, plain
    version ms) per half-sweep."""
    return (chain_ms(kernel, other, weights, 1000, graph_ms, **mode),
            chain_ms(kernel, other, weights, 1000, **mode),
            chain_ms(plain, other, weights, 20, **mode))


def phase_bond_timing(dev, name):
    gen = torch.Generator().manual_seed(51)
    sites = MAIN_SHAPE[0] * MAIN_SHAPE[1] // 2
    codes = pack_bond_codes(color_bond_weights(*(x.to(dev) for x in pm1_bonds(gen, MAIN_SHAPE))))
    table = sigmoid_table(1.0, 0.0, 1.0).to(dev)
    black = random_black(gen, MAIN_SHAPE, torch.bfloat16, dev)
    kw = dict(table=table, key=lambda k: (5, k))
    t = {"K4 discrete": timings(bond_halfsweep, bond_halfsweep_reference, black, codes, kw)}
    weights = color_bond_weights(*(x.to(dev) for x in gauss_bonds(gen, MAIN_SHAPE)),
                                 0.3 * torch.randn(MAIN_SHAPE, generator=gen).to(dev))
    black = random_black(gen, MAIN_SHAPE, torch.float32, dev)
    kw = dict(temperature=1.5, key=lambda k: (6, k))
    t["K4 continuous"] = timings(bond_halfsweep, bond_halfsweep_reference, black, weights, kw)
    codes = pack_bond_codes(color_bond_weights(*(x.to(dev) for x in pm1_bonds(gen, RAGGED_SHAPE))))
    black = random_black(gen, RAGGED_SHAPE, torch.bfloat16, dev)
    kw = dict(table=table, key=lambda k: (7, k))
    t["K4 discrete 4096x4094"] = timings(bond_halfsweep, bond_halfsweep_reference, black, codes, kw)
    codes = pack_bond_codes(color_bond_weights(*(x.to(dev) for x in pm1_bonds(gen, PT_SHAPE))))
    for what, B, temps in (
            ("K5 discrete", LADDER_BATCH, np.tile(np.geomspace(0.3, 2.0, LADDER_BATCH // 2), 2)),
            ("K5 discrete 64 x 256^2", PT_RUNGS, np.geomspace(1.2, 2.0, PT_RUNGS))):
        tables = sigmoid_table(1.0, 0.0, torch.tensor(temps, dtype=torch.float32)).to(dev)
        keys = bond_sweep_keys(np.arange(B), 500).to(dev).reshape(1000, B, 2)
        blacks = random_black(gen, (B, *PT_SHAPE), torch.bfloat16, dev)

        def batched(fn, keys=keys, tables=tables):
            return lambda o, w, update_red, k: fn(o, w, keys[k], update_red=update_red,
                                                  tables=tables)
        t[what] = timings(batched(bond_halfsweep_batched),
                          batched(bond_halfsweep_batched_reference), blacks, codes,
                          dict(k=lambda k: k))
    n_sites = {"K4 discrete": sites, "K4 continuous": sites,
               "K4 discrete 4096x4094": RAGGED_SHAPE[0] * RAGGED_SHAPE[1] // 2,
               "K5 discrete": LADDER_BATCH * PT_SHAPE[0] * PT_SHAPE[1] // 2,
               "K5 discrete 64 x 256^2": PT_RUNGS * PT_SHAPE[0] * PT_SHAPE[1] // 2}
    for what, (ms, eager_ms, plain_ms) in t.items():
        n = n_sites[what]
        log(f"timing {what} on {name}: kernel {ms:.6f} ms/half-sweep ({n / ms * 1e3:.4e} site "
            f"updates/s, a CUDA graph of 1000 half-sweeps; {eager_ms:.6f} ms launched one by "
            f"one), plain {plain_ms:.6f} ms/half-sweep ({n / plain_ms * 1e3:.4e}/s, 20 "
            "half-sweeps)")
    return t


def compare_resident(red, black, periodic, uniforms) -> tuple:
    """K6 at one table and K7 over a schedule, one launch each, against their
    plain versions from one input, on injected (S, 2, R, C2) uniforms; raise
    unless equal bit for bit. Returns the max abs difference of (K6, K7)."""
    S = uniforms.shape[0]
    table = sigmoid_table(1.0, 0.1, 2.3).to(black.device)
    tables = sigmoid_table(1.0, 0.1, torch.tensor(SCHEDULE[:S], dtype=torch.float32)).to(
        black.device)
    errs = []
    for what, kernel, plain, args in (
            ("K6", resident_sweeps_table, resident_sweeps_table_reference, (table, S)),
            ("K7", resident_anneal_tables, resident_anneal_tables_reference, (tables,))):
        got = kernel(0, red, black, *args, periodic=periodic, uniforms=uniforms)
        want = plain(0, red, black, *args, periodic=periodic, uniforms=uniforms)
        errs.append(max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want)))
        for a, b, colour in zip(got, want, ("red", "black")):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"{what} != plain, {colour}: {int((a != b).sum())} sites differ (shape "
                    f"{tuple(black.shape)}, {black.dtype}, periodic={periodic}, injected)")
    torch.cuda.synchronize()
    return tuple(errs)


def compare_resident_philox(red, black, periodic) -> tuple:
    """K6 and K7 over 2 sweeps in Philox mode against their plain versions;
    raise unless equal bit for bit. Returns the max abs difference of (K6,
    K7)."""
    table = sigmoid_table(1.0, 0.0, 2.269).to(black.device)
    tables = sigmoid_table(1.0, 0.0, torch.tensor([2.269, 1.5])).to(black.device)
    errs = []
    for what, got, want in (
            ("K6", resident_sweeps_table(13, red, black, table, 2, periodic=periodic),
             resident_sweeps_table_reference(13, red, black, table, 2, periodic=periodic)),
            ("K7", resident_anneal_tables(14, red, black, tables, periodic=periodic),
             resident_anneal_tables_reference(14, red, black, tables, periodic=periodic))):
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{what} != plain in Philox mode: {int((a != b).sum())} "
                                     f"sites differ (shape {tuple(black.shape)}, {black.dtype}, "
                                     f"periodic={periodic})")
        errs.append(max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want)))
    torch.cuda.synchronize()
    return tuple(errs)


def phase_resident_exact(dev, gen, cgen):
    """Phase 15; returns the max abs errors of K6, K7 and K8."""
    err6 = err7 = 0.0
    for shape, dtype, periodic in ((MAIN_SHAPE, torch.bfloat16, True),
                                   ((1002, 1000), torch.float32, False)):
        red = random_black(gen, shape, dtype, dev)
        black = random_black(gen, shape, dtype, dev)
        U = torch.randint(0, 1 << 24, (3, 2, shape[0], shape[1] // 2), generator=cgen,
                          device=dev, dtype=torch.int32)
        e6, e7 = compare_resident(red, black, periodic, U)
        del U
        err6, err7 = max(err6, e6), max(err7, e7)
        log(f"phase 15: injected uniforms, {shape} {dtype} periodic={periodic}: K6 and K7 == "
            "plain over 3 sweeps, one launch each")
    for shape in (MAIN_SHAPE, (8192, 8192)):
        e6, e7 = compare_resident_philox(*(random_black(gen, shape, torch.bfloat16, dev)
                                           for _ in range(2)), True)
        err6, err7 = max(err6, e6), max(err7, e7)
        log(f"phase 15: Philox mode, {shape} bf16: K6 and K7 == plain over 2 sweeps")
    # The tiles' edge cases: bands of one row that wrap onto themselves,
    # a ragged last word (C/2 = 125) on an open lattice, f32 at full size.
    for shape, dtype, periodic in RESIDENT_SHAPES:
        red, black = (random_black(gen, shape, dtype, dev) for _ in range(2))
        U = torch.randint(0, 1 << 24, (3, 2, shape[0], shape[1] // 2), generator=cgen,
                          device=dev, dtype=torch.int32)
        e6, e7 = compare_resident(red, black, periodic, U)
        del U
        f6, f7 = compare_resident_philox(red, black, periodic)
        err6, err7 = max(err6, e6, f6), max(err7, e7, f7)
        plan = resident_grid(shape[0], shape[1] // 2, dtype)
        log(f"phase 15: {shape} {dtype} periodic={periodic} ({plan.bands} bands x {plan.ranges} "
            f"ranges of at most {plan.rows} rows): K6 and K7 == plain, injected over 3 sweeps "
            "and Philox over 2")

    err8 = 0.0
    black = random_black(gen, MAIN_SHAPE, torch.bfloat16, dev)
    U = torch.randint(0, 1 << 16, (2, MAIN_SHAPE[0], MAIN_SHAPE[1] // 2), generator=cgen,
                      device=dev, dtype=torch.int32)
    for mode in MODES:
        for u in (U, None):
            got = decomposition_sweep(mode, black, seed=15, sweep=4, uniforms=u)
            want = decomposition_sweep_reference(mode, black, seed=15, sweep=4, uniforms=u)
            for a, b in zip(got, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"K8 {mode} != plain: {int((a != b).sum())} sites "
                                         f"differ (injected={u is not None})")
                err8 = max(err8, float((a.float() - b.float()).abs().max()))
    torch.cuda.synchronize()
    log(f"phase 15: K8 {', '.join(MODES)} at {MAIN_SHAPE} bf16 == plain, injected and Philox")
    return err6, err7, err8


def phase_resident_statistics(dev):
    T = 2.5
    red, black = (x.to(dev) for x in split_checkerboard(torch.ones((4, 4))))
    table = sigmoid_table(1.0, 0.0, T).to(dev)
    red, black = resident_sweeps_table(1, red, black, table, 100)
    ms, es = [], []
    for i in range(20000):
        red, black = resident_sweeps_table(2 + i, red, black, table, 1)
        ms.append(red.sum() + black.sum())
        es.append(plane_energy_batch(red, black))
    m, se_m = batch_means(torch.stack(ms).abs().cpu().numpy() / 16)
    e, se_e = batch_means(torch.stack(es).cpu().numpy() / 16)
    m_x, e_x = exact_4x4(T)
    log(f"4x4 T=2.5 through K6: <|m|> {m:.5f} +- {se_m:.5f} (exact {m_x:.5f}); "
        f"<e> {e:.5f} +- {se_e:.5f} (exact {e_x:.5f})")
    if abs(m - m_x) > 4 * se_m or abs(e - e_x) > 4 * se_e:
        raise AssertionError("K6 4x4 moments differ from exact enumeration by more than 4 SE")

    T, L = 2.0, 512
    onsager = (1.0 - np.sinh(2.0 / T) ** -4) ** 0.125
    red, black = (x.to(dev, torch.bfloat16) for x in split_checkerboard(torch.ones((L, L))))
    red, black = resident_sweeps(3, red, black, T, 200)
    m = []
    for i in range(40):
        red, black = resident_sweeps(4 + i, red, black, T, 5)
        m.append((red.float().sum() + black.float().sum()).abs() / (L * L))
    m = float(torch.stack(m).mean())
    log(f"512^2 T=2.0 ordered start through K6: <|m|> {m:.5f} (Onsager {onsager:.5f})")
    if abs(m - onsager) > 0.01:
        raise AssertionError("K6 512^2 magnetization differs from Onsager's by more than 0.01")

    gen = torch.Generator().manual_seed(5)
    red, black = (random_black(gen, (64, 64), torch.float32, dev) for _ in range(2))
    red, black = resident_anneal(5, red, black, np.geomspace(5.0, 0.05, 2000))
    e = float(plane_energy_batch(red, black)) / (64 * 64)
    log(f"64^2 anneal through K7, 2000 sweeps T 5 -> 0.05: e/site {e}")
    if not e < -1.85:
        raise AssertionError(f"K7 64^2 anneal reached e/site {e}, not below -1.85")

    rows = kernel_bench.steps("all", torch.bfloat16, RESIDENT_SWEEPS, dev)
    got = {name: kernel_bench.moments(rows[name][0], torch.bfloat16, dev)
           for name in ("fused", "resident")}
    for name, c in got.items():
        log(f"kernel_bench --check, {name} 128^2 T=2.5: <|m|> {c['abs_m']:.5f} +- "
            f"{c['se_abs_m']:.5f}, <e> {c['e']:.5f} +- {c['se_e']:.5f}")
    a, b = got["fused"], got["resident"]
    for key in ("abs_m", "e"):
        se = float(np.hypot(a["se_" + key], b["se_" + key]))
        if abs(a[key] - b[key]) > 5 * se:
            raise AssertionError(f"kernel_bench --check: resident {key} {b[key]} differs from "
                                 f"fused {a[key]} by more than 5 SE ({se})")


def phase_tools(dev):
    """Phase 17; returns (kernel_bench's rows, bench's JSON, the decomposition,
    the launches of K6, K7 and K8 on their paths)."""
    S = RESIDENT_SWEEPS
    kb, c = run_path(f"kernel_bench all {MAIN_SHAPE[0]}^2 bf16, {S} sweeps a call", lambda: (
        kernel_bench.run("all", MAIN_SHAPE[0], S, 3, "bf16", device=dev, log=log)),
        expect(4 * S, 0, 0, 0, 4))
    log(f"kernel_bench: one K6 launch per resident_sweeps call ({c[4]} launches, 4 calls)")
    log(json.dumps(kb))
    n6 = c[4]
    runs = BENCH["n_trials"] * (1 + BENCH["calls"])   # a warm-up call before each trial
    headline, c = run_path("bench (headline K1, EA K4)", lambda: bench.run(
        MAIN_SHAPE[0], device=dev, log=log, **BENCH),
        expect(runs * BENCH["sweeps"], 0, runs * 2 * BENCH["ea_sweeps"]))
    log(json.dumps(headline))
    if set(headline) != {"metric", "value", "unit", "vs_baseline", "ea_bond_flips_per_s"}:
        raise AssertionError(f"bench printed keys {sorted(headline)}")
    per_graph = S + 2                                  # graph_ms's warm-up and captured launches
    dec, c = run_path(f"kernel_decomposition {MAIN_SHAPE[0]}^2 bf16, {S} sweeps", lambda: (
        kernel_decomposition.run(MAIN_SHAPE[0], S, dev)),
        expect(per_graph, 0, 0, 0, 0, 0, len(MODES) * per_graph))
    log(json.dumps(dec))
    n8 = c[6]
    gen = torch.Generator().manual_seed(17)
    red, black = (random_black(gen, MAIN_SHAPE, torch.bfloat16, dev) for _ in range(2))
    schedule = make_schedule(5.0, 0.05, 1000)
    (red, black), c = run_path(f"resident_anneal {MAIN_SHAPE} bf16, 1000 sweeps T 5 -> 0.05",
                               lambda: resident_anneal(18, red, black, schedule),
                               expect(0, 0, 0, 0, 0, 1))
    n = MAIN_SHAPE[0] * MAIN_SHAPE[1]
    e = float(plane_energy_batch(red, black)) / n
    log(f"resident_anneal: one K7 launch per anneal ({c[5]}); e/site {e}")
    if not (np.isfinite(e) and e < -1.8):
        raise AssertionError(f"resident_anneal at {MAIN_SHAPE}: e/site {e}, not below -1.8")
    return kb, headline, dec, (n6, c[5], n8)


def phase_resident_timing(dev, name, k1_ms, k1_plain_ms, dec):
    """Phase 18; returns ms per sweep {K6, K7, their plain versions, the
    grid-stride body's K6 and K7, K6 on one row per block (the barriers),
    K8 plain per mode} and the grid."""
    S = RESIDENT_SWEEPS
    gen = torch.Generator().manual_seed(19)
    red, black = (random_black(gen, MAIN_SHAPE, torch.bfloat16, dev) for _ in range(2))
    table = sigmoid_table(1.0, 0.0, 2.269).to(dev)
    tables = sigmoid_table(1.0, 0.0, torch.from_numpy(make_schedule(5.0, 0.05, S))).to(dev)
    barrier = resident_bodies.barrier_shape(dev)
    small = tuple(random_black(gen, barrier, torch.bfloat16, dev) for _ in range(2))
    gridstride = resident_bodies.gridstride_library()

    def old(*args):
        return resident_bodies.gridstride_sweeps(gridstride, *args)

    resident_sweeps_table(1, red, black, table, 2)
    old(1, red, black, table, 2)
    resident_sweeps_table_reference(1, red, black, table, 1)   # the plain version's first call
    t = {}
    # The grid-stride body and this one in turns: old, new, new, old.
    for turn in ("old", "new", "new", "old"):
        if turn == "old":
            t.setdefault("K6 gridstride", []).append(time_sweeps(
                lambda n: old(2, red, black, table, n), S))
            t.setdefault("K7 gridstride", []).append(time_sweeps(
                lambda n: old(3, red, black, tables[:n], n), S))
        else:
            t.setdefault("K6 runs", []).append(time_sweeps(
                lambda n: resident_sweeps_table(2, red, black, table, n), S))
            t.setdefault("K7 runs", []).append(time_sweeps(
                lambda n: resident_anneal_tables(3, red, black, tables[:n]), S))
    t["K6"], t["K7"] = t["K6 runs"][0], t["K7 runs"][0]
    t["barrier"] = time_sweeps(lambda n: resident_sweeps_table(2, *small, table, n), S)
    t["K6 plain"] = time_sweeps(lambda n: resident_sweeps_table_reference(
        4, red, black, table, n), 4)
    t["K7 plain"] = time_sweeps(lambda n: resident_anneal_tables_reference(
        5, red, black, tables[:n]), 4)
    for mode in MODES:
        t[f"K8 {mode} plain"] = time_sweeps(lambda n: [decomposition_sweep_reference(
            mode, black, seed=6, sweep=k) for k in range(n)], 20)
    plan = resident_grid(MAIN_SHAPE[0], MAIN_SHAPE[1] // 2, torch.bfloat16)
    rows = [nr for _, nr, _, _ in tile_bounds(plan, MAIN_SHAPE[0], MAIN_SHAPE[1] // 2)]
    t["grid"] = {"blocks": plan.blocks, "bands": plan.bands, "ranges": plan.ranges,
                 "smem_bytes": plan.smem_bytes, "rows_per_band": [min(rows), max(rows)]}
    sites = MAIN_SHAPE[0] * MAIN_SHAPE[1]
    log(f"timing {MAIN_SHAPE} bf16 periodic on {name}: K6 {t['K6']:.6f} ms/sweep "
        f"({sites / t['K6'] * 1e3:.4e} flips/s, one launch of {S} sweeps), K7 {t['K7']:.6f} "
        f"ms/sweep ({S}-sweep schedule); K1 {k1_ms:.6f} ms/sweep (phase 6): K6 "
        f"{'below' if t['K6'] < k1_ms else 'NOT below'} K1; plain K6 {t['K6 plain']:.6f}, "
        f"K7 {t['K7 plain']:.6f}, K1 {k1_plain_ms:.6f} ms/sweep")
    log(f"timing K6/K7 in turns with the grid-stride body (old, new, new, old): K6 "
        f"{t['K6 runs']} vs {t['K6 gridstride']}, K7 {t['K7 runs']} vs {t['K7 gridstride']} "
        "ms/sweep")
    log(f"resident grid at {MAIN_SHAPE}: {plan.blocks} blocks ({plan.bands} bands x "
        f"{plan.ranges} ranges), {plan.smem_bytes} B of dynamic shared "
        f"memory a block, {min(rows)}-{max(rows)} rows a band; barriers and halo exchange: "
        f"{t['barrier']:.6f} ms/sweep (K6 at {barrier} bf16, one row a block)")
    for mode in MODES:
        log(f"timing K8 {mode} on {name}: {dec['ms_per_sweep'][mode]:.6f} ms/sweep (a CUDA graph "
            f"of {S}), plain {t[f'K8 {mode} plain']:.6f} ms/sweep; K1 in the same graph "
            f"timing {dec['ms_per_sweep']['baseline']:.6f}")
    return t


def compare_halfsweeps(other, steps, first, halos=None, uniforms=None, **where):
    """K3, its first body and its plain version half-sweep by half-sweep,
    each step (colour, key) starting from the kernel's last output; the halo
    rows are the plane's wrap rows (periodic), zeros (open) or ``halos``
    (up, down, left, right) of a shard, the columns handed to the first body
    contiguous. Raise unless K3 equals the first body (``first``, a build of
    checkerboard_halfsweep_scalar.cu) at every site and the plain version
    outside CONTINUOUS_BAND. Returns (max abs difference from the plain
    version outside the band, sites in the band, of them the sites that
    differ from the plain version)."""
    err, n_band, n_differ = 0.0, 0, 0
    for i, (color, key) in enumerate(steps):
        if halos is None:
            up, down = wrap_halos(other, where["periodic"])
            cols = first_cols = {}
        else:
            up, down, left, right = halos
            cols = dict(left_col=left, right_col=right)
            first_cols = {k: v.contiguous() for k, v in cols.items()}
        kw = dict(update_red=color == 0, key=key, uniforms=None if uniforms is None else uniforms[i],
                  temperature=2.269, J=1.0, field=0.1, **where)
        got = halfsweep(other, up, down, **kw, **cols)
        old = halfsweep_bodies.body_halfsweep(first, other, up, down, **kw, **first_cols)
        want = halfsweep_reference(other, up, down, **kw, **cols)
        band = halfsweep_band(other, up, down, **kw, **cols)
        if not torch.equal(got, old):
            raise AssertionError(
                f"K3 != its first body at half-sweep {i}: {int((got != old).sum())} sites differ "
                f"(shape {tuple(other.shape)}, {other.dtype}, {where}, "
                f"injected={uniforms is not None})")
        n_band += int(band.sum())
        n_differ += int(((got != want) & band).sum())
        e = float(((got.float() - want.float()).abs() * ~band).max())
        if e:
            raise AssertionError(
                f"K3 != plain at half-sweep {i}: {int(((got != want) & ~band).sum())} sites differ "
                f"outside the band (shape {tuple(other.shape)}, {other.dtype}, {where}, "
                f"injected={uniforms is not None})")
        err = max(err, e)
        other = got
    torch.cuda.synchronize()
    return err, n_band, n_differ


def shard_halos(gen, R, C2, dtype, dev, kind):
    """(up, down, left, right) halos of an (R, C2) shard: random +-1
    ("random"); the columns read in place from a neighbour plane, strided
    ("strided"); or, at the open top-left corner of a lattice, a zero up row
    and a zero left column ("zero")."""
    up, down = (random_black(gen, (2, 2 * C2), dtype, dev)[:1].contiguous() for _ in range(2))
    if kind == "strided":
        wide = random_black(gen, (R, 2 * C2 + 6), dtype, dev)
        return up, down, wide[:, -1:], wide[:, :1]
    left, right = (random_black(gen, (R, 2), dtype, dev) for _ in range(2))
    if kind == "zero":
        up, left = torch.zeros_like(up), torch.zeros_like(left)
    return up, down, left, right


def phase_halfsweep_exact(dev, gen, cgen):
    """Phase 19; returns (K3 max abs err, band sites, band sites that
    differ, K1 shard-mode max abs err)."""
    first = halfsweep_bodies.scalar_library()
    steps = [(c, bond_key(90 + k, c, k)) for k in range(2) for c in (0, 1)]
    err3 = n_band = n_differ = 0
    for shape, dtype, periodic in ((MAIN_SHAPE, torch.float32, True),
                                   (MAIN_SHAPE, torch.bfloat16, True),
                                   ((1002, 1000), torch.float32, False)):
        other = random_black(gen, shape, dtype, dev)
        U = torch.randint(0, 1 << 24, (4, shape[0], shape[1] // 2), generator=cgen, device=dev,
                          dtype=torch.int32)
        for u in (U, None):
            e, b, d = compare_halfsweeps(other, steps, first, uniforms=u, periodic=periodic)
            err3, n_band, n_differ = max(err3, e), n_band + b, n_differ + d
        del U
        log(f"phase 19: K3 {shape} {dtype} periodic={periodic}: kernel == its first body at every "
            "site and == plain outside the band over 2 sweeps, injected and Philox")
    R, C2 = MAIN_SHAPE[0] // 2, MAIN_SHAPE[1] // 4   # a shard of a 2 x 2 mesh: 2048x2048
    # The columns start inside a group of four (random halos), on one (the
    # strided columns of the 2 x 2 path), and the open top-left corner.
    for kind, row0, col0, periodic in (("random", R, C2 + 2, True), ("strided", R, C2, True),
                                       ("zero", 0, 0, False)):
        other = random_black(gen, (R, 2 * C2), torch.float32, dev)
        halos = shard_halos(gen, R, C2, torch.float32, dev, kind)
        U = torch.randint(0, 1 << 24, (4, R, C2), generator=cgen, device=dev, dtype=torch.int32)
        for u in (U, None):
            e, b, d = compare_halfsweeps(other, steps, first, halos, u, periodic=periodic,
                                         row0=row0, col0=col0)
            err3, n_band, n_differ = max(err3, e), n_band + b, n_differ + d
        del U
        log(f"phase 19: K3 shard ({R}, {C2}) f32 at rows {row0}.., compact columns {col0}.., "
            f"{kind} row and column halos: kernel == its first body at every site and == plain "
            "outside the band over 2 sweeps, injected and Philox")
    n_narrow = 0
    for R_, C2_ in ((r, c) for r in (2, 6, 10) for c in (1, 3, 4, 5, 33)):
        for dtype in (torch.bfloat16, torch.float32):
            for periodic in (True, False):
                for kind in (None, "zero" if not periodic else "strided"):
                    other = random_black(gen, (R_, 2 * C2_), dtype, dev)
                    halos = None if kind is None else shard_halos(gen, R_, C2_, dtype, dev, kind)
                    where = dict(periodic=periodic) if kind is None else dict(
                        periodic=periodic, row0=2 * C2_, col0=C2_ + 1)
                    U = torch.randint(0, 1 << 24, (2, R_, C2_), generator=cgen, device=dev,
                                      dtype=torch.int32)
                    for u in (U, None):
                        e, b, d = compare_halfsweeps(other, steps[:2], first, halos, u, **where)
                        err3, n_band, n_differ = max(err3, e), n_band + b, n_differ + d
                        n_narrow += 1
    log(f"phase 19: K3 at R in (2, 6, 10) x C/2 in (1, 3, 4, 5, 33), both dtypes, periodic and "
        f"open, with and without column halos ({n_narrow} cases of a sweep): kernel == its first "
        "body at every site and == plain outside the band")
    log(f"phase 19: K3 {n_band} site updates in the band |u - p| <= {CONTINUOUS_BAND}, "
        f"{n_differ} of them differ from the plain version, none from the first body")

    err1 = 0.0
    R, C2 = SHARD[0], SHARD[1] // 2
    table = sigmoid_table16(1.0, 0.1, 2.269).to(dev)
    for row0, periodic, dtype in ((R, True, torch.bfloat16), (0, False, torch.bfloat16),
                                  (MAIN_SHAPE[0] - R, False, torch.float32)):
        black = random_black(gen, SHARD, dtype, dev)
        up2, down2 = (random_black(gen, (2, 2 * C2), dtype, dev) for _ in range(2))
        top, bot = row0 == 0, row0 + R == MAIN_SHAPE[0]
        if not periodic:
            up2 = torch.zeros_like(up2) if top else up2
            down2 = torch.zeros_like(down2) if bot else down2
        U = torch.randint(0, 1 << 16, (2, R, C2), generator=cgen, device=dev, dtype=torch.int32)
        UH = tuple(torch.randint(0, 1 << 16, (1, C2), generator=cgen, device=dev,
                                 dtype=torch.int32) for _ in range(2))
        for u, uh in ((U, UH), (None, None)):
            kw = dict(seed=21, sweep=3, periodic=periodic, uniforms=u, up2=up2, down2=down2,
                      shard_info=(row0, MAIN_SHAPE[0], top, bot), uniforms_halo=uh)
            got = fused_sweep(black, table, **kw)
            want = fused_sweep_reference(black, table, **kw)
            for a, b in zip(got, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"K1 shard mode != plain: {int((a != b).sum())} sites "
                                         f"differ (row0 {row0}, periodic={periodic}, "
                                         f"injected={u is not None})")
                err1 = max(err1, float((a.float() - b.float()).abs().max()))
        torch.cuda.synchronize()
        log(f"phase 19: K1 shard mode {SHARD} {dtype} at row {row0} of {MAIN_SHAPE[0]}, "
            f"periodic={periodic}: kernel == plain, injected and Philox")
    return err3, n_band, n_differ, err1


def phase_sharded_exact(dev, gen):
    """Phase 20: sharded runs at 4096^2 equal the one-shard runs bit for bit."""
    lat = torch.where(torch.rand(MAIN_SHAPE, generator=gen) < 0.5, 1.0, -1.0)
    one = make_mesh(devices=[dev])
    for kernel, dtype, rows, cols in (("K1", torch.bfloat16, 4, 1), ("K3", torch.float32, 2, 2)):
        red, black = (x.to(dev, dtype).contiguous() for x in split_checkerboard(lat))
        for periodic in (True, False):
            kw = dict(periodic=periodic, fused=kernel == "K1")
            a = sharded_checkerboard_sweeps(one, 31, red, black, 2.269, 3, **kw)
            b = sharded_checkerboard_sweeps(make_mesh(rows=rows, cols=cols, devices=[dev] * 4),
                                            31, red, black, 2.269, 3,
                                            col_axis="col" if cols > 1 else None, **kw)
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                raise AssertionError(f"{kernel} on {rows}x{cols} shards != one shard "
                                     f"(periodic={periodic})")
            log(f"phase 20: {kernel} {MAIN_SHAPE} {dtype} on {rows} x {cols} shards of one card "
                f"== the one-shard run bit for bit over 3 sweeps, periodic={periodic}")
    torch.cuda.synchronize()


def phase_sharded_statistics(dev):
    T = 2.5
    m_x, e_x = exact_4x4(T)
    for rows, cols in ((2, 1), (2, 2)):
        out = sharded_lattice_sample(make_mesh(rows=rows, cols=cols, devices=[dev] * 4), 41,
                                     torch.ones(4, 4), n_samples=3000, temperature=T,
                                     n_burnin=100, n_sweeps=1,
                                     col_axis="col" if cols > 1 else None)
        m, se_m = batch_means(out["magnetization"].abs().numpy())
        e, se_e = batch_means(out["energy"].numpy() / 16)
        log(f"sharded 4x4 on {rows} x {cols} shards, T={T}: <|m|> {m:.5f} +- {se_m:.5f} (exact "
            f"{m_x:.5f}); <e> {e:.5f} +- {se_e:.5f} (exact {e_x:.5f})")
        if abs(m - m_x) > 4 * se_m or abs(e - e_x) > 4 * se_e:
            raise AssertionError("sharded 4x4 moments differ from exact enumeration by more "
                                 "than 4 SE")
    T, L = 2.0, 512
    onsager = (1.0 - np.sinh(2.0 / T) ** -4) ** 0.125
    out = sharded_lattice_sample(make_mesh(rows=2, cols=2, devices=[dev] * 4), 42,
                                 torch.ones(L, L), n_samples=40, temperature=T, n_burnin=200,
                                 n_sweeps=5, col_axis="col")
    m = float(out["magnetization"].abs().mean())
    log(f"{L}^2 T={T} ordered start on 2 x 2 shards (K3): <|m|> {m:.5f} (Onsager {onsager:.5f})")
    if abs(m - onsager) > 0.01:
        raise AssertionError("sharded 512^2 magnetization differs from Onsager's by more than 0.01")


def column_halo_views(run):
    """Run ``run()`` with the column halo exchange of the sharded paths
    watched; raise if a column halo between shards of one device is not a
    view of the neighbour shard's plane (a copy). Returns (output, the views
    handed out)."""
    real, views = lattice._halo_exchange_cols, [0]

    def watched(planes, periodic, *grid):
        lefts, rights = real(planes, periodic, *grid)
        m = len(planes[0])
        for i, row in enumerate(planes):
            for j, p in enumerate(row):
                for halo, nj, edge in ((lefts[i][j], (j - 1) % m, j == 0),
                                       (rights[i][j], (j + 1) % m, j == m - 1)):
                    if (edge and not periodic) or row[nj].device != p.device:
                        continue
                    if halo.untyped_storage().data_ptr() != row[nj].untyped_storage().data_ptr():
                        raise AssertionError(f"column halo of shard ({i}, {j}) is a copy")
                    views[0] += 1
        return lefts, rights

    lattice._halo_exchange_cols = watched
    try:
        return run(), views[0]
    finally:
        lattice._halo_exchange_cols = real


def phase_sharded_paths(dev):
    """Phase 22; returns the launches of K1, K2 and K3 on the paths."""
    cfg = IsingConfig()
    sweeps = cfg.n_burnin + 4 * cfg.n_sweeps
    n = MAIN_SHAPE[0] * MAIN_SHAPE[1]
    got = {}
    for rows, cols, want in ((4, 1, (4 * sweeps,)), (2, 2, (0,) * 7 + (4 * 2 * sweeps,))):
        mesh = make_mesh(rows=rows, cols=cols, devices=[dev] * 4)
        grid = IsingGrid(MAIN_SHAPE, periodic=True, seed=0, device=dev)
        (obs, c), views = column_halo_views(lambda: run_path(
            f"sample_observables(4) {MAIN_SHAPE} on {rows} x {cols} shards of one card",
            lambda: grid.sample_observables(4, temperature=2.269, mesh=mesh), want))
        if cols > 1:
            log(f"sharded sample_observables {rows} x {cols}: {views} column halos, each a view "
                "of the neighbour shard's plane (no copy)")
            if views < 2 * 4 * 2 * sweeps:
                raise AssertionError(f"{views} column halos seen, fewer than the K3 launches need")
        got[(rows, cols)] = c
        e = obs["energy"] / n
        log(f"sharded sample_observables {rows} x {cols}: m {obs['magnetization'].tolist()}, "
            f"e/site {e.tolist()}")
        if obs["energy"].shape != (4,) or not np.all(np.isfinite(e)) or not np.all(
                (e > -2.0) & (e < -1.0)):
            raise AssertionError("sharded observables out of range after 140 sweeps at T_c")

    rungs = np.geomspace(1.8, 3.0, PT_RUNGS)
    out, c = run_path(f"parallel_tempering_replica_sharded {PT_RUNGS} x {PT_SHAPE} over replica=4, "
                      "300 rounds", lambda: parallel_tempering_replica_sharded(
                          make_mesh(replica=4, devices=[dev] * 4), 0, PT_SHAPE, rungs,
                          n_samples=200, swap_interval=10, n_burnin=100), (0, 4 * 300))
    got["pt"] = c
    by_rung = np.take_along_axis(out["energy"], np.argsort(out["rungs"], axis=1), axis=1).mean(0)
    k = PT_RUNGS // 8
    log(f"replica-sharded tempering: {out['swap_accepts']} swaps accepted (rate "
        f"{out['swap_acceptance_rate']:.4f}); mean E of the {k} coldest rungs "
        f"{by_rung[:k].mean()}, of the {k} hottest {by_rung[-k:].mean()}")
    if (out["magnetization"].shape != (200, PT_RUNGS) or out["swap_accepts"] <= 0
            or not by_rung[:k].mean() < by_rung[-k:].mean()):
        raise AssertionError("replica-sharded tempering: shape, no swap, or cold rungs not below "
                             "hot ones")

    def grid_small(rows, cols):
        def run(d):
            out = IsingGrid((16, 16), periodic=True, seed=6, device=d,
                            config=IsingConfig(n_burnin=10, n_sweeps=2)).sample_observables(
                3, temperature=2.269, mesh=make_mesh(rows=rows, cols=cols, devices=[d] * 4))
            return [out["magnetization"], out["energy"]]
        return run
    same_on_cpu("sharded sample_observables 4 x 1", grid_small(4, 1), dev)
    same_on_cpu("sharded sample_observables 2 x 2", grid_small(2, 2), dev)
    same_on_cpu("parallel_tempering_replica_sharded", lambda d: [
        out[k] for out in [parallel_tempering_replica_sharded(
            make_mesh(replica=4, devices=[d] * 4), 7, (16, 16), np.geomspace(1.8, 3.0, 8),
            n_samples=6, swap_interval=2, n_burnin=4)] for k in ("magnetization", "energy",
                                                                  "rungs")], dev)
    return got[(4, 1)][0], got["pt"][1], got[(2, 2)][7]


def phase_sharded_timing(dev, name):
    """Phase 23; returns ms {K3 and its first body at 4096^2 f32 and bf16
    and at a 2048^2 f32 shard, in turns (first, this, this, first); K3
    plain; K1 shard; K1 shard plain; host per sharded sweep on rows=4 and on
    2 x 2}."""
    work = halfsweep_bodies.shapes(dev)
    libs = {"this": _build.halfsweep_library(), "first": halfsweep_bodies.scalar_library()}
    t = {}
    for turn in ("first", "this", "this", "first"):
        for label, w in work.items():
            t.setdefault(f"{turn} {label}", []).append(
                graph_ms(halfsweep_bodies.timed(libs[turn], w), 1000))
    f32, bf16, shard_label = work
    for key, label in (("K3", f32), ("K3 bf16", bf16), ("K3 shard", shard_label)):
        t[key], t[f"{key} first"] = t[f"this {label}"][0], t[f"first {label}"][0]
    halfsweep_bodies.timed(None, work[f32])(2)           # the plain version's first call
    t["K3 plain"] = time_sweeps(halfsweep_bodies.timed(None, work[f32]), 20)
    R, C2 = SHARD[0], SHARD[1] // 2
    gen = torch.Generator().manual_seed(61)
    black = random_black(gen, SHARD, torch.bfloat16, dev)
    up2, down2 = (random_black(gen, (2, 2 * C2), torch.bfloat16, dev) for _ in range(2))
    table = sigmoid_table16(1.0, 0.0, 2.269).to(dev)

    def shard(fn):
        def run(n):
            for k in range(n):
                fn(black, table, seed=5, sweep=k, up2=up2, down2=down2,
                   shard_info=(SHARD[0], MAIN_SHAPE[0], False, False))
        return run
    shard(fused_sweep)(4)
    t["K1 shard"] = graph_ms(shard(fused_sweep), 1000)
    shard(fused_sweep_reference)(2)
    t["K1 shard plain"] = time_sweeps(shard(fused_sweep_reference), 20)

    lat = torch.where(torch.rand(MAIN_SHAPE, generator=gen) < 0.5, 1.0, -1.0)
    for rows, cols, dtype in ((4, 1, torch.bfloat16), (2, 2, torch.float32)):
        red, black = (x.to(dev, dtype).contiguous() for x in split_checkerboard(lat))
        mesh = make_mesh(rows=rows, cols=cols, devices=[dev] * 4)

        def run(n):
            sharded_checkerboard_sweeps(mesh, 1, red, black, 2.269, n,
                                        col_axis="col" if cols > 1 else None)
            torch.cuda.synchronize()
        run(2)
        # The difference of two calls leaves out the scatter and the gather.
        t[f"host {rows}x{cols}"] = (host_ms(run, 101) * 101 - host_ms(run, 1)) / 100
    n = MAIN_SHAPE[0] * MAIN_SHAPE[1] // 2
    for label in work:
        log(f"timing on {name}: K3 {label} ms/half-sweep from a CUDA graph of 1000, turns "
            f"(first, this, this, first): this body {t[f'this {label}']}, first body "
            f"{t[f'first {label}']}")
    log(f"timing on {name}: K3 {MAIN_SHAPE} f32 {t['K3']:.6f} ms/half-sweep "
        f"({n / t['K3'] * 1e3:.4e} site updates/s), bf16 {t['K3 bf16']:.6f}, shard "
        f"{t['K3 shard']:.6f}; first body {t['K3 first']:.6f}, {t['K3 bf16 first']:.6f}, "
        f"{t['K3 shard first']:.6f}; plain f32 {t['K3 plain']:.6f} ms/half-sweep (20)")
    log(f"timing on {name}: K1 shard mode {SHARD} bf16 {t['K1 shard']:.6f} ms/sweep (a CUDA graph "
        f"of 1000), plain {t['K1 shard plain']:.6f} ms/sweep (20)")
    log(f"timing on {name}: one sharded {MAIN_SHAPE} sweep on one card, host clock, halo exchange "
        f"included: 4 x 1 shards (K1, bf16) {t['host 4x1']:.6f} ms, 2 x 2 shards (K3, f32) "
        f"{t['host 2x2']:.6f} ms")
    return t


# -- slice 4: dense and sparse discrete sampling, MAX-CUT, resume -----------

BAND = 1e-6          # |u - p| below this may round either way


def exact_dense(J, h, T: float, values=(-1.0, 1.0)):
    """Mean state, <E> and <m^2> (m the mean of a state) of E(x) = -1/2
    x^T J x - h^T x over x in ``values``^n by enumerating every state
    (n <= 16)."""
    n = len(h)
    bits = (np.arange(2**n)[:, None] >> np.arange(n)) & 1
    x = np.where(bits == 1, values[1], values[0]).astype(np.float64)
    J, h = np.asarray(J, np.float64), np.asarray(h, np.float64)
    E = -0.5 * np.einsum("ki,ij,kj->k", x, J, x) - x @ h
    w = np.exp(-(E - E.min()) / T)
    w /= w.sum()
    return w @ x, float(w @ E), float(w @ x.mean(axis=1) ** 2)


def random_couplings(seed: int, n: int, scale: float = 0.7):
    rng = np.random.default_rng(seed)
    J = rng.normal(0, scale, (n, n))
    J = ((J + J.T) / 2).astype(np.float32)
    np.fill_diagonal(J, 0.0)
    return J, rng.normal(0, 0.5, n).astype(np.float32)


def check_dense(what, x, J, h, T, tol, values=(-1.0, 1.0)):
    """Against enumeration: <E> within 4 batch-means SEs, and either the
    marginal means within ``tol`` (the JAX tests' tolerance for random
    couplings) or, for a model symmetric under a global flip (``tol`` None),
    <m^2> within 4 SEs: its marginals are zero and converge only as fast as
    the chains flip their ordered domains."""
    mean, e_x, m2_x = exact_dense(J, h, T, values)
    dev_mean = float(np.abs(x.mean(axis=0) - mean).max())
    E = -0.5 * np.einsum("ki,ij,kj->k", x, J.astype(np.float64), x) - x @ h.astype(np.float64)
    e, se = batch_means(E.astype(np.float64), 40)
    m2, se_m2 = batch_means(x.mean(axis=1) ** 2, 40)
    log(f"{what}: max |mean - exact| {dev_mean:.4f}"
        + (f" (< {tol})" if tol is not None else "")
        + f"; <E> {e:.4f} +- {se:.4f} (exact {e_x:.4f}); <m^2> {m2:.4f} +- {se_m2:.4f} "
        f"(exact {m2_x:.4f})")
    bad = dev_mean >= tol if tol is not None else abs(m2 - m2_x) > 4 * se_m2
    if bad or abs(e - e_x) > 4 * se:
        raise AssertionError(f"{what}: moments differ from exact enumeration")


def phase_dense_statistics(dev):
    J, h = random_couplings(7, 10)
    for order, init in (("checkerboard", None), ("sequential", np.zeros(10))):
        s = GibbsSampler(GibbsConfig(n_burnin=100, n_sweeps=3, n_chains=8, update_order=order),
                         seed=3, device=dev)
        x = s.sample_boltzmann(J, bias=h, n_samples=8000, initial_state=init)
        if s.last_route != "device":
            raise AssertionError(f"GibbsSampler {order} took route {s.last_route}")
        check_dense(f"10-bit machine, {order}", x.astype(np.float64), J, h, 1.0, 0.06,
                    (0.0, 1.0))
    chain = IsingChain(12, J=1.0, seed=2, device=dev,
                       config=IsingConfig(n_burnin=100, n_sweeps=2, n_chains=8))
    chain.set_coupling(11, 0, 1.0)
    check_dense("12-spin periodic chain, T = 1.5", chain.sample(8000, temperature=1.5)
                .astype(np.float64), chain.J, chain.h, 1.5, None)
    grid = IsingGrid((3, 5), periodic=True, seed=3, device=dev,
                     config=IsingConfig(n_burnin=100, n_sweeps=2, n_chains=8))
    if grid._fast:
        raise AssertionError("a 3x5 grid did not fall back to the dense engine")
    check_dense("3x5 periodic grid (dense), T = 2.0", grid.sample(8000, temperature=2.0)
                .astype(np.float64), grid.J, grid.h, 2.0, None)
    cold, info = parallel_tempering_dense(0, J, h, temperatures=[1.0, 1.5, 2.3, 3.4],
                                          n_samples=6000, swap_interval=2, n_burnin=100,
                                          device=dev)
    check_dense(f"parallel_tempering_dense cold rung (swap acceptance "
                f"{info['swap_acceptance_rate']:.3f})", cold.cpu().numpy().astype(np.float64),
                J, h, 1.0, 0.07, (0.0, 1.0))


def eager_sweep_band(plan, states, u, T):
    """The eager colour loop, also returning which sites' uniforms lay
    within BAND of their probability."""
    band = torch.zeros_like(states, dtype=torch.bool)
    for a, b in plan.bounds:
        field = torch.addmm(plan.h[a:b], states, plan.J[a:b].t())
        field.addcmul_(plan.diag[a:b], states[:, a:b], value=-1.0)
        p = torch.sigmoid(field.div_(T))
        band[:, a:b] = (u[:, a:b] - p).abs() < BAND
        torch.lt(u[:, a:b], p, out=states[:, a:b])
    return band


def dense_sk(dev):
    n, chains, _ = DENSE
    plan = ColourPlan(sk_couplings(n), np.zeros(n), device=dev)
    if plan.n_colors != n:
        raise AssertionError(f"the SK instance has {plan.n_colors} colours, not {n}")
    sweeper = DenseSweeper(plan, chains, 0)
    sweeper.load((torch.rand((chains, n), generator=torch.Generator().manual_seed(1)) < 0.5)
                 .float())
    sweeper.set_temperature(1.0)
    return plan, sweeper


def phase_dense_graph(dev):
    plan, sweeper = dense_sk(dev)
    t0 = time.perf_counter()
    sweeper.run(1)                      # warm-up and capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    eager = sweeper.states.clone()
    u = torch.rand((2, *eager.shape), device=dev, generator=torch.Generator(dev).manual_seed(5))
    n_band = n_differ = 0
    for k in range(2):
        sweeper.u.copy_(u[k])
        sweeper._graph.replay()
        band = eager_sweep_band(plan, eager, u[k], sweeper.T)
        differ = sweeper.states != eager
        n_band += int(band.sum())
        n_differ += int(differ.sum())
        if bool((differ & ~band).any()):
            raise AssertionError("the graphed colour sweep differs from the eager one outside "
                                 "the band")
        eager.copy_(sweeper.states)
    log(f"4096-spin SK, 8 chains, 2 sweeps: graph == eager outside the band; {n_band} band "
        f"sites, {n_differ} differ; capture with its warm-up sweep {capture_s:.3f} s")
    return {"capture_s": capture_s, "band_sites": n_band, "band_differ": n_differ}


def phase_dense_paths(dev, name):
    plan, sweeper = dense_sk(dev)
    sweeper.run(1)
    eager_ms = time_sweeps(lambda k: [colour_sweep(plan, sweeper.states, sweeper.u, sweeper.T)
                                      for _ in range(k)], 2)
    graph_sweep_ms = time_sweeps(sweeper.run, 20)
    eager_launches = host_launches(lambda: colour_sweep(plan, sweeper.states, sweeper.u,
                                                        sweeper.T))
    graph_launches = host_launches(lambda: sweeper.run(1))
    log(f"4096-spin SK sweep, 8 chains ({name}): eager {eager_ms:.6f} ms, {eager_launches} "
        f"host launch calls; graphed {graph_sweep_ms:.6f} ms, {graph_launches} host launch "
        "calls (the uniforms' draw and the graph)")
    out = {"eager_ms_per_sweep": eager_ms, "graph_ms_per_sweep": graph_sweep_ms,
           "eager_host_launches_per_sweep": eager_launches,
           "graph_host_launches_per_sweep": graph_launches}

    model = IsingModel(DENSE[0], config=IsingConfig(n_chains=DENSE[1]), seed=0, device=dev)
    model.J = sk_couplings(DENSE[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = model.sample(DENSE[2])
    out["ising_model_sample_s"] = time.perf_counter() - t0
    if s.shape != (DENSE[2], DENSE[0]) or not np.all(np.abs(s) == 1.0):
        raise AssertionError("IsingModel(4096).sample returned no spins")
    t0 = time.perf_counter()
    s = IsingGrid((63, 65), periodic=True, seed=0, device=dev).sample(64)
    out["odd_grid_sample_s"] = time.perf_counter() - t0
    if s.shape != (64, 63 * 65) or not np.all(np.abs(s) == 1.0):
        raise AssertionError("IsingGrid((63, 65)).sample returned no spins")

    rng = np.random.default_rng(2000)
    W = np.triu((rng.random((2000, 2000)) < 0.5).astype(np.float32), 1)
    W = W + W.T
    t0 = time.perf_counter()
    res = optimize(MaxCutProblem(W), seed=torch.Generator().manual_seed(0), device=dev)
    out["maxcut_dense_s"] = time.perf_counter() - t0
    cut = -res["best_objective"]
    greedy, _ = native.greedy_maxcut_csr(*native.csr_from_dense(W), n_restarts=3, seed=0)
    out.update(maxcut_dense_cut=cut, maxcut_dense_greedy=greedy)
    log(f"IsingModel(4096).sample(64), 8 chains: {out['ising_model_sample_s']:.3f} s; "
        f"IsingGrid((63, 65)).sample(64): {out['odd_grid_sample_s']:.3f} s; "
        f"optimize(MaxCutProblem(G(2000, 0.5))): {out['maxcut_dense_s']:.3f} s, cut {cut:.1f} "
        f"(native greedy bound {greedy:.1f})")
    return out


def phase_maxcut_sparse(dev):
    n, m, steps = SPARSE
    edges, w = suite_graph(n, m)
    csr = native.csr_from_edges(n, edges, w)
    greedy, _ = native.greedy_maxcut_csr(*csr, n_restarts=3, seed=0)
    t0 = time.perf_counter()
    idx, _ = sparse_ising.ell_from_edges(n, edges, w)
    ell_s = time.perf_counter() - t0
    sparse_ising.maxcut_sparse(0, n, edges, w, n_steps=steps, device=dev)      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sparse_ising.maxcut_sparse(0, n, edges, w, n_steps=steps, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sched = np.geomspace(3.0, 0.05, 40).astype(np.float32)
    anneal = [host_launches(lambda: sparse_ising.sparse_anneal(
        0, idx, -np.ones(idx.shape, np.float32), np.zeros(n, np.float32), sched, n_steps=k,
        device=dev)) for k in (20, 40)]
    per_step = (anneal[1] - anneal[0]) / 20
    cut = out["cut_value"]
    check = native.cut_value_csr(*csr, out["spins"])
    log(f"maxcut_sparse {n} nodes, {len(edges)} edges, {steps} steps, 8 chains: ELL build "
        f"{ell_s:.3f} s (K = {idx.shape[1]}), anneal wall {wall:.3f} s, {per_step:.2f} host launch "
        f"calls per step (40 steps less 20), cut {cut:.1f} (native check "
        f"{check:.1f}), native greedy bound {greedy:.1f}")
    if cut != check:
        raise AssertionError("maxcut_sparse's cut disagrees with the native cut value")
    if cut < greedy:
        raise AssertionError("maxcut_sparse did not reach the native greedy bound")
    return {"ell_build_s": ell_s, "wall_s": wall, "host_launches_per_step": per_step,
            "cut": cut, "greedy_bound": greedy, "K": int(idx.shape[1])}


class killed_after_first_save:
    """Within the block, ``module.save_state`` writes its snapshot and then
    raises, as a run killed right after its first snapshot would stop."""

    def __init__(self, module):
        self.module, self.real = module, module.save_state

    def __enter__(self):
        def dying(*args, **kwargs):
            self.real(*args, **kwargs)
            raise KeyboardInterrupt("killed after the first snapshot")
        self.module.save_state = dying

    def __exit__(self, kind, value, tb):
        self.module.save_state = self.real
        return kind is KeyboardInterrupt


def resumed_equals(what, run, module, path, same):
    """run(path, resume) with a snapshot path; the run killed after its first
    snapshot, then resumed, must equal the uninterrupted run."""
    full = run(None, False)
    with killed_after_first_save(module):
        run(path, False)
        raise AssertionError(f"{what}: the run was not killed at its first snapshot")
    resumed = run(path, True)
    if not same(full, resumed):
        raise AssertionError(f"{what}: the resumed run differs from the uninterrupted one")
    log(f"resume {what}: killed after its first snapshot, resumed == uninterrupted")


def phase_resume(dev, workdir):
    import os

    gen = np.random.default_rng(28)
    edges = gen.integers(0, 10_000, (50_000, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    idx, w = sparse_ising.ell_from_edges(10_000, edges, np.ones(len(edges)))
    sched = np.geomspace(3.0, 0.05, 400).astype(np.float32)
    resumed_equals(
        "sparse_anneal 10,000 nodes, 4 chunks",
        lambda p, r: sparse_ising.sparse_anneal(
            1, idx, -w, np.zeros(10_000, np.float32), sched, n_steps=400, chunk_steps=100,
            checkpoint_path=p, resume=r, device=dev),
        sparse_ising, os.path.join(workdir, "sparse"),
        lambda a, b: a[1] == b[1] and torch.equal(a[0], b[0]))

    Jh, Jv = pm1_bonds(torch.Generator().manual_seed(28), (256, 256))
    resumed_equals(
        "anneal_spin_glass 256^2 ±J, 3 restarts",
        lambda p, r: anneal_spin_glass(2, Jh, Jv, n_steps=200, n_restarts=3, checkpoint_path=p,
                                       resume=r, device=dev),
        annealing, os.path.join(workdir, "anneal"),
        lambda a, b: a[1] == b[1] and np.array_equal(a[0], b[0]))

    Jh, Jv = pm1_bonds(torch.Generator().manual_seed(29), (64, 64))
    resumed_equals(
        "pt_ground_state_search 64^2 ±J, 40 iterations, a snapshot every 10",
        lambda p, r: pt_ground_state_search(
            3, Jh, Jv, temperatures=np.geomspace(0.3, 2.0, 16), n_iters=40, n_copies=2,
            houdayer_every=5, quench_sweeps=16, checkpoint_path=p, checkpoint_every=10,
            resume=r, device=dev),
        tempering_ladder, os.path.join(workdir, "ladder"),
        lambda a, b: a["best_energy"] == b["best_energy"] and np.array_equal(
            a["best_state"], b["best_state"]))

    lat0 = torch.where(torch.rand((512, 512), generator=torch.Generator().manual_seed(30))
                       < 0.5, 1.0, -1.0).to(dev)
    mesh = make_mesh(rows=2, cols=2, devices=[dev] * 4)
    resumed_equals(
        "sharded_lattice_sample 512^2 on 2 x 2 shards of one card",
        lambda p, r: sharded_lattice_sample(
            mesh, 4, lat0, n_samples=8, temperature=2.269, n_burnin=10, n_sweeps=2,
            col_axis="col", checkpoint_path=p, checkpoint_every=0 if p is None else 2,
            resume=r),
        lattice, os.path.join(workdir, "sharded"),
        lambda a, b: (torch.equal(a["magnetization"], b["magnetization"])
                      and torch.equal(a["energy"], b["energy"])
                      and all(torch.equal(x, y) for x, y in zip(a["final_planes"],
                                                                 b["final_planes"]))))


# -- slice 5: the continuous samplers ----------------------------------------

STATS_CHAINS = 1024          # chains of phase 30's moment checks (NUTS: 256)
SMC_SIZE = (16_384, 10)      # phase 30/31's annealed SMC: particles, dim
SCALING = dict(n_chains=1024, dim=10, n_burnin=50, n_samples=50, n_steps=10, dt=0.05)
NUTS_BNN = dict(chains=16, max_depth=8, n_burnin=50, n_samples=10)   # phase 31
VI_BNN = dict(n_steps=1000, n_mc=16)
STATE_ATOL = 1e-4            # card == CPU on the same draws (the CPU tests' tolerance)


class Recorded(Draws):
    """Draws from a generator that keep what they drew, so that other runs
    can take the same draws (``replay``)."""

    def __init__(self, gen):
        super().__init__(gen=gen)
        self.log = {}

    def fill(self, name, kind, out, *bounds):
        super().fill(name, kind, out, *bounds)
        self.log.setdefault(name, []).append(out.detach().cpu().clone())

    def replay(self) -> Draws:
        return Draws(given={k: torch.cat(v) for k, v in self.log.items()})


class Precision:
    """E(x) = (x - m)^T L (x - m) / 2 with its constants kept per device
    (a correlated Gaussian; mean-field VI's optimum is N(m, 1/L_ii))."""

    def __init__(self, L, m):
        self.L, self.m, self._on = np.asarray(L, np.float32), np.asarray(m, np.float32), {}

    def __call__(self, x):
        if x.device not in self._on:
            self._on[x.device] = (torch.tensor(self.L, device=x.device),
                                  torch.tensor(self.m, device=x.device))
        L, m = self._on[x.device]
        d = x - m
        return 0.5 * torch.sum(d * (L @ d))


def aniso(var0: float, var1: float):
    """The anisotropic Gaussian of tests/test_nuts.py (variances 9, 0.04)."""
    def energy(x):
        return x[0] ** 2 / (2 * var0) + x[1] ** 2 / (2 * var1)
    return energy


ANISO = aniso(9.0, 0.04)
MIX4 = MixtureOfGaussians(((-1.0, 0.0, 0.5, 0.0), (1.0, 0.5, 0.0, -0.5)), (0.8, 1.1))


def exact_runs(bnn):
    """name -> run(draws, x0, graph) -> (tensor, route) of each step loop,
    at 4 chains x dim 4 (SMC: 64 particles x 4; VI: the mean of a 4-D fit;
    MALA also on a (1, 8, 8, 1) BNN posterior, 97 parameters)."""
    return {
        "langevin BAOAB": lambda d, x, g: run_langevin(
            d, x, energy_fn=MIX4, n_samples=10, n_burnin=20, n_steps=5, dt=0.05, graph=g),
        "langevin Euler-Maruyama": lambda d, x, g: run_langevin(
            d, x, energy_fn=MIX4, n_samples=10, n_burnin=20, n_steps=5, dt=0.01,
            underdamped=False, graph=g),
        "mala": lambda d, x, g: _info_route(run_mala(
            d, x, energy_fn=MIX4, n_samples=20, n_burnin=30, step_size=0.1, graph=g)),
        "mala bnn 97": lambda d, x, g: _info_route(run_mala(
            d, 0.3 * x.repeat(1, 25)[:, :97], energy_fn=bnn, n_samples=10, n_burnin=20,
            step_size=1e-3, graph=g)),
        "hmc": lambda d, x, g: (lambda r: (r[0], r[2]))(run_hmc(
            d, x, energy_fn=MIX4, n_samples=10, n_burnin=10, step_size=0.2, n_leapfrog=6,
            graph=g)),
        "hmc_adaptive": lambda d, x, g: _info_route(run_hmc_adaptive(
            d, x, energy_fn=MIX4, n_samples=20, n_burnin=4, n_leapfrog=8, graph=g)),
        "nuts": lambda d, x, g: _info_route(run_nuts(
            d, x, energy_fn=MIX4, n_samples=5, n_burnin=3, max_depth=5, graph=g)),
        "annealed_smc": lambda d, x, g: (lambda r: (r["particles"][0], r["route"]))(run_smc(
            d, [3.0 * x.repeat(16, 1)], energy_fn=MIX4, n_steps=12, n_moves=3,
            ess_threshold=0.6, graph=g)),
        "fit_meanfield_vi": lambda d, x, g: (lambda r: (torch.cat([r[0].mu, r[0].rho]), r[2]))(
            run_vi(d, MIX4, 4, x.device, n_steps=50, n_mc=4, graph=g)),
    }


def _info_route(result):
    samples, info = result
    return samples, info["route"]


def phase_continuous_exact(dev):
    """Each step loop on one set of draws: the graph replay == the eager
    loop on the card bit for bit, and the card's eager loop == the CPU's
    within STATE_ATOL."""
    cpu = torch.device("cpu")
    rng = np.random.default_rng(7)
    xb = rng.uniform(-1, 1, (20, 1)).astype(np.float32)
    yb = (np.sin(3 * xb) + 0.1 * rng.normal(size=xb.shape)).astype(np.float32)
    bnn = BNNPosterior(xb, yb, (1, 8, 8, 1))
    x0 = torch.randn((4, 4), generator=torch.Generator().manual_seed(29))
    out = {}
    for k, (name, run) in enumerate(exact_runs(bnn).items()):
        rec = Recorded(torch.Generator().manual_seed(100 + k))
        ref, _ = run(rec, x0.clone(), True)
        eager, route_e = run(rec.replay(), x0.to(dev), False)
        graph, route_g = run(rec.replay(), x0.to(dev), True)
        if (route_e, route_g) != ("eager", "graph"):
            raise AssertionError(f"{name}: routes {route_e}, {route_g}, not eager, graph")
        if not torch.equal(graph, eager):
            raise AssertionError(f"{name}: the graph replay differs from the eager loop")
        err = float((eager.cpu() - ref).abs().max())
        if not err <= STATE_ATOL:
            raise AssertionError(f"{name}: the card's eager loop differs from the CPU's by {err}")
        out[name] = err
        log(f"{name}: graph == eager bit for bit; card - CPU max |diff| {err:.3g}")
    return out


def _moments(what, flat, mean, std, tol_mean, tol_std):
    m, sd = flat.mean(axis=0), flat.std(axis=0)
    log(f"{what}: mean {np.round(m, 4).tolist()}, std {np.round(sd, 4).tolist()} "
        f"(exact {mean}, {std})")
    if np.any(np.abs(m - mean) >= tol_mean) or np.any(np.abs(sd - np.asarray(std)) >= tol_std):
        raise AssertionError(f"{what}: moments differ from the exact ones")


def phase_continuous_statistics(dev):
    C = STATS_CHAINS
    z4, z2 = np.zeros((C, 4)), np.zeros((C, 2))
    std_n, std_a, tol_a = [1.0] * 4, [3.0, 0.2], np.array([0.35, 0.03])
    routes = {}
    runs = {
        "langevin": (lambda x, e: (sample_langevin(0, x, energy_fn=e, n_samples=20, dt=0.05,
                                                   n_burnin=1000, n_steps=50, device=dev),
                                   sample_langevin.last_route)),
        "mala": (lambda x, e: _info_route(sample_mala(1, x, energy_fn=e, n_samples=200,
                                                      n_burnin=2000, device=dev))),
        "hmc": (lambda x, e: (lambda r: (r[0], sample_hmc.last_route))(sample_hmc(
            2, x, energy_fn=e, n_samples=100, n_burnin=200,
            **(dict(step_size=0.1, n_leapfrog=30) if e is ANISO
               else dict(step_size=0.3, n_leapfrog=8)), device=dev))),
        "hmc_adaptive": (lambda x, e: _info_route(sample_hmc_adaptive(
            3, x, energy_fn=e, n_samples=100, n_burnin=400,
            n_leapfrog=32 if e is ANISO else 16, device=dev))),
        "nuts": (lambda x, e: _info_route(sample_nuts(
            4, x[:256], energy_fn=e, n_samples=50, n_burnin=150,
            max_depth=8 if e is ANISO else 6, device=dev))),
    }
    for name, run in runs.items():
        s, routes[name] = run(z4, Quadratic(0.0, 1.0))
        _moments(f"{name} N(0, 1) dim 4", s.reshape(-1, 4).cpu().numpy(), 0.0, std_n, 0.08, 0.08)
        s, _ = run(z2, ANISO)
        _moments(f"{name} anisotropic (9, 0.04)", s.reshape(-1, 2).cpu().numpy(), 0.0, std_a,
                 0.35, tol_a)
    P, d = SMC_SIZE
    parts = 3.0 * torch.randn((P, d), generator=torch.Generator().manual_seed(30))
    smc = annealed_smc(5, parts, energy_fn=Quadratic(0.0, 1.0), device=dev)
    exact = -d * np.log(3.0)
    log(f"annealed_smc {P} x {d}: log Z {float(smc['log_Z']):.4f} (exact -d ln 3 = {exact:.4f})")
    if abs(float(smc["log_Z"]) - exact) >= 0.15:
        raise AssertionError("annealed_smc's log Z differs from -d ln 3")
    routes["annealed_smc"] = smc["route"]
    L, m = [[2.0, 1.2], [1.2, 1.5]], [1.0, -1.0]
    vi = fit_meanfield_vi(6, Precision(L, m), 2, n_steps=2000, device=dev)
    opt = 1.0 / np.sqrt(np.diag(L))
    log(f"fit_meanfield_vi, correlated 2-D Gaussian: mu {vi['mu'].cpu().numpy()}, sigma "
        f"{vi['sigma'].cpu().numpy()} (optimum {m}, {opt})")
    if (np.abs(vi["mu"].cpu().numpy() - m).max() >= 0.05
            or np.abs(vi["sigma"].cpu().numpy() - opt).max() >= 0.05):
        raise AssertionError("fit_meanfield_vi missed the mean-field optimum")
    routes["fit_meanfield_vi"] = vi["route"]
    tsu = ThermalSamplingUnit(seed=7, device=dev)
    n = 200_000
    for p in (0.1, 0.5, 0.9):
        rate = tsu.p_bit(p, n).mean()
        if abs(rate - p) >= 5 * np.sqrt(p * (1 - p) / n):
            raise AssertionError(f"p_bit({p}) rate {rate}")
    probs = np.array([0.2, 0.5, 0.3])
    freqs = np.bincount(tsu.sample_categorical(probs, n), minlength=3) / n
    if np.any(np.abs(freqs - probs) >= 5 * np.sqrt(probs * (1 - probs) / n)):
        raise AssertionError(f"sample_categorical frequencies {freqs}")
    log(f"p_bit and sample_categorical ({n} draws): rates within 5 SE; categorical {freqs}")
    if any(r != "graph" for r in routes.values()):
        raise AssertionError(f"a phase-30 path ran eagerly: {routes}")
    return routes


def continuous_path(what, fn, steps: int, check, short=None):
    """A phase-31 path from zeroed kernel counts: a warm-up call (the
    capture), a timed call, then a profiled call; ``fn()`` returns (result,
    route), ``check(result)`` raises on wrong physics. ``short``: (fn,
    steps) of the same path cut shorter for the profiled call (the
    profiler's cost grows with the kernels it records, millions on the
    longest paths); its graphs are the path's own."""
    reset_counts()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result, route = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    extra = check(result) or {}
    if route != "graph":
        raise AssertionError(f"{what} took route {route}")
    if any(counts()):
        raise AssertionError(f"{what} launched a lattice kernel: {counts()}")
    prof_fn, prof_steps = short or (fn, steps)
    t0 = time.perf_counter()
    prof = profile_once(prof_fn, [])
    # The profiler slows the host about twofold on these paths, so beside
    # its idle share stands the device time it saw a step against the wall
    # without it.
    busy_share = prof["busy_ms"] / prof_steps * steps / (wall * 1e3)
    row = {"wall_s": wall, "steps": steps, "route": route,
           "host_launches_per_step": prof["host_launches"] / prof_steps,
           "idle_share": prof["idle_share"], "idle_share_unprofiled": 1.0 - busy_share,
           "profiled_steps": prof_steps,
           "profiled_wall_ms": prof["wall_ms"], "busy_ms": prof["busy_ms"],
           "profile_s": time.perf_counter() - t0, **extra}
    log(f"{what}: wall {wall:.3f} s ({wall / steps * 1e3:.4f} ms a step, {steps} steps), "
        f"route {route}; under the profiler ({prof_steps} steps): "
        f"{row['host_launches_per_step']:.3f} host launch calls a step, idle "
        f"{prof['idle_share']:.1%} (its device time a step against the wall without it: "
        f"{1.0 - busy_share:.1%} idle)" + "".join(f", {k} {v}" for k, v in extra.items()))
    return row


def phase_continuous_paths(dev):
    out = {}
    chains, n = QUICK

    def quick(samples=n):
        tsu = ThermalSamplingUnit(TSUConfig(n_chains=chains), seed=0, device=dev)
        return tsu.sample_gaussian(0.0, 1.0, samples), tsu.last_route

    def quick_check(s):
        v = validate_distribution(s, "gaussian", {"mu": 0.0, "sigma": 1.0})
        if not v["valid"] or s.shape != (n,):
            raise AssertionError(f"the quick start's samples fail the KS test: {v}")
        return {"ks_p_value": v["p_value"], "mean": v["sample_mean"], "std": v["sample_std"]}

    per_chain = -(-n // chains)
    out["readme_quick_start"] = continuous_path(
        f"README quick start ThermalSamplingUnit(TSUConfig(n_chains={chains}))"
        f".sample_gaussian(0, 1, {n})", quick, 100 + per_chain * 100, quick_check,
        short=(lambda: quick(n // 20), 100 + -(-n // 20 // chains) * 100))

    sc = SCALING

    def scaling():
        s = sample_langevin(0, np.zeros((sc["n_chains"], sc["dim"])),
                            energy_fn=Quadratic(0.0, 1.0), n_samples=sc["n_samples"],
                            dt=sc["dt"], n_burnin=sc["n_burnin"], n_steps=sc["n_steps"],
                            device=dev)
        return s, sample_langevin.last_route

    def scaling_check(s):
        s = s.cpu().numpy()
        if abs(s.mean()) >= 0.02 or abs(s.var() - 1.0) >= 0.05:
            raise AssertionError(f"scaling row moments {s.mean()}, {s.var()}")
        return {"mean": float(s.mean()), "var": float(s.var())}

    out["scaling_langevin"] = continuous_path(
        "scaling suite's Langevin row, 1024 chains x dim 10", scaling,
        sc["n_burnin"] + sc["n_samples"] * sc["n_steps"], scaling_check)

    post = full_bayes_posterior()
    fb = FULL_BAYES
    start = bnn_start(post, fb["chains"]).to(dev)
    e_start = float(torch.func.vmap(post)(start).mean())

    def mala(burnin=fb["burnin"]):
        s, info = sample_mala(0, start, energy_fn=post, n_samples=fb["draws"],
                              step_size=fb["step"], n_burnin=burnin, device=dev)
        return (s, info), info["route"]

    def mala_check(r):
        s, info = r
        e_end = float(torch.func.vmap(post)(s[:, -1]).mean())
        if not (0.4 <= info["accept_rate"] <= 0.75 and bool(torch.isfinite(s).all())
                and e_end < e_start):
            raise AssertionError(f"MALA on the BNN posterior: {info}, energy {e_start} -> "
                                 f"{e_end}")
        return {"accept_rate": info["accept_rate"], "step_size": info["step_size"],
                "energy_start": e_start, "energy_end": e_end}

    out["mala_bnn"] = continuous_path(
        f"sample_mala on the {post.dim}-parameter BNN posterior, {fb['chains']} chains",
        mala, fb["burnin"] + fb["draws"], mala_check,
        short=(lambda: mala(MALA_CHUNK + fb["burnin"] % MALA_CHUNK),
               MALA_CHUNK + fb["burnin"] % MALA_CHUNK + fb["draws"]))

    nb = NUTS_BNN

    def nuts(burnin=nb["n_burnin"], samples=nb["n_samples"]):
        s, info = sample_nuts(1, start, energy_fn=post, n_samples=samples,
                              n_burnin=burnin, max_depth=nb["max_depth"],
                              init_step_size=fb["step"], device=dev)
        return (s, info), info["route"]

    def mcmc_check(r):
        s, info = r
        if not bool(torch.isfinite(s).all()):
            raise AssertionError(f"non-finite draws: {info}")
        return {k: v for k, v in info.items() if k != "route"}

    out["nuts_bnn"] = continuous_path(
        f"sample_nuts on the BNN posterior, max_depth {nb['max_depth']}", nuts,
        nb["n_burnin"] + nb["n_samples"], mcmc_check, short=(lambda: nuts(2, 2), 4))

    def hmc_adaptive():
        s, info = sample_hmc_adaptive(2, start, energy_fn=post, n_samples=nb["n_samples"],
                                      n_burnin=nb["n_burnin"], device=dev)
        return (s, info), info["route"]

    out["hmc_adaptive_bnn"] = continuous_path(
        "sample_hmc_adaptive on the BNN posterior, 16 leapfrog steps", hmc_adaptive,
        nb["n_burnin"] + nb["n_samples"], mcmc_check)

    P, d = SMC_SIZE
    parts = 3.0 * torch.randn((P, d), generator=torch.Generator().manual_seed(31))

    def smc():
        r = annealed_smc(8, parts, energy_fn=Quadratic(0.0, 1.0), device=dev)
        return r, r["route"]

    def smc_check(r):
        if abs(float(r["log_Z"]) + d * np.log(3.0)) >= 0.15:
            raise AssertionError(f"annealed_smc log Z {float(r['log_Z'])}")
        return {"log_Z": float(r["log_Z"])}

    out["annealed_smc"] = continuous_path(f"annealed_smc {P} x {d}", smc, 50, smc_check)
    mesh = make_mesh(chains=4, devices=[dev] * 4)

    def sharded():
        r = annealed_smc_sharded(mesh, 8, parts, energy_fn=Quadratic(0.0, 1.0))
        return r, r["route"]

    def sharded_check(r):
        one = annealed_smc(8, parts, energy_fn=Quadratic(0.0, 1.0), device=dev)
        if not (np.array_equal(r["particles"], one["particles"].cpu().numpy())
                and np.array_equal(r["log_weights"], one["log_weights"].cpu().numpy())
                and np.array_equal(r["ess_history"], one["ess_history"].cpu().numpy())
                and r["log_Z"] == float(one["log_Z"])):
            raise AssertionError("annealed_smc_sharded differs from annealed_smc")
        return {"log_Z": r["log_Z"], "equal_to_unsharded": True}

    out["annealed_smc_sharded"] = continuous_path(
        f"annealed_smc_sharded {P} x {d} on make_mesh(chains=4, devices=[cuda:0] * 4)",
        sharded, 50, sharded_check)

    vb = VI_BNN

    def vi(n_steps=vb["n_steps"]):
        r = fit_meanfield_vi(9, post, post.dim, n_steps=n_steps, n_mc=vb["n_mc"],
                             init_sigma=0.1, device=dev)
        return r, r["route"]

    def vi_check(r):
        losses = r["losses"].cpu().numpy()
        first, last = float(losses[:50].mean()), float(losses[-50:].mean())
        if not (np.all(np.isfinite(losses)) and last < first):
            raise AssertionError(f"the ELBO did not improve: {first} -> {last}")
        return {"neg_elbo_first50": first, "neg_elbo_last50": last}

    out["vi_bnn"] = continuous_path(f"fit_meanfield_vi on the BNN posterior, n_mc {vb['n_mc']}",
                                    vi, vb["n_steps"], vi_check, short=(lambda: vi(128), 128))

    problem = ShiftedQuadratic(np.linspace(-1.0, 1.0, 10))

    def fallback():
        r = optimize(problem, seed=0, device=dev)
        return r, r["route"]

    def fallback_check(r):
        if np.abs(r["best_solution"] - problem.target).max() >= 0.1:
            raise AssertionError(f"optimize's fallback missed the minimum: {r}")
        return {"best_objective": r["best_objective"]}

    out["optimize_fallback"] = continuous_path(
        "optimize(a torch objective in dim 10), annealed Langevin", fallback,
        10 * (1000 // 10 + 1), fallback_check)
    return out


class ShiftedQuadratic(OptimizationProblem):
    """A problem without ``to_ising``: |x - target|^2 in torch operations."""

    def __init__(self, target):
        self.target = np.asarray(target, np.float32)
        self._on = {}

    def objective(self, x):
        if x.device not in self._on:
            self._on[x.device] = torch.tensor(self.target, device=x.device)
        return torch.sum((x - self._on[x.device]) ** 2)

    @property
    def dimension(self):
        return len(self.target)


def _turns(fn_e, fn_g, n):
    """ms per step of ``fn(n)`` eager and graphed, in turns (eager, graph,
    graph, eager), host clock, synchronised."""
    times = {"eager": [], "graph": []}
    for which, fn in (("eager", fn_e), ("graph", fn_g), ("graph", fn_g), ("eager", fn_e)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(n)
        torch.cuda.synchronize()
        times[which].append((time.perf_counter() - t0) * 1e3 / n)
    return times


def phase_continuous_timing(dev, name):
    """ms per step of each sampler's loop, graphed and eager, in turns, and
    the host's launch calls per step of each."""
    post = full_bayes_posterior()
    start = bnn_start(post, FULL_BAYES["chains"]).to(dev)
    chains, _ = QUICK
    P, d = SMC_SIZE
    parts = 3.0 * torch.randn((P, d), generator=torch.Generator().manual_seed(32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(32)
    draws = Draws(gen)
    loops = {}
    for g in (False, True):
        run_langevin(draws, torch.zeros((chains, 1), device=dev), energy_fn=Quadratic(0.0, 1.0),
                     n_samples=1, n_burnin=1, n_steps=1, graph=g)
        run_mala(draws, start, energy_fn=post, n_samples=1, n_burnin=1, step_size=1e-3, graph=g)
        run_hmc(draws, start, energy_fn=post, n_samples=1, n_burnin=1, step_size=1e-3, graph=g)
        run_hmc_adaptive(draws, start, energy_fn=post, n_samples=1, n_burnin=1, graph=g)
        run_nuts(draws, start, energy_fn=post, n_samples=1, n_burnin=1, max_depth=8,
                 init_step_size=1e-3, graph=g)
        run_smc(draws, [parts], energy_fn=Quadratic(0.0, 1.0), n_steps=50, graph=g)
        run_vi(draws, post, post.dim, dev, n_steps=1, n_mc=16, graph=g)
        key = "graph" if g else "eager"
        loops[key] = {
            "langevin (quick start, 16 x 1)": langevin_loop(Quadratic(0.0, 1.0), chains, 1, dev,
                                                            graph=g),
            "mala (BNN 16 x 1153)": mala_loops(post, 16, post.dim, dev, graph=g)["main"],
            "hmc (BNN, 10 leapfrog)": hmc_loop(post, 16, post.dim, dev, graph=g),
            "hmc_adaptive (BNN, 16 leapfrog)": hmc_adaptive_loops(post, 16, post.dim, dev,
                                                                  graph=g)["main"],
            "nuts (BNN, max_depth 8; a step is a transition)": nuts_loops(
                post, 16, post.dim, dev, graph=g)["main"],
            "annealed_smc (16384 x 10, 5 moves)": smc_loop(
                Quadratic(0.0, 1.0), (dev,), P, d, n_steps=50, n_moves=5, ess_threshold=0.5,
                graph=g),
            "fit_meanfield_vi (BNN, n_mc 16)": vi_loop(post, post.dim, 16, dev, graph=g),
        }
    lengths = {"langevin (quick start, 16 x 1)": 100, "mala (BNN 16 x 1153)": 100,
               "hmc (BNN, 10 leapfrog)": 20, "hmc_adaptive (BNN, 16 leapfrog)": 10,
               "nuts (BNN, max_depth 8; a step is a transition)": 1,
               "annealed_smc (16384 x 10, 5 moves)": 10, "fit_meanfield_vi (BNN, n_mc 16)": 50}

    def run(lp, n):
        if "betas" in lp.state:             # SMC: stay on its 50-step ladder
            lp.state["t"].zero_()
        lp.run(draws, n)

    return _loop_timings(loops, lengths, run, name)


def _loop_timings(loops, lengths, run, name) -> dict:
    """ms per step of each loop eager and graphed, in turns, and the host's
    launch calls per step of each: ``loops[route][what]`` the loops,
    ``lengths[what]`` steps a call, ``run(loop, n)`` one call."""
    out = {}
    for what, L in lengths.items():
        le, lg = loops["eager"][what], loops["graph"][what]
        if (le.route, lg.route) != ("eager", "graph"):
            raise AssertionError(f"{what}: routes {le.route}, {lg.route}")
        run(lg, L)                          # the graph of this length is captured here
        t = _turns(lambda n: run(le, n), lambda n: run(lg, n), L)
        launches = {k: host_launches(lambda lp=lp: run(lp, L)) / L
                    for k, lp in (("eager", le), ("graph", lg))}
        out[what] = {"eager_ms_per_step": t["eager"], "graph_ms_per_step": t["graph"],
                     "eager_host_launches_per_step": launches["eager"],
                     "graph_host_launches_per_step": launches["graph"], "steps_per_call": L}
        log(f"{what} ({name}): eager {t['eager'][0]:.4f}, {t['eager'][1]:.4f} ms a step, "
            f"{launches['eager']:.1f} host launch calls a step; graphed {t['graph'][0]:.4f}, "
            f"{t['graph'][1]:.4f} ms a step, {launches['graph']:.3f} host launch calls a step "
            f"({L} steps a call; eager, graph, graph, eager)")
    return out


# -- slice 6: BNNs and the benchmark suites ------------------------------------

BNN_FIT = dict(sizes=(1, 32, 32, 1), n_points=100, n_mc=3, steps=20)   # the sinusoid row's net
BNN_ENSEMBLE = dict(members=8, sizes=(1, 32, 32, 1), n_points=80, steps=50)
PREDICT = dict(n_samples=200, n_points=200)           # the ML rows' predictive
DP_POINTS = 16_384                                    # measure_bnn_dp_scaling's points per device
LATTICE_MATCHED = dict(size=4096, n_sweeps=2500, n_iters=3)
RUNNER_ROWS = {
    "sampling": ["uniform_binary", "boltzmann_chain", "ferromagnet_bimodal"],
    "optimization": ["maxcut", "graph_coloring", "number_partitioning", "maxcut_sparse",
                     "spin_glass_ea"],
    "ml": ["sinusoid", "heteroscedastic", "extrapolation", "sinusoid_mcmc_quick"],
    "comparison": ["sampling", "sampling", "sampling", "optimization", "optimization",
                   "optimization", "multi_trial"],
}


def _sinusoid(seed: int, n: int):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    y = (np.sin(3 * x) + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def _on(tree, dev):
    """A nest of lists and dicts of tensors copied to ``dev``."""
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_on(v, dev) for v in tree]
    return tree.detach().to(dev).clone()


def _bnn_trainable(cpu):
    net = BayesianRegressor(1, list(BNN_FIT["sizes"][1:-1]), seed=0, device=cpu)
    return _on({"layers": net.params, "log_noise": net.log_noise}, cpu)


def _ensemble_state(cpu):
    e = BNN_ENSEMBLE
    reg = AnchoredEnsembleRegressor(1, list(e["sizes"][1:-1]), n_members=e["members"], seed=0,
                                    device=cpu)
    return reg.trainable, reg.anchors


def _compare(what, card, cpu, rtol, atol, gate=True) -> float:
    """Raise (if ``gate``) unless every card tensor is within rtol/atol of
    its CPU one; returns the largest absolute difference."""
    worst = 0.0
    for a, b in zip(card, cpu):
        a = a.cpu()
        if gate and not torch.allclose(a, b, rtol=rtol, atol=atol):
            raise AssertionError(f"{what}: the card differs from the CPU by "
                                 f"{float((a - b).abs().max())}")
        worst = max(worst, float((a - b).abs().max()))
    return worst


def _three_ways(what, run, cpu, dev, rtol, atol, gate=True) -> float:
    """``run(device, graph) -> (tensors, route)`` on the CPU, eagerly on the
    card and from the card's graphs: graph == eager bit for bit, the card ==
    the CPU within rtol/atol (when ``gate``); returns the card - CPU max
    |diff|."""
    ref, route_c = run(cpu, False)
    eager, route_e = run(dev, False)
    graph, route_g = run(dev, True)
    if (route_c, route_e, route_g) != ("eager", "eager", "graph"):
        raise AssertionError(f"{what}: routes {route_c}, {route_e}, {route_g}")
    if not all(torch.equal(a, b) for a, b in zip(graph, eager)):
        raise AssertionError(f"{what}: the graph replay differs from the eager loop")
    err = _compare(what, eager, ref, rtol, atol, gate)
    log(f"{what}: graph == eager bit for bit; card - CPU max |diff| {err:.3g}")
    return err


def phase_bnn_exact(dev):
    cpu = torch.device("cpu")
    f, e, pr = BNN_FIT, BNN_ENSEMBLE, PREDICT
    gen = torch.Generator().manual_seed(33)
    x, y = _sinusoid(33, f["n_points"])
    trainable = _bnn_trainable(cpu)
    eps = torch.randn((f["steps"], f["n_mc"], ml.n_weights(f["sizes"])), generator=gen)
    out = {}
    kw = dict(kl_weight=0.1, temperature=1.0, activation="relu", prior_std=1.0)
    with torch.no_grad():
        out["forward_sample"] = _compare(
            "forward_sample", [ml.forward_sample(_on(trainable["layers"], dev), x.to(dev),
                                                 eps[0, 0].to(dev), 1.0, "relu")],
            [ml.forward_sample(trainable["layers"], x, eps[0, 0], 1.0, "relu")], 1e-5, 1e-6)
        card = ml.elbo_loss(_on(trainable, dev), eps[0].to(dev), x.to(dev), y.to(dev), **kw)
        ref = ml.elbo_loss(trainable, eps[0], x, y, **kw)
        out["elbo_loss"] = _compare("elbo_loss", [card[0], *card[1]], [ref[0], *ref[1]], 1e-5, 0)
    log(f"forward_sample and elbo_loss: card - CPU max |diff| {out['forward_sample']:.3g}, "
        f"{out['elbo_loss']:.3g}")

    def fit(device, graph):
        tr, losses, kls, route = ml.run_fit(
            Draws(given={"eps": eps}), _on(trainable, device), x.to(device), y.to(device),
            n_steps=f["steps"], learning_rate=0.01, n_mc=f["n_mc"], graph=graph, **kw)
        return [losses, kls], ml._flat(tr), route

    (lc, pc, _), (le, pe, re_), (lg, pg, rg) = fit(cpu, False), fit(dev, False), fit(dev, True)
    if (re_, rg) != ("eager", "graph"):
        raise AssertionError(f"bnn fit: routes {re_}, {rg}")
    if not all(torch.equal(a, b) for a, b in zip(lg + pg, le + pe)):
        raise AssertionError("bnn fit: the graph replay differs from the eager loop")
    out["fit_losses"] = _compare("bnn fit losses", le, lc, 1e-5, 0)
    out["fit_params"] = _compare("bnn fit parameters", pe, pc, 0, 1e-4)
    log(f"bnn fit {f['sizes']}, {f['n_points']} points, n_mc {f['n_mc']}, {f['steps']} steps: "
        f"graph == eager bit for bit; card - CPU losses {out['fit_losses']:.3g}, parameters "
        f"{out['fit_params']:.3g}")

    tr_e, anchors = _ensemble_state(cpu)
    xe, ye = _sinusoid(34, e["n_points"])

    def ensemble(activation, steps):
        def run(device, graph):
            tr, losses, route = ml.run_anchored(_on(tr_e, device), _on(anchors, device),
                                                xe.to(device), ye.to(device), n_steps=steps,
                                                learning_rate=0.01, prior_std=1.0,
                                                activation=activation, graph=graph)
            return ([losses] + [t for l in tr["layers"] for t in (l["w"], l["b"])]
                    + [tr["log_noise"]], route)
        return run

    # A relu unit whose input rounds to the other side of 0 on the card
    # takes another gradient from there on: over 50 relu steps the card and
    # the CPU part by up to 5.8e-4 (2.5e-6 after 20), so the card is held
    # to the CPU over 50 tanh steps and 20 relu steps, and the 50 relu
    # steps' difference is logged.
    what = f"anchored ensemble {e['members']} x {e['sizes']}, {e['n_points']} points"
    out["ensemble"] = _three_ways(f"{what}, tanh, {e['steps']} steps",
                                  ensemble("tanh", e["steps"]), cpu, dev, 1e-4, 1e-4)
    out["ensemble_relu_20"] = _three_ways(f"{what}, relu, 20 steps", ensemble("relu", 20), cpu,
                                          dev, 1e-4, 1e-4)
    out["ensemble_relu_50_logged"] = _three_ways(f"{what}, relu, {e['steps']} steps (logged)",
                                                 ensemble("relu", e["steps"]), cpu, dev, 1e-4,
                                                 1e-4, gate=False)

    xp = torch.linspace(-1, 1, pr["n_points"])[:, None]
    eps_p = torch.randn((1, pr["n_samples"], ml.n_weights(f["sizes"])), generator=gen)

    def predict(device, graph):
        pred, route = ml.run_predict(Draws(given={"eps": eps_p}), _on(trainable["layers"], device),
                                     xp.to(device), 1.0, "relu", pr["n_samples"], graph=graph)
        return [pred], route

    out["predict"] = _three_ways(f"predict {pr['n_samples']} draws x {pr['n_points']} points",
                                 predict, cpu, dev, 1e-5, 1e-5)
    return out


def phase_ml_suite(dev):
    bench = MLBenchmark(seed=0, device=dev)
    t0 = time.perf_counter()
    rows = {r.name: r.summary() for r in bench.run_all_benchmarks(quick=False)}
    wall = time.perf_counter() - t0
    for name, row in rows.items():
        log(f"ML row {name} (route {bench.routes[name]}): {json.dumps(row)}")
    bad = [n for n, r in rows.items() if not 0.85 <= r["coverage_95"] <= 1.0]
    bad += [n for n in ("sinusoid", "sinusoid_mcmc") if not rows[n]["r2"] > 0.9]
    ex = rows["extrapolation"]
    if not (ex["uncertainty_ratio"] > 5.0 and 0.88 <= ex["coverage_95"] <= 1.0):
        bad.append("extrapolation")
    if bad:
        raise AssertionError(f"ML rows out of their bands: {bad}")
    if any(r != "graph" for r in bench.routes.values()):
        raise AssertionError(f"an ML row ran eagerly: {bench.routes}")
    log(f"ML suite at full size: {wall:.3f} s, every row in its band, routes {bench.routes}")

    dp = measure_bnn_dp_scaling(devices=[dev] * 4)
    one = bnn_dp_row([dev], 4 * DP_POINTS)
    rel = abs(dp["all_devices"]["loss_final"] - one["loss_final"]) / abs(one["loss_final"])
    log(f"bnn_dp: one device {DP_POINTS} points {dp['1_device']['points_per_s']:.6g} points/s; "
        f"[cuda:0] * 4, {4 * DP_POINTS} points {dp['all_devices']['points_per_s']:.6g} points/s; "
        f"the same points on one device {one['points_per_s']:.6g} points/s; final losses "
        f"{dp['all_devices']['loss_final']:.7g} (split) and {one['loss_final']:.7g} (one device), "
        f"relative difference {rel:.3g}")
    if not rel <= 1e-4:
        raise AssertionError("bnn_dp: the split run's final loss differs from one device's")
    return {"rows": rows, "routes": bench.routes, "wall_s": wall,
            "bnn_dp": {**dp, "one_device_same_points": one, "split_vs_one_rel": rel}}


def check_quick_runner(runner, out, got) -> int:
    """Phase 35's checks of a quick run of the runner: every row of the four
    suites, each row's route, and K5's launches (spin_glass_ea) alone;
    returns K5's launches."""
    for suite, names in RUNNER_ROWS.items():
        if [r["name"] for r in out["suites"][suite]] != names:
            raise AssertionError(f"runner suite {suite}: rows {out['suites'][suite]}")
    want_routes = {"sampling": 3, "optimization": 5, "ml": 4, "comparison": 3}
    for suite, n in want_routes.items():
        if len(runner.routes[suite]) != n or not all(runner.routes[suite].values()):
            raise AssertionError(f"runner suite {suite}: routes {runner.routes[suite]}")
    k5 = got[NAMES.index("K5")]
    log(f"runner quick: {out['total_time_s']} s (total_time_s); routes {runner.routes}; launches "
        + ", ".join(f"{k} {n}" for k, n in zip(NAMES, got)))
    if k5 <= 0 or any(n for k, n in zip(NAMES, got) if k != "K5"):
        raise AssertionError(f"runner quick: expected K5 launches (spin_glass_ea) only, got {got}")
    return k5


def phase_lattice_matched(dev):
    lm = LATTICE_MATCHED
    reset_counts()
    t0 = time.perf_counter()
    matched = measure_lattice_matched(device=dev, **lm)
    wall = time.perf_counter() - t0
    got = counts()
    log(f"measure_lattice_matched {lm}: {matched['flips_per_s']:.6g} flips/s, {wall:.3f} s; "
        "launches " + ", ".join(f"{k} {n}" for k, n in zip(NAMES, got)))
    if got != expect((1 + lm["n_iters"]) * lm["n_sweeps"]):
        raise AssertionError(f"measure_lattice_matched: launches {got}")
    return {**matched, "wall_s": wall, "k1_launches": got[0]}


def phase_bnn_timing(dev, name):
    """ms per step of the BNN loops, eager and graphed in turns, and the
    host's launch calls per step."""
    f, e, pr = BNN_FIT, BNN_ENSEMBLE, PREDICT
    cpu = torch.device("cpu")
    x, y = _sinusoid(36, f["n_points"])
    xe, ye = _sinusoid(37, e["n_points"])
    xp = torch.linspace(-1, 1, pr["n_points"])[:, None].to(dev)
    trainable = _on(_bnn_trainable(cpu), dev)
    tr_e, anchors = (_on(t, dev) for t in _ensemble_state(cpu))
    draws = Draws(torch.Generator(device=dev).manual_seed(36))
    what = {"fit": f"BNN fit step {f['sizes']}, {f['n_points']} points, n_mc {f['n_mc']}",
            "ensemble": f"ensemble step {e['members']} x {e['sizes']}, {e['n_points']} points",
            "predict": f"predict {pr['n_samples']} draws x {pr['n_points']} points (a step is a call)"}
    loops = {}
    for g in (False, True):
        ml.run_fit(draws, trainable, x.to(dev), y.to(dev), n_steps=1, learning_rate=0.01,
                   kl_weight=0.1, temperature=1.0, prior_std=1.0, n_mc=f["n_mc"],
                   activation="relu", graph=g)
        ml.run_anchored(tr_e, anchors, xe.to(dev), ye.to(dev), n_steps=1, learning_rate=0.01,
                        prior_std=1.0, activation="relu", graph=g)
        ml.run_predict(draws, trainable["layers"], xp, 1.0, "relu", pr["n_samples"], graph=g)
        loops["graph" if g else "eager"] = {
            what["fit"]: ml.fit_loop(f["sizes"], "relu", f["n_mc"], f["n_points"], True, dev,
                                     graph=g),
            what["ensemble"]: ml.ensemble_loop(e["sizes"], e["members"], "relu", e["n_points"],
                                               dev, graph=g),
            what["predict"]: ml.predict_loop(f["sizes"], "relu", pr["n_samples"], pr["n_points"],
                                             dev, graph=g)}

    def run(lp, n):
        if lp.name == "bnn predict":
            for _ in range(n):
                lp.run(draws, 1)
        else:
            lp.run(draws, n)

    return _loop_timings(loops, {what["fit"]: 64, what["ensemble"]: 64, what["predict"]: 20},
                         run, name)


# -- slice 7: the CLI, critical_ess, the demos, the tools and the graft entry --

ISING_SWEEP = ["ising-sweep", "--size", "1024", "--t-min", "1.5", "--t-max", "3.5",
               "--n-temps", "16", "--n-samples", "64"]          # the phase scan of phase 9
FERRO_ANNEAL = ["anneal", "--size", "4096", "--steps", "1000"]   # 2 chains (--restarts 2)
GLASS_ANNEAL = ["anneal", "--size", "4096", "--steps", "3000", "--spin-glass", "--restarts", "2"]
WOLFF = dict(L=64, n_steps=4000)                                  # critical_ess's first Wolff row


def launch_counts(got) -> dict:
    return {k: n for k, n in zip(NAMES, got) if n}


@contextlib.contextmanager
def recorded(cls, name):
    """Record (instance, result) of every call of ``cls.name`` inside."""
    calls = []
    orig = getattr(cls, name)

    def wrapped(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        calls.append((self, out))
        return out

    setattr(cls, name, wrapped)
    try:
        yield calls
    finally:
        setattr(cls, name, orig)


def run_cli(argv, tail: int = 16) -> dict:
    """cli.main(argv) on the card from zeroed counts: its output (the last
    ``tail`` lines logged), wall and launches."""
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    out = buf.getvalue()
    log(f"cli {' '.join(argv)}: exit {rc}, {wall:.3f} s, launches {launch_counts(got)}")
    for line in out.strip().splitlines()[-tail:]:
        log(f"  | {line}")
    if rc != 0:
        raise AssertionError(f"cli {argv}: exit code {rc}")
    return {"argv": argv, "wall_s": wall, "launches": got, "out": out}


def _json_line(run) -> dict:
    return json.loads(run["out"].strip().splitlines()[-1])


def phase_cli(dev, workdir):
    """The CLI at its users' sizes; returns each command's record."""
    runs = {}
    runs["version"] = v = run_cli(["version"])
    if "tsu_tpu_torch" not in v["out"] or torch.cuda.get_device_name(0) not in v["out"]:
        raise AssertionError(f"version: {v['out']}")

    runs["sample"] = r = run_cli(["sample"])
    res = _json_line(r)
    if not (abs(res["sample_mean"]) < 0.3 and abs(res["sample_std"] - 1.0) < 0.5):
        raise AssertionError(f"sample: {res}")

    runs["ising-sweep"] = r = run_cli(ISING_SWEEP)
    m = [float(ln.split("|M|=")[1].split()[0]) for ln in r["out"].splitlines() if "T=" in ln]
    if len(m) != 16 or not (m[0] > 0.9 and m[-1] < 0.2):
        raise AssertionError(f"ising-sweep: |M| {m}")
    if r["launches"] != expect(0, 200 + 64 * 2):
        raise AssertionError(f"ising-sweep: launches {r['launches']}")

    runs["anneal"] = r = run_cli(FERRO_ANNEAL)
    # Phase 9's bound for this anneal: 1,000 sweeps do not coarsen 4096^2 to
    # the ground state (-2.0), which the CPU tests reach at 8^2.
    if not _json_line(r)["energy_per_site"] < -1.85 or r["launches"] != expect(0, 1000):
        raise AssertionError(f"anneal: {_json_line(r)}, launches {r['launches']}")

    ck = os.path.join(workdir, "anneal_ck")
    runs["anneal --spin-glass"] = r = run_cli(GLASS_ANNEAL + ["--checkpoint", ck])
    glass = _json_line(r)
    if not glass["energy_per_site"] < -1.3 or r["launches"] != expect(0, 0, 2 * 3000 * 2):
        raise AssertionError(f"anneal --spin-glass: {glass}, launches {r['launches']}")
    runs["anneal --spin-glass --resume"] = r = run_cli(GLASS_ANNEAL + ["--checkpoint", ck,
                                                                       "--resume"])
    if r["out"] != runs["anneal --spin-glass"]["out"] or any(r["launches"]):
        raise AssertionError(f"anneal --resume: {r['out']} against {glass}")

    runs["bnn"] = r = run_cli(["bnn"])
    if r["out"].count("pred=") != 9 or any(r["launches"]):
        raise AssertionError(f"bnn: {r['out']}")

    with recorded(BenchmarkRunner, "run_all") as calls:
        runs["bench"] = r = run_cli(["bench", "--quick", "--no-save"], tail=4)
    (runner, out), = calls
    r["k5_launches"] = check_quick_runner(runner, out, r["launches"])
    r["total_time_s"] = out["total_time_s"]
    for run in runs.values():
        del run["out"]
    return runs


def phase_critical_ess(dev, name, wolff):
    """critical_ess's Tc_L64 and T3.0_L4096 rows at the script's settings,
    the Wolff row at L = 64 (``wolff``: the future of its chain), and the
    4096^2 projection at K1's rate measured here."""
    rows = []
    for label, seed, L, T, settings in (
            ("Tc_L64", fold_seed(critical_ess.SEED, 0), 64, critical_ess.T_C,
             critical_ess.tc_settings(64, False)),
            ("T3.0_L4096", fold_seed(critical_ess.SEED, 101), 4096, 3.0,
             critical_ess.away_settings(False))):
        thin = settings["thin"]
        chunk = critical_ess.chunk_size(L, thin)
        padded = (-(-max(settings["burnin"] // thin, 1) // chunk)
                  + -(-settings["n_meas"] // chunk)) * chunk
        reset_counts()
        t0 = time.perf_counter()
        row = critical_ess.run_row(seed, L, T, label=label, device=dev, log=log, **settings)
        wall = time.perf_counter() - t0
        got = counts()
        log(f"critical_ess {label}: tau_int_M {row['tau_int_M_sweeps']} sweeps, tau_int_E "
            f"{row['tau_int_E_sweeps']}, ESS_M/s {row['ess_M_per_s']}, run_over_tau "
            f"{row['run_over_tau']}, {row['sweeps_per_s_measured']} sweeps/s with observables, "
            f"wall {wall:.3f} s, launches {launch_counts(got)}")
        if got != expect(padded * thin):
            raise AssertionError(f"critical_ess {label}: launches {got}, want K1 {padded * thin}")
        rows.append({**row, "wall_s": wall, "k1_launches": got[0]})
    taus = [r[k] for r in rows for k in ("tau_int_M_sweeps", "tau_int_E_sweeps")]
    if not all(np.isfinite(t) and t > 0 for t in taus):
        raise AssertionError(f"critical_ess: tau {taus}")
    if not rows[1]["mean_abs_m"] < 0.01:
        raise AssertionError(f"critical_ess T3.0_L4096: <|m|> {rows[1]['mean_abs_m']}")

    t0 = time.perf_counter()
    w = wolff.result()
    wrow = critical_ess.wolff_row(w, WOLFF["L"], rows, log)
    log(f"Wolff L={WOLFF['L']} x {WOLFF['n_steps']} steps (host, in a second process since "
        f"phase 37; waited {time.perf_counter() - t0:.3f} s here)")
    if not (np.isfinite(wrow["tau_int_M_wolff_steps"]) and wrow["tau_int_M_wolff_steps"] > 0):
        raise AssertionError(f"Wolff row: {wrow}")

    reset_counts()
    rate = critical_ess.kernel_sweeps_per_s(dev)
    got = counts()
    tc = rows[0]
    # One T_c size runs here: the fit's z is the literature's 2.17 through it.
    A = tc["tau_int_M_sweeps"] / tc["L"] ** 2.17
    proj = critical_ess.projection(A, 2.17, tc["L"], tc["tau_int_M_sweeps"],
                                   rows[1]["sweeps_per_s_measured"], rate, name)
    log(f"projection_4096_Tc (one T_c size, z = 2.17; K1's rate {rate:.6g} sweeps/s at 4096^2 "
        f"bf16, launches {launch_counts(got)}): {json.dumps(proj)}")
    return {"rows": rows, "wolff": wrow, "projection_4096_Tc": proj, "kernel_launches": got}


def _save_figures(plt, workdir, prefix) -> int:
    nums = plt.get_fignums()
    for n in nums:
        plt.figure(n).savefig(os.path.join(workdir, f"{prefix}_{n}.png"))
    plt.close("all")
    return len(nums)


def phase_demos_tools(dev, workdir):
    """The three demos on the card, the PT probe at its defaults and the
    scaling projection's measured row; the demos' figures on Agg when
    matplotlib is importable, else the ImportError a plot raises."""
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    plt = None
    if has_mpl:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    out, figures = {}, 0

    def timed(what, fn):
        reset_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        log(f"{what}: {wall:.3f} s, launches {launch_counts(got)}")
        out[what] = {"wall_s": wall, "launches": got}
        return res, got

    cont, got = timed("demo_continuous_sampling",
                      lambda: demos.demo_continuous_sampling(make_plots=has_mpl, device=dev))
    cov = cont["tsu"]["coverage"]["n_modes_covered"]
    out["demo_continuous_sampling"]["modes_covered"] = cov
    if cov != 3 or any(got):
        raise AssertionError(f"demo_continuous_sampling: {cov}/3 modes, launches {got}")
    if has_mpl:
        figures += _save_figures(plt, workdir, "continuous")

    pt, got = timed("demo_phase_transition",
                    lambda: demos.demo_phase_transition(make_plots=has_mpl, device=dev))
    cold = pt["temperatures"] <= 2.0
    gap = float(np.max(np.abs(pt["magnetization"][cold] - pt["onsager"][cold])))
    out["demo_phase_transition"]["max_gap_to_onsager_T_le_2"] = gap
    if not gap < 0.1 or got != expect(0, 200 + 48 * 2):
        raise AssertionError(f"demo_phase_transition: gap {gap}, launches {got}")
    if has_mpl:
        figures += _save_figures(plt, workdir, "phase")

    bayes, got = timed("demo_bayesian_inference",
                       lambda: demos.demo_bayesian_inference(make_plots=has_mpl, device=dev))
    err = float(np.max(np.abs(bayes["posterior_mean"] - bayes["theta_true"])))
    out["demo_bayesian_inference"]["max_posterior_error"] = err
    if not err < 0.1 or any(got):
        raise AssertionError(f"demo_bayesian_inference: error {err}, launches {got}")
    if has_mpl:
        figures += _save_figures(plt, workdir, "bayes")

    lines, got = timed("pt_spin_glass_probe", lambda: pt_spin_glass_probe.main([], log=log))
    out["pt_spin_glass_probe"].update(ladder=lines[0], gs=lines[1])
    log(f"pt_spin_glass_probe (256^2, 2000 iterations): e/site {lines[1]['energy_per_site']}, "
        f"gap to -1.4015 {lines[1]['gap_vs_lit']}, {lines[0]['n_rungs']} rungs")
    if got[NAMES.index("K5")] <= 0 or any(n for k, n in zip(NAMES, got) if k != "K5"):
        raise AssertionError(f"pt_spin_glass_probe: launches {got}")

    measured, got = timed("scaling_projection",
                          lambda: scaling_projection.measure_sharded_sweep_time(device=dev))
    lat = measured["copy_latency_s"]
    proj = [scaling_projection.project(measured, n, scaling_projection.NVLINK_BYTES_PER_S, lat)
            for n in (2, 4, 8)]
    proj.append(scaling_projection.project(measured, 2, scaling_projection.NDR_BYTES_PER_S, lat))
    out["scaling_projection"].update(measured_1chip=measured, projected=proj)
    log(f"scaling_projection measured row: {json.dumps(measured)}; efficiency NVLink 2/4/8 "
        f"{[p['projected_efficiency'] for p in proj[:3]]}, NDR 2 hosts "
        f"{proj[3]['projected_efficiency']}")
    n_sweeps = LATTICE_MATCHED["n_sweeps"] * (1 + LATTICE_MATCHED["n_iters"])
    if got != expect(n_sweeps):
        raise AssertionError(f"scaling_projection: launches {got}, want K1 {n_sweeps}")

    if has_mpl:
        branch = f"matplotlib importable: {figures} figures drawn on Agg into a temporary directory"
    else:
        try:
            plot_phase_transition(pt["temperatures"], pt["magnetization"], show=False)
        except ImportError as e:
            if "matplotlib" not in str(e):
                raise
            branch = f"no matplotlib: a plot call raised ImportError ({e})"
        else:
            raise AssertionError("a plot call without matplotlib did not raise")
    log(f"plots: {branch}")
    out["plots"] = branch
    return out


def phase_graft(dev):
    """graft_entry: entry()'s fn once on the card, then dryrun_multichip(4)
    on [cuda:0] * 4 (the visible cards, then cuda:0 repeated)."""
    fn, args = graft_entry.entry()
    reset_counts()
    res = fn(*args)
    torch.cuda.synchronize()
    got = counts()
    if got != expect(1) or not set(torch.unique(res).tolist()) <= {-1.0, 1.0}:
        raise AssertionError(f"entry: launches {got}, values {torch.unique(res)}")
    devices = graft_entry.mesh_devices(4)
    reset_counts()
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got2 = counts()
    log(f"graft entry: one sweep of 256^2, launches {launch_counts(got)}; dryrun_multichip(4) "
        f"on {[str(d) for d in devices]}: {wall:.3f} s, launches {launch_counts(got2)}")
    n = dict(zip(NAMES, got2))
    if not (n["K1"] and n["K2"] and n["K3"]) or any(n[k] for k in ("K4", "K5", "K6", "K7", "K8")):
        raise AssertionError(f"dryrun_multichip: launches {got2}")
    return {"entry_launches": got, "dryrun_devices": [str(d) for d in devices],
            "dryrun_wall_s": wall, "dryrun_launches": got2}


def run_slice7(dev, name):
    """Phases 37-40; returns the launches of each of their paths."""
    t_slice7 = time.perf_counter()
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=spawn) as pool, \
            tempfile.TemporaryDirectory(dir=str(_build.BUILD_DIR.parent)) as workdir:
        # critical_ess's Wolff row is host numpy only (~1 min): it runs in a
        # second process beside phases 37 and 38.
        wolff = pool.submit(wolff_chain, critical_ess.SEED, WOLFF["L"], critical_ess.T_C,
                            WOLFF["n_steps"])
        cli_runs = phase_cli(dev, workdir)
        log("phase 37: the CLI ran at its users' sizes through K2, K4 and K5; the quick runner "
            "ran every row of its four suites")

        ess = phase_critical_ess(dev, name, wolff)
        log("phase 38: critical_ess's rows ran K1 at the script's settings; the projection uses "
            "the card's K1 rate")

        demo_tools = phase_demos_tools(dev, workdir)
    log("phase 39: the demos, the PT probe and the scaling projection ran on the card")

    graft = phase_graft(dev)
    log("phase 40: the graft entry ran K1; dryrun_multichip(4) ran K1's shard mode, K3 and K2")
    slice7_s = time.perf_counter() - t_slice7
    log(f"phases 37-40 added {slice7_s:.1f} s")
    log("slice 7: " + json.dumps({"cli": cli_runs, "critical_ess": ess,
                                  "demos_tools": demo_tools, "graft": graft,
                                  "seconds": slice7_s, "card": name}, default=float))
    slice7 = {f"cli {k}": r["launches"] for k, r in cli_runs.items()}
    slice7.update({f"critical_ess {r['label']}": expect(r["k1_launches"]) for r in ess["rows"]})
    slice7["critical_ess kernel rate"] = ess["kernel_launches"]
    slice7.update({k: v["launches"] for k, v in demo_tools.items() if isinstance(v, dict)})
    slice7["graft entry"] = graft["entry_launches"]
    slice7["graft dryrun_multichip(4)"] = graft["dryrun_launches"]
    return slice7


# -- slice 8: the multi-process runtime -----------------------------------------

QUICK_START = dict(kind="sample", shape=list(MAIN_SHAPE), seed=41, temperature=2.269,
                   n_samples=4, n_burnin=100, n_sweeps=10)    # the default IsingConfig
TORCHRUN_TIMEOUT_S = 240                                      # each torchrun of phase 41


def torchrun(n: int, argv: list, what: str) -> float:
    """``python -m torch.distributed.run --standalone --nproc-per-node n``
    on ``argv`` from the repository root, rank r on cuda:r mod the cards
    (one card: the ranks share it over gloo, by the backend rule; a card a
    rank: NCCL); raises if a rank fails, or stops the ranks and raises if
    the run outlasts TORCHRUN_TIMEOUT_S. Returns its wall."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(n), *argv]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out = proc.communicate(timeout=TORCHRUN_TIMEOUT_S)[0]
    except subprocess.TimeoutExpired:
        proc.terminate()                  # torchrun stops its ranks on SIGTERM
        try:
            proc.wait(30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        raise
    if proc.returncode != 0:
        raise AssertionError(f"{what}: torchrun exited {proc.returncode}:\n{out[-6000:]}")
    return time.perf_counter() - t0


def run_ranks(n: int, cases: list, workdir: str, tag: str) -> tuple:
    """The check tool's cases on n ranks; returns (each rank's results,
    torchrun's wall)."""
    out = os.path.join(workdir, tag)
    spec = os.path.join(workdir, f"{tag}.json")
    with open(spec, "w") as f:
        json.dump(cases, f)
    wall = torchrun(n, ["-m", "tsu_tpu_torch.tools.multiprocess_check", out, spec],
                    f"{n} ranks: {[c['name'] for c in cases]}")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(n)], wall


def _cpu(x):
    return x.cpu() if isinstance(x, torch.Tensor) else x


def check_sample(what, results, ref):
    """Every rank's observables == the one-process run's; rank 0's final
    planes too, the others' None."""
    for r, res in enumerate(results):
        got = res[what]["out"]
        if not (torch.equal(got["magnetization"], ref["magnetization"])
                and torch.equal(got["energy"], ref["energy"])):
            raise AssertionError(f"{what}: rank {r}'s observables != the one-process run's")
        planes = got["final_planes"]
        if r == 0 and not all(torch.equal(_cpu(a), _cpu(b))
                              for a, b in zip(planes, ref["final_planes"])):
            raise AssertionError(f"{what}: rank 0's final planes != the one-process run's")
        if r and planes is not None:
            raise AssertionError(f"{what}: rank {r} returned final planes")


def phase_multiprocess(dev, workdir):
    """Phase 41; returns (launches of K1, K2 and K3 summed over the ranks
    per path, the slice's numbers)."""
    from tsu_tpu_torch.tools.multiprocess_check import run_case

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    snapshot = os.path.join(workdir, "two_ranks.pt")
    rows4 = dict(QUICK_START, name="quick start, 4 ranks x 1 row shard", mesh={"rows": 4})
    grid22 = dict(QUICK_START, name="quick start, 4 ranks in 2 x 2",
                  mesh={"rows": 2, "cols": 2})
    pt = dict(name=f"replica-sharded tempering {PT_RUNGS} x {PT_SHAPE}, 4 ranks",
              kind="tempering", shape=list(PT_SHAPE), seed=0, mesh={"replica": 4},
              temperatures=[1.8, 3.0, PT_RUNGS], n_samples=200, swap_interval=10, n_burnin=100)
    smc = dict(name=f"annealed_smc_sharded {SMC_SIZE[0]} x {SMC_SIZE[1]}, 4 ranks", kind="smc",
               particles=list(SMC_SIZE), seed=8, mesh={"chains": 4}, n_steps=50)
    # Rank 0 counts its host launch calls under the profiler over a shorter
    # run (the profiler slows an eager loop several times over).
    smc_counted = dict(smc, name=smc["name"] + ", 10 steps under the profiler", n_steps=10,
                       count_host_launches=True)
    two = dict(QUICK_START, name="quick start, 2 ranks x 2 row shards",
               mesh={"rows": 4, "ranks": [0, 0, 1, 1]})
    stop = dict(two, name="quick start checkpointed on 2 ranks, stopped after 2 samples",
                checkpoint={"path": snapshot, "every": 2, "stop_after_first": True})
    four, wall4 = run_ranks(4, [rows4, grid22, pt, smc, smc_counted], workdir, "four")
    pairs, wall2 = run_ranks(2, [two, stop], workdir, "two")
    pod_dir = os.path.join(workdir, "pod_scaling")
    wall_pod = torchrun(4, ["-m", "tsu_tpu_torch.tools.pod_scaling", pod_dir], "pod_scaling")

    refs = {c["name"]: run_case(c, dev)["out"] for c in (rows4, grid22, pt, smc)}
    check_sample(rows4["name"], four, refs[rows4["name"]])
    check_sample(grid22["name"], four, refs[grid22["name"]])
    check_sample(two["name"], pairs, refs[rows4["name"]])
    for r, res in enumerate(four):
        got, ref = res[pt["name"]]["out"], refs[pt["name"]]
        if not (all(np.array_equal(got[k], ref[k]) for k in
                    ("magnetization", "energy", "rungs", "final_rungs"))
                and got["swap_accepts"] == ref["swap_accepts"]):
            raise AssertionError(f"replica-sharded tempering: rank {r} != the one-process run")
        got, ref = res[smc["name"]]["out"], refs[smc["name"]]
        if not (all(np.array_equal(got[k], ref[k]) for k in
                    ("particles", "log_weights", "ess_history")) and got["log_Z"] == ref["log_Z"]):
            raise AssertionError(f"annealed_smc_sharded: rank {r} != annealed_smc_sharded in one "
                                 "process")
    log("phase 41: on every rank the quick start on 4 x 1, 2 x 2 and 2 ranks x 2 row shards "
        "(observables; rank 0's final planes), the tempering (observables, rungs, swaps) and the "
        "SMC (particles, log-weights, ESS, log Z) == the one-process runs bit for bit")
    if not all(res[stop["name"]]["out"] == "stopped" for res in pairs):
        raise AssertionError("the checkpointed two-rank run did not stop after its snapshot")
    resumed = run_case(dict(two, checkpoint={"path": snapshot, "every": 2, "resume": True}),
                       dev)["out"]
    check_sample("resumed", [{"resumed": {"out": resumed}}], refs[rows4["name"]])
    log("phase 41: a run checkpointed on 2 ranks and resumed in one process == the "
        "uninterrupted run")

    sweeps = QUICK_START["n_burnin"] + QUICK_START["n_samples"] * QUICK_START["n_sweeps"]
    want = {rows4["name"]: (4 * sweeps, 0, 0), grid22["name"]: (0, 0, 4 * 2 * sweeps),
            pt["name"]: (0, 4 * 300, 0), smc["name"]: (0, 0, 0), smc_counted["name"]: (0, 0, 0),
            two["name"]: (4 * sweeps, 0, 0),
            stop["name"]: (4 * (QUICK_START["n_burnin"] + 2 * QUICK_START["n_sweeps"]), 0, 0)}
    launches, numbers = {}, {}
    for results, cases in ((four, (rows4, grid22, pt, smc, smc_counted)), (pairs, (two, stop))):
        for c in cases:
            runs = [res[c["name"]] for res in results]
            got = tuple(sum(r["launches"][k] for r in runs) for k in ("K1", "K2", "K3"))
            launches[c["name"]] = got
            if got != want[c["name"]]:
                raise AssertionError(f"{c['name']}: launches (K1, K2, K3) {got}, want "
                                     f"{want[c['name']]}")
            ex = [r["exchange"] for r in runs]
            wall = max(r["seconds"] for r in runs)
            numbers[c["name"]] = {
                "wall_s": wall, "launches_K1_K2_K3": got,
                "exchanges_per_rank": [e["calls"] for e in ex],
                "bytes_sent_per_rank": [e["bytes"] for e in ex],
                # Each rank's exchanges by size: calls of (messages, bytes sent).
                "exchanges_by_size_per_rank": [
                    {f"{m} messages, {b} B": n for (m, b), n in sorted(e["sizes"].items())}
                    for e in ex]}
            if c["kind"] == "sample":
                done = sweeps if "checkpoint" not in c else sweeps - 2 * QUICK_START["n_sweeps"]
                numbers[c["name"]]["wall_ms_per_sweep_setup_included"] = wall * 1e3 / done
            if c is smc_counted:
                numbers[c["name"]]["host_launches_per_step_rank0"] = (
                    runs[0]["out"]["host_launches"] / c["n_steps"])
            log(f"phase 41: {c['name']}: wall {wall:.3f} s (the slowest rank); "
                f"launches (K1, K2, K3) summed over the ranks {got}; "
                + ", ".join(f"{k} {v}" for k, v in numbers[c["name"]].items()
                            if k not in ("wall_s", "launches_K1_K2_K3")))
    shared = torch.cuda.device_count() < 4            # the backend rule's choice
    backend = "gloo" if shared else "nccl"
    with open(os.path.join(pod_dir, f"scaling_{backend}4_h1.json")) as f:
        pod = json.load(f)
    if ((pod["topology"]["n_processes"], pod["topology"]["n_hosts"], pod["topology"]["backend"])
            != (4, 1, backend) or (pod["lattice"]["efficiency"] is None) != shared):
        raise AssertionError(f"pod_scaling's topology {pod['topology']}")
    lat = pod["lattice"]
    log(f"phase 41: pod_scaling on 4 ranks over {backend} ({wall_pod:.1f} s with torchrun): "
        f"topology {pod['topology']}; chains {pod['chains']}; lattice {lat}")
    per_sweep = {k: lat[k]["time_s"] * 1e3 / lat["n_sweeps"] for k in ("1_device", "all_devices")}
    log(f"phase 41: host ms per sharded sweep of a 1024 x 4096 shard a rank, between barriers "
        f"({lat['n_sweeps']} sweeps a call): 1 rank {per_sweep['1_device']:.6f}, 4 ranks over "
        f"{backend} {per_sweep['all_devices']:.6f}")
    numbers.update(torchrun_wall_s={"4 ranks": wall4, "2 ranks": wall2, "pod_scaling": wall_pod},
                   pod_scaling=pod, host_ms_per_sweep_1024x4096_shard=per_sweep,
                   seconds=time.perf_counter() - t_phase)
    return launches, numbers


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    name = card()
    log(name)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        list(pool.map(lambda build: build(), (_build.fused_sweep_library,
                                              _build.bond_sweep_library,
                                              _build.resident_sweep_library,
                                              resident_bodies.gridstride_library,
                                              _build.halfsweep_library,
                                              halfsweep_bodies.scalar_library)))
    log("phase 1: built the fused-sweep, the bond, the resident (and its grid-stride body) and "
        f"the half-sweep (and its first body) kernels in {time.perf_counter() - t0:.2f} s")

    gen = torch.Generator().manual_seed(0)
    cgen = torch.Generator(device=dev).manual_seed(0)
    err = 0.0
    for shape, dtype, periodic in ((MAIN_SHAPE, torch.bfloat16, True),
                                   ((1002, 1000), torch.float32, False),
                                   (RAGGED_SHAPE, torch.bfloat16, False),
                                   (RAGGED_SHAPE, torch.bfloat16, True)):
        black = random_black(gen, shape, dtype, dev)
        U = torch.randint(0, 1 << 16, (3, 2, shape[0], shape[1] // 2),
                          generator=cgen, device=dev, dtype=torch.int32)
        err = max(err, compare_chains(black, SCHEDULE, periodic, U))
        log(f"phase 2: injected uniforms, {shape} {dtype} periodic={periodic}: "
            "kernel == plain over 3 sweeps")
        del U
    for shape in (MAIN_SHAPE, RAGGED_SHAPE):
        black = random_black(gen, shape, torch.bfloat16, dev)
        err = max(err, compare_chains(black, SCHEDULE[:2], True, seed=11))
        log(f"phase 3: Philox mode, {shape} bf16: kernel == plain over 2 sweeps")

    phase_statistics(dev)
    log("phase 4: statistics agree with the exact references")

    launches = phase_main_path(dev)
    log("phase 5: main path ran through the kernel")

    ms, graph1_ms, plain_ms = phase_timing(dev, name)
    log("phase 6: timed")

    err2 = phase_batched_exact(dev, gen, cgen)
    log("phase 7: batched kernel == plain version and == the single-lattice kernel")

    phase_batched_statistics(dev)
    log("phase 8: batched statistics agree with the exact references")

    launches2 = phase_batched_paths(dev)
    log("phase 9: the batched paths ran through the batched kernel")

    ms2, graph2_ms, plain_ms2 = phase_timing_batched(dev, name)
    log("phase 10: timed")

    err4, n_band, n_differ, err5 = phase_bond_exact(dev, gen, cgen)
    log("phase 11: K4 and K5 == their plain versions (K4 continuous outside the band)")

    phase_bond_statistics(dev)
    log("phase 12: spin-glass statistics agree with the exact references")

    launches4, launches5 = phase_bond_paths(dev)
    log("phase 13: the spin-glass paths ran through K4 and K5")

    bond_times = phase_bond_timing(dev, name)
    log("phase 14: timed")

    err6, err7, err8 = phase_resident_exact(dev, gen, cgen)
    log("phase 15: K6, K7 and the K8 variants == their plain versions")

    phase_resident_statistics(dev)
    log("phase 16: resident statistics agree with the exact references and with K1")

    _, _, dec, (launches6, launches7, launches8) = phase_tools(dev)
    log("phase 17: the tools and the resident anneal ran through K6, K7 and K8")

    rt = phase_resident_timing(dev, name, ms, plain_ms, dec)
    log("phase 18: timed")

    err3, n_band3, n_differ3, err1s = phase_halfsweep_exact(dev, gen, cgen)
    log("phase 19: K3 == its plain version outside the band, K1's shard mode == its plain version")

    phase_sharded_exact(dev, gen)
    log("phase 20: sharded runs == the one-shard runs")

    phase_sharded_statistics(dev)
    log("phase 21: sharded statistics agree with the exact references")

    launches1s, launches2s, launches3 = phase_sharded_paths(dev)
    log("phase 22: the sharded paths ran through K1's shard mode, K3 and K2")

    st = phase_sharded_timing(dev, name)
    log("phase 23: timed")

    t_slice4 = time.perf_counter()
    phase_dense_statistics(dev)
    log("phase 24: dense statistics on the card agree with exact enumeration")

    graph_check = phase_dense_graph(dev)
    log("phase 25: the graphed colour sweep == the eager one outside the band")

    dense = phase_dense_paths(dev, name)
    log("phase 26: the dense paths ran at full width")

    sparse = phase_maxcut_sparse(dev)
    log("phase 27: maxcut_sparse reached the native greedy bound")

    with tempfile.TemporaryDirectory(dir=str(_build.BUILD_DIR.parent)) as workdir:
        phase_resume(dev, workdir)
    log("phase 28: four resumed runs == their uninterrupted runs on the card")
    slice4_s = time.perf_counter() - t_slice4
    log(f"phases 24-28 added {slice4_s:.1f} s")
    log("slice 4: " + json.dumps({"graph_check": graph_check, "dense": dense, "sparse": sparse,
                                  "seconds": slice4_s, "card": name}))

    t_slice5 = time.perf_counter()
    exact = phase_continuous_exact(dev)
    log("phase 29: every continuous step loop's graph == its eager loop bit for bit, and the "
        "card == the CPU on the same draws")

    stat_routes = phase_continuous_statistics(dev)
    log("phase 30: continuous statistics on the card agree with the exact answers")

    paths5 = phase_continuous_paths(dev)
    log("phase 31: the continuous paths ran at their users' sizes, every one on its graphs")

    timing5 = phase_continuous_timing(dev, name)
    log("phase 32: timed")
    slice5_s = time.perf_counter() - t_slice5
    log(f"phases 29-32 added {slice5_s:.1f} s")
    log("slice 5: " + json.dumps({"exact_max_abs_diff": exact, "statistics_routes": stat_routes,
                                  "paths": paths5, "ms_per_step": timing5,
                                  "seconds": slice5_s, "card": name}))

    t_slice6 = time.perf_counter()
    bnn_exact = phase_bnn_exact(dev)
    log("phase 33: the BNN loops' graphs == their eager loops bit for bit, the card == the CPU "
        "on the same draws")

    ml_suite = phase_ml_suite(dev)
    log("phase 34: the ML suite at full size is in its bands on its graphs; bnn_dp split == one "
        "device")

    matched = phase_lattice_matched(dev)
    log("phase 35: lattice_matched ran K1 (the quick runner's checks run in phase 37, on the "
        "CLI's bench --quick)")

    timing6 = phase_bnn_timing(dev, name)
    log("phase 36: timed")
    slice6_s = time.perf_counter() - t_slice6
    log(f"phases 33-36 added {slice6_s:.1f} s")
    log("slice 6: " + json.dumps({"exact_max_abs_diff": bnn_exact, "ml_suite": ml_suite,
                                  "lattice_matched": matched, "ms_per_step": timing6,
                                  "seconds": slice6_s, "card": name}, default=float))

    slice7 = run_slice7(dev, name)

    with tempfile.TemporaryDirectory(dir=str(_build.BUILD_DIR.parent)) as workdir:
        slice8, numbers8 = phase_multiprocess(dev, workdir)
    log("phase 41: under torchrun, 4 ranks (and 2) ran the quick start "
        "(K1's shard mode, K3), replica-sharded tempering (K2), the sharded SMC and "
        "pod_scaling, each == the one-process run")
    log(f"phase 41 added {numbers8['seconds']:.1f} s")
    log("slice 8: " + json.dumps({**numbers8, "card": name}, default=float))

    def slice8_launches(k):
        """Slice 8's paths that launched kernel k, summed over their ranks."""
        i = ("K1", "K2", "K3").index(k)
        return {path: got[i] for path, got in slice8.items() if got[i]}

    def slice7_launches(k):
        """This slice's paths that launched kernel k, with their launches."""
        i = NAMES.index(k)
        return {path: got[i] for path, got in slice7.items() if got[i]}

    R, C2 = MAIN_SHAPE[0], MAIN_SHAPE[1] // 2
    site = R * C2                                     # compact sites of one 4096^2 plane
    B, Rb, Cb = ENSEMBLE
    batched_site = B * Rb * Cb // 2
    ladder_site = LADDER_BATCH * PT_SHAPE[0] * PT_SHAPE[1] // 2
    pt_site = PT_RUNGS * PT_SHAPE[0] * PT_SHAPE[1] // 2
    ragged_site = RAGGED_SHAPE[0] * RAGGED_SHAPE[1] // 2
    S = RESIDENT_SWEEPS
    fused = "tsu_tpu_torch/csrc/checkerboard_fused.cu"
    shard_site = SHARD[0] * SHARD[1] // 2
    k3_shard_site = site // 4                         # a 2 x 2 mesh's shard: 2048 x 1024 compact
    bonds = "tsu_tpu_torch/csrc/checkerboard_bonds.cu"
    resident = "tsu_tpu_torch/csrc/checkerboard_resident.cu"

    def entry(name_, source, replaces, n, e, t, plain_t, n_bytes, **extra):
        """One kernel of the JSON line; bound_ms from the bytes the work must
        move (each input read once, each output written once)."""
        return {"name": name_, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": e, "ms": t, "plain_ms": plain_t,
                "bound_ms": bound_ms(n_bytes), "bound_by": "bytes", "library_ms": None,
                **extra}

    def resident_extra(k):
        """K6/K7 are bound by operations, not bytes: one Philox call per
        group of four compact sites per half-step, PHILOX_INT32 int32
        instructions each, over the card's int32 rate; the byte bound (both
        planes once per call of S sweeps) stays beside it."""
        ops = 2 * R * -(-C2 // 4) * PHILOX_INT32
        return {"bound_ms": ops / INT32_OPS_PER_S * 1e3, "bound_by": "operations",
                "bytes_bound_ms": bound_ms((4 * 2 * site + 9 * 4 * (S if k == "K7" else 1)) / S),
                "gridstride_ms": rt[f"{k} gridstride"], "runs_ms": rt[f"{k} runs"],
                "barrier_ms": rt["barrier"], "grid": rt["grid"]}

    # Bytes a unit of work must move: K1 and K2 read black and write red and
    # black (2 B each at bf16) per sweep, K1's shard mode also its four halo
    # rows; K3 reads the other plane and its two halo rows (a shard also its
    # two halo columns) and writes its colour (4 B each at f32) per
    # half-sweep; K4 reads the other plane and a code
    # byte and writes its colour per half-sweep, K5 the same with the codes
    # shared by the batch; K6 and K7 read and write both planes once per call
    # of S sweeps (per sweep: / S) and K7 reads a 9-entry table per sweep; a
    # K8 variant writes both planes and (nomath) reads black.
    dec_bytes = {"prng_only": 2 * 2 * site, "prng_grouped": 2 * 2 * site,
                 "nomath": 3 * 2 * site}
    print(json.dumps({"kernels": [
        entry("fused_sweep", fused, "tsu_tpu/ops/checkerboard_fused.py:136", launches,
              max(err, err1s), ms, plain_ms, 3 * 2 * site + 9 * 4, graph_ms=graph1_ms,
              shard_launches=launches1s, shard_ms=st["K1 shard"],
              shard_plain_ms=st["K1 shard plain"],
              shard_bound_ms=bound_ms(3 * 2 * shard_site + 4 * 2 * SHARD[1] // 2 + 9 * 4),
              slice7_launches=slice7_launches("K1"), slice8_launches=slice8_launches("K1")),
        entry("fused_sweep_batched", fused, "tsu_tpu/ops/checkerboard_fused.py:494", launches2,
              err2, ms2, plain_ms2, 3 * 2 * batched_site + B * 11 * 4, graph_ms=graph2_ms,
              replica_sharded_launches=launches2s, slice7_launches=slice7_launches("K2"),
              slice8_launches=slice8_launches("K2")),
        entry("halfsweep", "tsu_tpu_torch/csrc/checkerboard_halfsweep.cu",
              "tsu_tpu/ops/checkerboard_pallas.py:79", launches3, err3, st["K3"], st["K3 plain"],
              2 * 4 * site + 2 * 4 * MAIN_SHAPE[1] // 2, band_sites=n_band3,
              band_differ=n_differ3, bf16_ms=st["K3 bf16"],
              bf16_bound_ms=bound_ms(2 * 2 * site + 2 * 2 * MAIN_SHAPE[1] // 2),
              shard_ms=st["K3 shard"],
              shard_bound_ms=bound_ms(2 * 4 * k3_shard_site
                                      + 4 * (MAIN_SHAPE[1] // 2 + MAIN_SHAPE[0])),
              previous_ms=st["K3 first"], previous_bf16_ms=st["K3 bf16 first"],
              previous_shard_ms=st["K3 shard first"],
              previous_source="tsu_tpu_torch/csrc/checkerboard_halfsweep_scalar.cu",
              runs_ms={k[5:]: st[k] for k in st if k.startswith("this ")},
              previous_runs_ms={k[6:]: st[k] for k in st if k.startswith("first ")},
              host_ms_per_sharded_sweep={"rows 4 (K1)": st["host 4x1"],
                                         "2 x 2 (K3)": st["host 2x2"]},
              slice7_launches=slice7_launches("K3"), slice8_launches=slice8_launches("K3")),
        entry("bond_halfsweep", bonds, "tsu_tpu/ops/checkerboard_bonds_pallas.py:71", launches4,
              err4, bond_times["K4 discrete"][0], bond_times["K4 discrete"][2],
              5 * site + 9 * 4,
              continuous_ms=bond_times["K4 continuous"][0],
              continuous_plain_ms=bond_times["K4 continuous"][2],
              continuous_bound_ms=bound_ms(7 * 4 * site),
              continuous_band_sites=n_band, continuous_band_differ=n_differ,
              ms_4096x4094=bond_times["K4 discrete 4096x4094"][0],
              plain_ms_4096x4094=bond_times["K4 discrete 4096x4094"][2],
              bound_ms_4096x4094=bound_ms(5 * ragged_site + 9 * 4),
              slice7_launches=slice7_launches("K4")),
        entry("bond_halfsweep_batched", bonds, "tsu_tpu/ops/checkerboard_bonds_pallas.py:320",
              launches5, err5, bond_times["K5 discrete"][0], bond_times["K5 discrete"][2],
              4 * ladder_site + PT_SHAPE[0] * PT_SHAPE[1] // 2 + LADDER_BATCH * 11 * 4,
              ms_64x256x256=bond_times["K5 discrete 64 x 256^2"][0],
              plain_ms_64x256x256=bond_times["K5 discrete 64 x 256^2"][2],
              bound_ms_64x256x256=bound_ms(4 * pt_site + PT_SHAPE[0] * PT_SHAPE[1] // 2
                                           + PT_RUNGS * 11 * 4),
              slice7_launches=slice7_launches("K5")),
        entry("resident_sweeps", resident, "tsu_tpu/ops/checkerboard_resident.py:56", launches6,
              err6, rt["K6"], rt["K6 plain"], (4 * 2 * site + 9 * 4) / S, **resident_extra("K6")),
        entry("resident_anneal", resident, "tsu_tpu/ops/checkerboard_resident.py:219", launches7,
              err7, rt["K7"], rt["K7 plain"], (4 * 2 * site + S * 9 * 4) / S,
              **resident_extra("K7")),
        entry("decomposition_sweep", fused, "scripts/kernel_decomposition.py:41", launches8,
              err8, dec["ms_per_sweep"]["prng_only"], rt["K8 prng_only plain"],
              dec_bytes["prng_only"],
              modes={m: {"ms": dec["ms_per_sweep"][m], "plain_ms": rt[f"K8 {m} plain"],
                         "bound_ms": bound_ms(dec_bytes[m])} for m in MODES},
              baseline_ms=dec["ms_per_sweep"]["baseline"],
              share_of_baseline=dec["share_of_baseline"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
