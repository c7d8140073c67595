"""The dense sweep's route on the card, as a pure function of the plan's
widest colour, the chain count and the kernel's blocks that the card runs
at once (none for a plan that no block holds), and the fused kernel's
wrapper checks, on the CPU (the kernel itself runs in test_torch_gpu.py)."""

import numpy as np
import pytest
import torch

from tsu_tpu_torch import profiling
from tsu_tpu_torch.ops.dense_sweep_kernel import (
    SMEM_OPTIN,
    blocks_at_once,
    dense_colour_sweep,
    geometry,
    smem_bytes,
)
from tsu_tpu_torch.samplers.gibbs import ColourPlan, DenseSweeper, color_groups, dense_route


def _widest(J) -> int:
    return int((color_groups(J) < len(J)).sum(axis=1).max())


def _maxcut_g2000():
    """G(2000, 0.5) as chip_smoke.py's phase 26 draws it."""
    rng = np.random.default_rng(2000)
    W = np.triu((rng.random((2000, 2000)) < 0.5).astype(np.float32), 1)
    return W + W.T


def _torus(rows, cols):
    J = np.zeros((rows * cols, rows * cols), np.float32)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for j in (((r + 1) % rows) * cols + c, r * cols + (c + 1) % cols):
                J[i, j] = J[j, i] = 1.0
    return J


# The K10 blocks an H100 80GB HBM3 runs at once (blocks_at_once), by the
# plan's sites: a block an SM at 4,096, two at 2,000, twelve at 96.
H100_SLOTS = {4096: 132, 2000: 264, 96: 1584}


def _slots(widest, n):
    """An H100's slots for a plan that a block holds; else blocks_at_once's
    0, which it gives before asking any card."""
    if geometry(n, widest) is not None:
        return H100_SLOTS[n]
    slots = blocks_at_once(n, widest, "cuda")
    assert slots == 0
    return slots


@pytest.mark.parametrize("widest,n,chains", [
    (1, 4096, 64),      # the SK cell: a site a colour, 64 rungs
    (1, 4096, 8),       # IsingModel(4096) with SK couplings
    (1, 96, 3),         # the sequential route
    (1, 4096, 1),       # one chain
    ("g2000", 2000, 8),  # optimize(MaxCutProblem) on G(2000, 0.5)
    (64, 4096, 64),     # the widest colour the kernel takes, in one wave of blocks
    (16, 4096, 528),    # colours of 16 in four waves: 5.0 against 10.7 ms a sweep
    (1, 4096, 4096),    # SK in 32 waves: 74.9 against 166.1 ms
], ids=["sk-cell", "sk-model", "sequential", "one-chain", "maxcut-g2000", "widest",
        "w16-four-waves", "sk-32-waves"])
def test_route_rule_sends_narrow_colours_to_the_fused_kernel(widest, n, chains):
    if widest == "g2000":
        widest = _widest(_maxcut_g2000())
        assert 10 < widest < 64          # a greedy colouring of G(2000, 1/2)
    assert dense_route(widest, chains, _slots(widest, n)) == "fused"


@pytest.mark.parametrize("widest,n,chains", [
    ("torus", 63 * 65, 8),     # a 63 x 65 periodic grid's dense fall-back: three wide colours
    (1, 4097, 8),              # more sites than a block takes
    (1, 20_000, 1),
    (2048, 4096, 1),           # partial sums too wide for shared memory
    (128, 4096, 8),            # one matrix product a colour beats 128 block-wide sums
    (64, 4096, 4096),          # 64 wide, but 32 waves of blocks: 34.5 against 9.1 ms a sweep
    (64, 4096, 528),           # four waves: 4.3 against 2.8 ms
    (16, 4096, 4096),          # 32 waves: 39.9 against 29.4 ms
], ids=["grid-63x65", "too-many-sites", "far-too-many-sites", "too-wide", "wide", "many-waves",
        "w64-four-waves", "w16-32-waves"])
def test_route_rule_keeps_wide_or_large_plans_on_the_graph(widest, n, chains):
    if widest == "torus":
        widest = _widest(_torus(63, 65))
        assert widest > 1000
    assert dense_route(widest, chains, _slots(widest, n)) == "graph"


@pytest.mark.parametrize("n", [1, 3, 96, 301, 2000, 2049, 4095, 4096])
@pytest.mark.parametrize("widest", [1, 16])
def test_fused_geometry_covers_every_column_within_the_cards_limits(n, widest):
    geom = geometry(n, widest)
    ldj = -(-n // 4) * 4
    assert geom.threads in (128, 256, 512) and geom.chunks in (1, 2)
    assert 4 * geom.threads * geom.chunks >= ldj
    assert geom.smem == smem_bytes(geom.threads, geom.chunks, widest, n) <= SMEM_OPTIN


@pytest.mark.parametrize("n,widest", [(4097, 1), (8192, 1), (4095, 1365)])
def test_fused_geometry_refuses_what_no_block_holds(n, widest):
    assert geometry(n, widest) is None


class _Plan:
    """A plan that gives the wrapper the operands it is handed."""

    def __init__(self, J, h, diag, ends, widest=1):
        self.operands = (J, h, diag, ends, widest)

    def fused_operands(self):
        return self.operands


def _operands(n=8, chains=2, **change):
    ops = {"states": torch.zeros((chains, n)), "u": torch.zeros((chains, n)),
           "T": torch.ones((chains, 1)), "J": torch.zeros((n, n)), "h": torch.zeros(n),
           "diag": torch.zeros(n), "ends": torch.arange(1, n + 1, dtype=torch.int32)}
    ops.update(change)
    return ops


@pytest.mark.parametrize("change,match", [
    ({}, "CUDA"),
    ({"states": torch.zeros((2, 8), dtype=torch.float64)}, "float32"),
    ({"u": torch.zeros((2, 8), dtype=torch.float16)}, "float32"),
    ({"ends": torch.arange(1, 9, dtype=torch.int64)}, "int32"),
    ({"states": torch.zeros((8, 2)).t()}, "contiguous"),
    ({"J": torch.zeros((8, 16))[:, :8]}, "contiguous"),
    ({"h": torch.zeros(7)}, r"\(8,\)"),
], ids=["cpu", "states-f64", "u-f16", "ends-i64", "states-strided", "J-strided", "h-short"])
def test_fused_kernel_wrapper_rejects_what_it_cannot_take(change, match):
    ops = _operands(**change)
    plan = _Plan(ops["J"], ops["h"], ops["diag"], ops["ends"])
    launched = dense_colour_sweep.launches
    with pytest.raises(ValueError, match=match):
        dense_colour_sweep(plan, ops["states"], ops["u"], ops["T"])
    assert dense_colour_sweep.launches == launched


def test_fused_kernel_wrapper_takes_a_plans_own_operands():
    """The wrapper reads J, h, diag, the ends and the widest colour from
    the plan itself, so the caller cannot hand it ends that disagree with
    the widest colour; on the CPU it then refuses the tensors' device."""
    J = np.triu(np.random.default_rng(1).choice([-1.0, 1.0], (8, 8)), 1)
    plan = ColourPlan(J + J.T, np.zeros(8), device="cpu")
    launched = dense_colour_sweep.launches
    with pytest.raises(ValueError, match="CUDA"):
        dense_colour_sweep(plan, torch.zeros((2, 8)), torch.zeros((2, 8)), torch.ones((2, 1)))
    assert plan._fused is not None and plan._fused[4] == plan.widest
    assert dense_colour_sweep.launches == launched


def test_sweeps_on_the_cpu_stay_eager_and_count_no_fused_sweep():
    rng = np.random.default_rng(0)
    J = np.triu(rng.choice([-4.0, 4.0], (12, 12)), 1).astype(np.float32)
    plan = ColourPlan(J + J.T, np.zeros(12), device="cpu")
    sweeper = DenseSweeper(plan, 3, 1)
    assert sweeper.route == "eager"
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        sweeper.run(2)
    counts = profiling.counters()
    assert counts["dense.colour_steps"] == 2 * plan.n_colors
    assert "dense.fused_sweeps" not in counts and "dense.captures" not in counts


@pytest.mark.parametrize("n", [5, 8])
def test_fused_operands_pad_rows_to_four_columns_with_zeros(n):
    rng = np.random.default_rng(n)
    J = np.triu(rng.normal(size=(n, n)), 1).astype(np.float32)
    plan = ColourPlan(J + J.T, np.ones(n), sequential=True, device="cpu")
    Jk, h, diag, ends, widest = plan.fused_operands()
    assert Jk.shape == (n, -(-n // 4) * 4) and Jk.is_contiguous()
    assert torch.equal(Jk[:, :n], plan.J) and not Jk[:, n:].any()
    assert ends.tolist() == list(range(1, n + 1)) and ends.dtype == torch.int32
    assert widest == 1 and h is plan.h and diag is plan.diag
