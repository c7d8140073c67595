"""sweep_roofline_pct.sharded (device trace): K1's shard mode
(fused_sweep_shard_kernel, csrc/checkerboard_fused.cu) summed over the
mesh's cards, against the least time of the whole lattice's sweeps in the
traced window at one card's HBM bandwidth."""

from perfbench.cost import sweep_roofline_pct

KERNELS = ("fused_sweep_shard",)


def read(run):
    return sweep_roofline_pct(run, KERNELS)
