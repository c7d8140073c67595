"""sweep_roofline_pct.uniform (device trace): the uniform-coupling fused
sweep (K1 and its batched and shard forms, csrc/checkerboard_fused.cu)
against the least time of the sweeps the traced window did."""

from perfbench.cost import sweep_roofline_pct

KERNELS = ("fused_sweep",)


def read(run):
    return sweep_roofline_pct(run, KERNELS)
