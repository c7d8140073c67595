"""sweep_roofline_pct.bonds (device trace): the bond half-sweeps (K4 and
the batched K5, csrc/checkerboard_bonds.cu) against the least time of the
sweeps the traced window did, bond planes read once a sweep."""

from perfbench.cost import sweep_roofline_pct

KERNELS = ("bond_halfsweep",)


def read(run):
    return sweep_roofline_pct(run, KERNELS)
