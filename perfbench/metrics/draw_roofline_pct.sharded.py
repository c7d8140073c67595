"""draw_roofline_pct.sharded (device trace): K12, the start drawn on the
cards (lattice_draw_kernel, csrc/lattice_draw.cu), summed over the mesh's
cards, against the least time of writing the whole lattice's planes once a
call at one card's HBM bandwidth."""

from perfbench.cost_sharded import kernel_roofline_pct, plane_bytes

KERNELS = ("lattice_draw_kernel",)


def read(run):
    return kernel_roofline_pct(run, KERNELS, plane_bytes(run.cell.config))
