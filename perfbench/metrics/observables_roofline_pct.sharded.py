"""observables_roofline_pct.sharded (device trace): K11's shard mode
(plane_sums_kernel, csrc/plane_observables.cu) summed over the mesh's
cards, against the least time of reading the whole lattice's planes once a
sample at one card's HBM bandwidth."""

from perfbench import spans
from perfbench.cost_sharded import kernel_roofline_pct, plane_bytes

KERNELS = ("plane_sums_kernel",)


def read(run):
    n_samples = spans.params(run).get("n_samples")
    if not n_samples:
        return None
    return kernel_roofline_pct(run, KERNELS, n_samples * plane_bytes(run.cell.config))
