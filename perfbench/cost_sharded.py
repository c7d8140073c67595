"""The least bytes of the sharded lattice's draw (K12) and observables (K11's
shard mode), and their shares of the traced window's time: the yardsticks
of ``draw_roofline_pct.sharded`` and ``observables_roofline_pct.sharded``.

A draw writes each site's spin once (both planes, the spin's bytes a site)
and reads nothing. A sample's observables read both planes once; the black
halo rows each shard also reads are a few rows of a shard's thousands and
are left out. The bytes are the whole lattice's, the time the kernels'
device time summed over every card of the mesh, and the bandwidth one
card's: the share is the lattice's least time on one card over the sum of
the cards' times, as ``cost.sweep_roofline_pct`` reads the sharded sweep.
"""

from __future__ import annotations

from perfbench.cost import SPIN_BYTES, peak


def plane_bytes(config: dict) -> float:
    """Bytes of one lattice's red and black planes."""
    rows, cols = config["shape"]
    return rows * cols * SPIN_BYTES[config["spin_dtype"]]


def kernel_roofline_pct(run, patterns, bytes_a_call: float):
    """100 x the least time of the traced window's calls (``bytes_a_call``
    each, over the card's HBM bandwidth) over the device time of the
    kernels whose names hold any of ``patterns``; None when none ran, or the
    card is not in the table."""
    trace = run.trace
    bandwidth = peak(run.device_kind, "hbm_bytes_per_s")
    if trace is None or bandwidth is None:
        return None
    count, us = trace.kernels_us(patterns)
    if not count or us <= 0:
        return None
    return 100.0 * run.calls * bytes_a_call / bandwidth / (us / 1e6)
