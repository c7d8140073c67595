"""The least bytes a sweep moves, and the table of peaks: the yardstick of
the roofline shares.

A sweep of a lattice resamples both colours by the heat-bath rule. The new
red half depends only on the black half, so the sweep needs the black half
read once and both halves written once: 3/2 x sites x the spin's bytes. Bond
planes, shared by every replica of a batch, are read once a sweep, at one
bit a bond (two bonds a site) for ±J bonds. Counts are what the traffic
needs, never what a kernel moves.
"""

from __future__ import annotations

import json
from pathlib import Path

SPIN_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
BOND_BITS = {"pm1": 1}


def sweep_bytes(config: dict, lattices: int) -> float:
    """Least bytes of one sweep of ``lattices`` lattices of ``config``."""
    rows, cols = config["shape"]
    sites = rows * cols
    total = 1.5 * sites * SPIN_BYTES[config["spin_dtype"]] * lattices
    if "bonds" in config:
        total += 2 * sites * BOND_BITS[config["bonds"]] / 8
    return total


def peak(kind: str, key: str):
    """The peak ``key`` of the card named ``kind``; None for a card the
    table does not hold."""
    with open(Path(__file__).with_name("peaks.json")) as f:
        return json.load(f).get(kind, {}).get(key)


def sweep_roofline_pct(run, patterns) -> float | None:
    """100 x the least time of the traced window's sweeps (their bytes over
    the card's HBM bandwidth) over the device time of the kernels whose
    names hold any of ``patterns``; None when none ran or the card is not
    in the table, which fails a run whose cell the metric lists.

    The bandwidth is HBM's. A lattice whose planes fit in the L2
    (``l2_bytes``) can be swept faster than HBM allows: for it the share
    is a yardstick against HBM, not a true roofline, and would pass 100%
    once a kernel beat HBM's time. Only a lattice beyond the L2 reads a
    true roofline here."""
    trace = run.trace
    bandwidth = peak(run.device_kind, "hbm_bytes_per_s")
    if trace is None or bandwidth is None:
        return None
    count, us = trace.kernels_us(patterns)
    if not count or us <= 0:
        return None
    sweeps = run.calls * run.work["sweeps"]
    least_s = sweeps * sweep_bytes(run.cell.config, run.work["lattices"]) / bandwidth
    return 100.0 * least_s / (us / 1e6)
