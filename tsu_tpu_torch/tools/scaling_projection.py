"""Multi-card weak-scaling projection from one card's measurements.

The N-card rows of a sharded lattice cannot be measured on one card, so
this tool projects them from measured quantities and published link rates,
with the method written down (the counterpart of
``scripts/scaling_projection.py``, the same arithmetic):

  1. MEASURED: the sharded lattice path's time per sweep on one card at
     4096^2 bf16 (``benchmarks.scaling.measure_lattice_matched``: K1 in
     shard mode on a one-device mesh, halo assembly included), and the
     host's cost of one halo copy on that card (``copy_latency_s``), which
     stands for the per-exchange latency.
  2. ANALYTIC: halo traffic per sweep per shard boundary is 2 boundary rows
     x C/2 compact columns x itemsize x 2 directions (K1's shard mode reads
     2-row black halos; uniforms are drawn in place, never shipped).
  3. PUBLISHED, not measured: the link rates below.
  4. Weak scaling: each added card holds the same rows, so the compute time
     per sweep stays and only halo time and latency are added; efficiency =
     t_compute / (t_compute + t_halo).

Run from the repository root on a machine with a card:

    python3 -m tsu_tpu_torch.tools.scaling_projection [--device cpu] [--force-write]

It prints the JSON and writes ``visual_output/scaling_projection.json`` on
the card only (or with ``--force-write``): a CPU run must not overwrite a
card's measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.tools.timing import synchronize

# Published, not measured. NVLink 4 on the H100 SXM: 900 GB/s per card, both
# directions together (NVIDIA H100 Tensor Core GPU datasheet); the halo bytes
# below also count both directions.
NVLINK_BYTES_PER_S = 9.0e11
# Published, not measured. One NDR InfiniBand port: 400 Gb/s each way
# (InfiniBand NDR, as NVIDIA's ConnectX-7 adapters list it), both directions
# together 1.0e11 B/s: the cross-host link.
NDR_BYTES_PER_S = 1.0e11


def measure_copy_latency(device, cols: int = 4096, n: int = 1000) -> float:
    """Seconds per halo copy (2 rows x C/2 bf16, one device to itself) as
    the host issues them back to back, synchronised at the end: what one
    exchange costs before its bytes."""
    dev = resolve_device(device)
    src = torch.ones((2, cols // 2), dtype=torch.bfloat16, device=dev)
    dst = torch.empty_like(src)
    dst.copy_(src)
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        dst.copy_(src)
    synchronize(dev)
    return (time.perf_counter() - t0) / n


def measure_sharded_sweep_time(size: int = 4096, n_sweeps: int = 2500, trials: int = 3,
                               device=None) -> dict:
    """The sharded path's time per sweep on one card (best of ``trials``
    calls of ``n_sweeps`` sweeps), through the one measurement harness of
    the matched-size scaling row, and one halo copy's latency."""
    from tsu_tpu_torch.benchmarks.scaling import measure_lattice_matched

    dev = resolve_device(device)
    m = measure_lattice_matched(size=size, n_sweeps=n_sweeps, n_iters=trials, device=dev)
    return {
        "size": m["size"],
        "n_sweeps": m["n_sweeps"],
        "dtype": m["dtype"],
        "itemsize": torch.empty((), dtype=getattr(torch, m["dtype"])).element_size(),
        "sweep_time_s": m["size"] * m["size"] / m["flips_per_s"],
        "flips_per_s": m["flips_per_s"],
        "copy_latency_s": measure_copy_latency(dev, m["size"]),
        "backend": dev.type,
        "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "none",
    }


def project(measured: dict, n_chips: int, link_bytes_per_s: float, latency_s: float) -> dict:
    """Weak-scaling projection: n_chips shards, the measured rows on each.

    Halo per sweep per shard: K1's shard mode reads the 2 boundary rows of
    the black plane in each direction (compact width C/2), plus two
    exchanges' latency."""
    size = measured["size"]
    item = measured["itemsize"]
    halo_bytes = 2 * (size // 2) * item * 2  # 2 rows x C/2 cols x 2 dirs
    t_halo = halo_bytes / link_bytes_per_s + 2 * latency_s
    t_compute = measured["sweep_time_s"]
    eff = t_compute / (t_compute + t_halo)
    return {
        "n_chips": n_chips,
        "rows_per_chip": size,
        "lattice": f"{size * n_chips}x{size}",
        "halo_bytes_per_sweep_per_shard": halo_bytes,
        "halo_time_s": t_halo,
        "compute_time_s": t_compute,
        "projected_efficiency": round(eff, 4),
        "projected_aggregate_flips_per_s": measured["flips_per_s"] * n_chips * eff,
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None)
    parser.add_argument("--force-write", action="store_true")
    args = parser.parse_args(argv)
    measured = measure_sharded_sweep_time(device=args.device)
    lat = measured["copy_latency_s"]
    out = {
        "methodology": (
            "weak scaling projected from the measured 1-card sharded-path sweep time; halo "
            "traffic analytic (2-row black halos x 2 directions); link rates published "
            "(NVLink 4, NDR InfiniBand); per-exchange latency the measured cost of one halo "
            "copy; efficiency = t_compute / (t_compute + t_halo + latency)"
        ),
        "assumptions": {
            "nvlink_bytes_per_s": NVLINK_BYTES_PER_S,
            "ndr_bytes_per_s": NDR_BYTES_PER_S,
            "collective_latency_s": lat,
        },
        "measured_1chip": measured,
        "projected_nvlink": [project(measured, n, NVLINK_BYTES_PER_S, lat) for n in (2, 4, 8)],
        "projected_ndr_2host": project(measured, 2, NDR_BYTES_PER_S, lat),
    }
    print(json.dumps(out, indent=2))
    if out["measured_1chip"]["backend"] == "cuda" or args.force_write:
        os.makedirs("visual_output", exist_ok=True)
        path = os.path.join("visual_output", "scaling_projection.json")
        with open(path, "w") as f:
            json.dump(out, f, indent=2)
        print(f"wrote {path}")
    return out


if __name__ == "__main__":
    main()
