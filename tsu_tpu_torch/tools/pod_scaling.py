"""One-command multi-process scaling run: the chains and lattice scaling
rows over every rank of a ``torchrun`` launch.

Counterpart of ``scripts/pod_scaling.sh``. Run the same command on every
node, one process per card:

    torchrun --nnodes N --nproc-per-node <cards> [--rdzv-endpoint HOST:PORT] \\
        -m tsu_tpu_torch.tools.pod_scaling <out_dir>

Each rank forms the process group from torchrun's environment
(``parallel.multihost_initialize``; the backend by its rule: NCCL when every
rank has a card of its own, gloo when ranks share one), then every rank
runs ``measure_chains_scaling`` and ``measure_lattice_scaling`` over the
global mesh at the reference's sizes: 1,024 rows a device x 4,096 columns
on the card (256 x 1,024 with ``--device cpu``). Rank 0 prints the JSON and
writes it to ``<out_dir>/scaling_<backend><n_devices>_h<n_hosts>.json``, a
new file: it refuses to overwrite one. Ranks on one card measure the
mechanics, not scaling: their efficiency is null.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch

from tsu_tpu_torch.benchmarks.scaling import (
    _shared_host,
    measure_chains_scaling,
    measure_lattice_scaling,
)
from tsu_tpu_torch.parallel import distributed, multihost_initialize
from tsu_tpu_torch.tools.timing import card


def run(out_dir: Optional[str], rows_per_device: int, cols: int, chains_per_device: int = 1024,
        n_sweeps: Optional[int] = None) -> dict:
    """The two rows over the initialised runtime's ranks; rank 0 writes the
    JSON into ``out_dir`` (when given) and every rank returns it."""
    rt = distributed.runtime()
    if rt is None:
        raise RuntimeError("pod_scaling runs over the ranks of multihost_initialize")
    on_card = rt.device.type == "cuda"
    result = {
        "topology": {
            "platform": rt.device.type,
            "backend": rt.backend,
            "n_devices": rt.world_size,
            "n_processes": rt.world_size,
            "n_local_devices": torch.cuda.device_count() if on_card else 1,
            "n_hosts": rt.n_hosts,
            "placements": [f"{h}:{d}" for h, d in rt.placements],
            "shared_host_virtual_mesh": _shared_host(rt.placements),
            "card": card() if on_card else None,
        },
        "chains": measure_chains_scaling(chains_per_device=chains_per_device),
        "lattice": measure_lattice_scaling(rows_per_device=rows_per_device, cols=cols,
                                           n_sweeps=n_sweeps),
    }
    if rt.rank == 0 and out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, f"scaling_{rt.backend}{rt.world_size}_h{rt.n_hosts}.json")
        with open(out, "x") as f:
            json.dump(result, f, indent=2, default=float)
        result["written"] = out
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description="multi-process scaling rows under torchrun")
    parser.add_argument("out_dir", help="directory for scaling_<backend><n>_h<hosts>.json")
    parser.add_argument("--device", default=None,
                        help="default: the card of this rank (cuda:LOCAL_RANK); cpu runs "
                             "the plain versions over gloo")
    args = parser.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)
    rt = multihost_initialize(device=args.device)
    on_card = rt.device.type == "cuda"
    result = run(args.out_dir, 1024 if on_card else 256, 4096 if on_card else 1024)
    if rt.rank == 0:
        print(json.dumps(result, indent=2, default=float))
        print(f"wrote {result['written']}")
    distributed.shutdown()


if __name__ == "__main__":
    main()
