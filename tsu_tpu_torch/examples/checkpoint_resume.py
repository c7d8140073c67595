"""Kill a sharded lattice run and a PT ground-state search short, then
resume each to a longer horizon, bit for bit.

Counterpart of ``examples/checkpoint_resume.py``. A long lattice run is the
kind of job that gets preempted, and the resumed job may ask for more than
the killed one did:

1. ``sharded_lattice_sample`` on 4 row shards of one device (K1 in shard
   mode) snapshots its planes and observables every 4 samples; a run of 4
   samples stands for the killed one, and the resumed call asks for 12 and
   returns the uninterrupted run's 12 (sweep s draws under the global sweep
   counter s, so the cut is invisible to the physics);
2. ``pt_ground_state_search`` (K5) killed after 30 iterations with no
   quench and resumed to 90 returns the uninterrupted 90-iteration search
   (iteration t draws from the seed and t alone).

Sizes are small so that it runs anywhere in seconds; the mechanism does
not depend on them (the CLI: ``python3 -m tsu_tpu_torch.cli anneal
--spin-glass --checkpoint ck --resume``; the suites: ``python3 -m
tsu_tpu_torch.benchmarks.runner --resume``).

Run: python3 -m tsu_tpu_torch.examples.checkpoint_resume [--device cpu] [--<size> N ...]
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.examples import cli
from tsu_tpu_torch.parallel import make_mesh, sharded_lattice_sample
from tsu_tpu_torch.samplers.tempering_ladder import pt_ground_state_search


def main(rows_per_shard: int = 16, cols: int = 64, n_samples: int = 12, killed_at: int = 4,
         size: int = 16, n_iters: int = 90, killed_iters: int = 30, seed: int = 0,
         device=None) -> dict:
    device = resolve_device(device)
    mesh = make_mesh(rows=4, devices=[device] * 4)
    lat0 = torch.ones((rows_per_shard * 4, cols), device=device)
    kwargs = dict(n_samples=n_samples, temperature=2.3, n_burnin=20, n_sweeps=1)
    gen = torch.Generator().manual_seed(seed)
    Jh, Jv = (torch.where(torch.rand((size, size), generator=gen) < 0.5, 1.0, -1.0).numpy()
              for _ in range(2))
    temps = np.geomspace(0.4, 2.0, 8)
    pt_kwargs = dict(temperatures=temps, n_sweeps=1, quench_sweeps=8, device=device)

    with tempfile.TemporaryDirectory(prefix="tsu_ckpt_") as tmp:
        # Ground truth: one uninterrupted run.
        full = sharded_lattice_sample(mesh, seed, lat0, **kwargs)
        # "Preempted" run: a snapshot every killed_at samples, killed at the
        # first (a call that stops there), then resumed to the full horizon.
        ck = os.path.join(tmp, "lattice_ck")
        sharded_lattice_sample(mesh, seed, lat0, checkpoint_path=ck, checkpoint_every=killed_at,
                               **{**kwargs, "n_samples": killed_at})
        resumed = sharded_lattice_sample(mesh, seed, lat0, checkpoint_path=ck,
                                         checkpoint_every=killed_at, resume=True, **kwargs)
        same = (torch.equal(full["magnetization"], resumed["magnetization"])
                and torch.equal(full["energy"], resumed["energy"]))
        print(f"1. sharded lattice sample resumed bit-identically: {same}")
        if not same:
            raise AssertionError("the resumed sharded sample differs from the uninterrupted one")

        # PT ground-state search: killed after killed_iters of n_iters.
        ck2 = os.path.join(tmp, "pt_ck")
        full_pt = pt_ground_state_search(seed + 3, Jh, Jv, n_iters=n_iters, **pt_kwargs)
        pt_ground_state_search(seed + 3, Jh, Jv, n_iters=killed_iters, chunk_iters=killed_iters,
                               checkpoint_path=ck2, **{**pt_kwargs, "quench_sweeps": 0})
        resumed_pt = pt_ground_state_search(seed + 3, Jh, Jv, n_iters=n_iters,
                                            chunk_iters=killed_iters, checkpoint_path=ck2,
                                            resume=True, **pt_kwargs)
        same_pt = (full_pt["best_energy"] == resumed_pt["best_energy"]
                   and np.array_equal(full_pt["best_state"], resumed_pt["best_state"]))
        print(f"2. PT ground-state search resumed bit-identically: {same_pt}")
        if not same_pt:
            raise AssertionError("the resumed PT search differs from the uninterrupted one")
    line = (f"sharded sample {killed_at} -> {n_samples} samples and PT search {killed_iters} -> "
            f"{n_iters} iterations resumed bit for bit (best energy {full_pt['best_energy']:.0f})")
    print(f"   {line}")
    return {"sharded_same": same, "pt_same": same_pt, "best_energy": full_pt["best_energy"],
            "magnetization": full["magnetization"], "line": line}


if __name__ == "__main__":
    cli(main, __doc__)
