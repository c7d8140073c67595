"""Edwards-Anderson ±J spin-glass ground-state search at lattice scale.

Counterpart of ``examples/spin_glass_ground_state.py``. Random ±1 bonds on
a periodic 2-D lattice, annealed through the discrete-table bond
half-sweep (K4, one launch per half-sweep), best state over independent
restarts. The known ground-state energy density of the 2-D ±J EA model is
about -1.40 J/site; a few thousand annealing sweeps with restarts should
land within a couple of percent.

Run: python3 -m tsu_tpu_torch.examples.spin_glass_ground_state [--size 1024]
     [--steps 3000] [--restarts 2] [--seed 0] [--device cpu]
"""

from __future__ import annotations

import time

import torch

from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.examples import cli
from tsu_tpu_torch.samplers.annealing import anneal_spin_glass

GS_DENSITY = -1.40   # 2-D ±J EA ground-state energy per site


def main(size: int = 1024, steps: int = 3000, restarts: int = 2, seed: int = 0,
         device=None) -> dict:
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    Jh, Jv = (torch.where(torch.rand((size, size), generator=gen) < 0.5, 1.0, -1.0)
              for _ in range(2))

    t0 = time.perf_counter()
    state, energy = anneal_spin_glass(gen, Jh, Jv, T_initial=3.0, T_final=0.05, n_steps=steps,
                                      n_restarts=restarts, device=device)
    dt = time.perf_counter() - t0

    n = size * size
    line = (f"{size}x{size} ±J EA glass, {steps} sweeps x {restarts} restarts: E = {energy:.0f} "
            f"({energy / n:.4f} J/site, GS density ~ {GS_DENSITY:.2f}) in {dt:.1f}s")
    print(line)
    return {"energy": energy, "energy_per_site": energy / n, "seconds": dt, "state": state,
            "line": line}


if __name__ == "__main__":
    cli(main, __doc__)
