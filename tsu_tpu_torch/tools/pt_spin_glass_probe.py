"""Probe: engineered-ladder parallel-tempering ground-state search of a 2-D
±J spin glass.

Counterpart of ``scripts/pt_spin_glass_probe.py``: builds the ladder
(``build_tempering_ladder``), then runs ``pt_ground_state_search`` (the
batched bond half-sweep, K5) and prints two JSON lines, the ladder's and the
search's: ladder size, swap acceptance, the gap to the literature
ground-state density -1.4015 and the walls. The bonds come from a CPU
``torch.Generator`` seeded 7. Run from the repository root:

    python3 -m tsu_tpu_torch.tools.pt_spin_glass_probe [L] [n_iters] [n_copies] [n_sweeps] [--device cpu]

with the reference's settings in the environment: ``PT_TMIN`` (0.4),
``PT_FB_ITERS`` (512), ``PT_HD_EVERY`` (0) and ``PT_CHUNK`` (no effect
here: the search's stream does not depend on it). It runs on the card and
raises without one, unless ``--device cpu`` asks for the plain versions.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.samplers.tempering_ladder import (
    build_tempering_ladder,
    pt_ground_state_search,
)

EA_GS_DENSITY = -1.4015


def main(argv=None, log=print) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("L", type=int, nargs="?", default=256)
    parser.add_argument("n_iters", type=int, nargs="?", default=2000)
    parser.add_argument("n_copies", type=int, nargs="?", default=1)
    parser.add_argument("n_sweeps", type=int, nargs="?", default=1)
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    L = args.L
    gen = torch.Generator().manual_seed(7)
    Jh, Jv = (torch.where(torch.rand((L, L), generator=gen) < 0.5, 1.0, -1.0) for _ in range(2))

    T_min = float(os.environ.get("PT_TMIN", "0.4"))
    fb_iters = int(os.environ.get("PT_FB_ITERS", "512"))
    t0 = time.perf_counter()
    temps, info = build_tempering_ladder(
        gen, Jh, Jv, T_min=T_min, T_max=2.0, target_acceptance=0.3, accept_floor=0.2,
        feedback_iters=fb_iters, feedback_burnin=fb_iters // 4, device=dev)
    t_build = time.perf_counter() - t0
    meas = info["measured_pair_acceptance"]
    ladder = {
        "stage": "ladder", "n_rungs": info["n_rungs"],
        "capped": bool(info["capped"]),
        "build_time_s": round(t_build, 1),
        "measured_acc_min": float(meas.min()) if meas is not None else None,
        "measured_acc_mean": float(meas.mean()) if meas is not None else None,
        "feedback_rounds": info["feedback_rounds_run"],
    }
    log(json.dumps(ladder))

    hd_every = int(os.environ.get("PT_HD_EVERY", "0"))
    chunk = int(os.environ.get("PT_CHUNK", "0")) or None
    t0 = time.perf_counter()
    out = pt_ground_state_search(
        gen, Jh, Jv, temperatures=temps, n_iters=args.n_iters, n_sweeps=args.n_sweeps,
        n_copies=args.n_copies, houdayer_every=hd_every, quench_sweeps=256,
        chunk_iters=chunk, device=dev)
    t_run = time.perf_counter() - t0
    gap = (out["energy_per_site"] - EA_GS_DENSITY) / abs(EA_GS_DENSITY)
    gs = {
        "stage": "gs", "L": L, "n_iters": args.n_iters,
        "n_copies": args.n_copies, "n_sweeps": args.n_sweeps,
        "houdayer_every": hd_every,
        "energy_per_site": round(out["energy_per_site"], 5),
        "gap_vs_lit": round(gap, 5),
        "swap_acc": round(out["swap_acceptance_rate"], 3),
        "pair_acc_min": round(float(out["pair_acceptance"].min()), 3),
        "run_time_s": round(t_run, 1),
        "discrete": out["discrete_table_path"],
    }
    log(json.dumps(gs))
    return [ladder, gs]


if __name__ == "__main__":
    main()
