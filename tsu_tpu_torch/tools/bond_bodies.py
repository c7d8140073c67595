"""Time versions of the bond kernels' source against each other on one card.

Run from the repository root on a machine with a card:

    python3 -m tsu_tpu_torch.tools.bond_bodies [SOURCE ...] [--rounds N]

Each SOURCE is a version of ``tsu_tpu_torch/csrc/checkerboard_bonds.cu`` with
its two C entries (default: this tree's). To hold another commit's against
this tree's, write it out first:

    git show <commit>:tsu_tpu_torch/csrc/checkerboard_bonds.cu > build/parent.cu
    python3 -m tsu_tpu_torch.tools.bond_bodies build/parent.cu \\
        tsu_tpu_torch/csrc/checkerboard_bonds.cu

Each source is built with the port's nvcc flags (``ops/_build.py``), held
against the plain versions at every shape below over two half-sweeps in
Philox mode (discrete bit for bit, continuous outside CONTINUOUS_BAND), and
timed per half-sweep from a CUDA graph of 1000 chained half-sweeps at the
shapes of the spin-glass paths and the bench: K4 discrete at 4096^2 and
4096x4094 bf16, K4 continuous at 4096^2 f32 (Gaussian bonds and a field,
T = 1.5), K5 discrete at 284 x 256^2 and 64 x 256^2 bf16. The sources take
turns, forward in even rounds and backward in odd ones, so that a drift of
the card falls on all of them alike. The last line is one JSON object: the
card and, per source and shape, the ms of each round.
"""

from __future__ import annotations

import argparse
import json
import sys
from unittest import mock

import numpy as np
import torch

from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.ops import _build
from tsu_tpu_torch.ops import checkerboard_bonds_kernel as bk
from tsu_tpu_torch.ops.checkerboard import split_checkerboard
from tsu_tpu_torch.ops.checkerboard_bonds import color_bond_weights, pack_bond_codes
from tsu_tpu_torch.ops.checkerboard_fused import sigmoid_table
from tsu_tpu_torch.tools.bodies import build_versions, in_turns
from tsu_tpu_torch.tools.timing import card, graph_ms

TREE_SOURCE = "tsu_tpu_torch/csrc/checkerboard_bonds.cu"


def _spins(gen, shape, dtype, dev):
    lat = torch.where(torch.rand(shape, generator=gen) < 0.5, 1.0, -1.0).to(dtype)
    return split_checkerboard(lat)[1].contiguous().to(dev)


def _codes(gen, shape, dev):
    Jh, Jv = (torch.where(torch.rand(shape, generator=gen) < 0.5, 1.0, -1.0) for _ in range(2))
    return pack_bond_codes(color_bond_weights(Jh.to(dev), Jv.to(dev)))


def shapes(dev) -> dict:
    """{label: (kernel, other plane(s), weights, mode)} of the timed shapes."""
    gen = torch.Generator().manual_seed(51)
    table = {"table": sigmoid_table(1.0, 0.0, 1.0).to(dev)}
    out = {f"K4 discrete {R}x{C}": ("K4", _spins(gen, (R, C), torch.bfloat16, dev),
                                    _codes(gen, (R, C), dev), table)
           for R, C in ((4096, 4096), (4096, 4094))}
    Jh, Jv, field = (torch.randn((4096, 4096), generator=gen) for _ in range(3))
    weights = color_bond_weights(Jh.to(dev), Jv.to(dev), (0.3 * field).to(dev))
    out["K4 continuous 4096x4096 f32"] = ("K4", _spins(gen, (4096, 4096), torch.float32, dev),
                                          weights, {"temperature": 1.5})
    for B in (284, 64):
        temps = torch.tensor(np.geomspace(0.3, 2.0, B), dtype=torch.float32)
        out[f"K5 discrete {B} x 256x256"] = (
            "K5", _spins(gen, (B, 256, 256), torch.bfloat16, dev), _codes(gen, (256, 256), dev),
            {"tables": sigmoid_table(1.0, 0.0, temps).to(dev),
             "keys": bk.bond_sweep_keys(np.arange(B), 500).to(dev).reshape(1000, B, 2)})
    return out


def half_sweep(kind, other, weights, k, mode, plain=False):
    """Half-sweep k of a chain (red on even k), by the kernel or its plain
    version."""
    color = "red" if k % 2 == 0 else "black"
    if kind == "K4":
        fn = bk.bond_halfsweep_reference if plain else bk.bond_halfsweep
        return fn(other, weights[color], update_red=k % 2 == 0, key=(5, k), **mode)
    fn = bk.bond_halfsweep_batched_reference if plain else bk.bond_halfsweep_batched
    return fn(other, weights[color], mode["keys"][k], update_red=k % 2 == 0,
              tables=mode["tables"])


def check(label, kind, other, weights, mode):
    """Raise unless two chained half-sweeps equal the plain version's."""
    for k in range(2):
        got = half_sweep(kind, other, weights, k, mode)
        differ = got != half_sweep(kind, other, weights, k, mode, plain=True)
        if "temperature" in mode:
            differ &= ~bk.continuous_band(other, weights["red" if k % 2 == 0 else "black"],
                                          update_red=k % 2 == 0, key=(5, k),
                                          temperature=mode["temperature"])
        if differ.any():
            raise AssertionError(f"{label}: {int(differ.sum())} sites differ at half-sweep {k}")
        other = got


def chain(kind, other, weights, mode):
    def go(count):
        o = other
        for k in range(count):
            o = half_sweep(kind, o, weights, k, mode)
    return go


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", default=[TREE_SOURCE])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    libs = build_versions(args.sources, "bond_body", _build.bond_library)
    work = shapes(dev)
    ms = {src: {label: [] for label in work} for src in libs}
    for rnd, src in in_turns(libs, args.rounds):
        with mock.patch.object(bk, "bond_sweep_library", lambda lib=libs[src]: lib):
            for label, (kind, other, weights, mode) in work.items():
                if rnd == 0:
                    check(f"{src} {label}", kind, other, weights, mode)
                ms[src][label].append(graph_ms(chain(kind, other, weights, mode), 1000))
        print(f"round {rnd} {src}: " + ", ".join(
            f"{label} {v[-1]:.6f} ms" for label, v in ms[src].items()), flush=True)
    print(json.dumps({"card": card(), "ms_per_half_sweep": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
