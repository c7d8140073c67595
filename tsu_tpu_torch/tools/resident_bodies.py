"""Time versions of the resident kernel's source against each other on one card.

Run from the repository root on a machine with a card:

    python3 -m tsu_tpu_torch.tools.resident_bodies [SOURCE ...] [--rounds N] [--sweeps S]

Each SOURCE is a version of ``tsu_tpu_torch/csrc/checkerboard_resident.cu``:
the banded body, whose C entry is ``tsu_resident_run`` (this tree's), or the
grid-stride body, whose C entry is ``tsu_resident_sweeps``
(``checkerboard_resident_gridstride.cu``, kept beside it for this
comparison; a parent commit's ``checkerboard_resident.cu`` from before the
banded body has the same entry). The default is the grid-stride body, then
this tree's. To hold another commit's source against this tree's, write it
out first:

    git show <commit>:tsu_tpu_torch/csrc/checkerboard_resident.cu > build/parent.cu
    python3 -m tsu_tpu_torch.tools.resident_bodies build/parent.cu \\
        tsu_tpu_torch/csrc/checkerboard_resident.cu

Each source is built with the port's nvcc flags (``ops/_build.py``) and held
against the plain version bit for bit: 2 sweeps in Philox mode at 4096^2
bf16 periodic and 3 sweeps of injected uniforms at 1002x1000 f32 open. Then
each is timed per sweep with CUDA events over one call of S sweeps
(default 500): K6 at 4096^2 bf16 (one table, T = 2.269), K7 at 4096^2 bf16
(a schedule from T = 5 to 0.05), and ``barrier``, K6 on a lattice of one row
per block of the banded grid and 64 columns, where a sweep is little more
than its two grid barriers and halo exchanges. The sources take turns,
forward in even rounds and backward in odd ones (``tools/bodies.py``). The
last line is one JSON object: the card and, per source and shape, the ms of
each round, with each source's grid.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import sys
from unittest import mock

import torch

from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.ops import _build
from tsu_tpu_torch.ops import checkerboard_resident as cr
from tsu_tpu_torch.ops.checkerboard import split_checkerboard
from tsu_tpu_torch.ops.checkerboard_fused import sigmoid_table
from tsu_tpu_torch.rng import MASK32, fold_seed
from tsu_tpu_torch.samplers.annealing import make_schedule
from tsu_tpu_torch.tools.bodies import build_versions, in_turns
from tsu_tpu_torch.tools.timing import card, event_ms

TREE_SOURCE = "tsu_tpu_torch/csrc/checkerboard_resident.cu"
GRIDSTRIDE_SOURCE = "tsu_tpu_torch/csrc/checkerboard_resident_gridstride.cu"
MAIN = (4096, 4096)


def gridstride_library() -> ctypes.CDLL:
    """The grid-stride body, built and loaded."""
    return _build.resident_library(_build.library_path(
        "checkerboard_resident_gridstride", ("checkerboard_resident_gridstride.cu",)))


def gridstride_sweeps(lib, seed, red, black, tables, n_sweeps, periodic=True, uniforms=None):
    """n_sweeps sweeps by a grid-stride build (C entry ``tsu_resident_sweeps``)
    on copies of the planes, in one launch; returns (red, black)."""
    red, black = (torch.clone(x, memory_format=torch.contiguous_format) for x in (red, black))
    R, C2 = red.shape
    err = lib.tsu_resident_sweeps(
        red.data_ptr(), black.data_ptr(), tables.data_ptr(), 0 if tables.dim() == 1 else 9,
        None if uniforms is None else uniforms.data_ptr(), n_sweeps, R, C2, int(periodic),
        fold_seed(seed) & MASK32, int(red.dtype == torch.bfloat16), None,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"grid-stride resident kernel failed with CUDA error {err}")
    return red, black


def gridstride_blocks(lib, R: int, C2: int, dtype=torch.bfloat16) -> int:
    """The grid-stride body's grid size at (R, C2)."""
    blocks = ctypes.c_int(0)
    err = lib.tsu_resident_sweeps(None, None, None, 0, None, 0, R, C2, 1, 0,
                                  int(dtype == torch.bfloat16), ctypes.byref(blocks),
                                  torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"grid-stride occupancy query failed with CUDA error {err}")
    return blocks.value


@contextlib.contextmanager
def version(lib):
    """(run, grid): run(seed, red, black, tables, n_sweeps, periodic,
    uniforms) -> (red, black) by this build, and grid(R, C2) its grid."""
    if not hasattr(lib, "tsu_resident_run"):
        yield (lambda *a: gridstride_sweeps(lib, *a),
               lambda R, C2: {"blocks": gridstride_blocks(lib, R, C2), "threads": 256})
        return
    with mock.patch.object(cr, "resident_sweep_library", lambda: lib):
        cr.resident_grid.cache_clear()
        cr._card_limits.cache_clear()
        try:
            yield cr._launch, lambda R, C2: vars(cr.resident_grid(R, C2)) | {
                "blocks": cr.resident_grid(R, C2).blocks}
        finally:
            cr.resident_grid.cache_clear()
            cr._card_limits.cache_clear()


def planes(seed, shape, dtype, dev):
    gen = torch.Generator().manual_seed(seed)
    lat = torch.where(torch.rand(shape, generator=gen) < 0.5, 1.0, -1.0).to(dtype)
    return tuple(x.contiguous().to(dev) for x in split_checkerboard(lat))


def check(label, run, dev):
    """Raise unless the build equals the plain version bit for bit."""
    cases = [(MAIN, torch.bfloat16, True, 2, False), ((1002, 1000), torch.float32, False, 3, True)]
    for shape, dtype, periodic, S, injected in cases:
        red, black = planes(7, shape, dtype, dev)
        table = sigmoid_table(1.0, 0.1, 2.3).to(dev)
        U = None
        if injected:
            U = torch.randint(0, 1 << 24, (S, 2, shape[0], shape[1] // 2), dtype=torch.int32,
                              generator=torch.Generator(device=dev).manual_seed(8), device=dev)
        got = run(9, red, black, table, S, periodic, U)
        want = cr.resident_sweeps_table_reference(9, red, black, table, S, periodic=periodic,
                                                  uniforms=U)
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: {int((a != b).sum())} sites differ from the plain "
                                     f"version at {shape} {dtype}")


def barrier_shape(dev) -> tuple:
    """One row per block of this tree's banded grid at 4096^2, 64 columns."""
    blocks = cr.resident_grid(MAIN[0], MAIN[1] // 2, torch.bfloat16, dev.index or 0).blocks
    return (blocks + blocks % 2, 64)


def work(dev, S: int) -> dict:
    """{label: (red, black, tables)} of the timed shapes."""
    red, black = planes(19, MAIN, torch.bfloat16, dev)
    table = sigmoid_table(1.0, 0.0, 2.269).to(dev)
    tables = sigmoid_table(1.0, 0.0, torch.from_numpy(make_schedule(5.0, 0.05, S))).to(dev)
    small = planes(20, barrier_shape(dev), torch.bfloat16, dev)
    return {"K6 4096x4096 bf16": (red, black, table),
            "K7 4096x4096 bf16": (red, black, tables),
            "barrier": (*small, table)}


def per_sweep_ms(run, red, black, tables, S: int) -> float:
    """ms per sweep of one S-sweep call, after a 2-sweep warm-up call."""
    warm = tables if tables.dim() == 1 else tables[:2]
    run(1, red, black, warm, 2, True, None)
    return event_ms(lambda n: run(2, red, black, tables if tables.dim() == 1 else tables[:n], n,
                                  True, None), S)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", default=[GRIDSTRIDE_SOURCE, TREE_SOURCE])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sweeps", type=int, default=500)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    libs = build_versions(args.sources, "resident_body", _build.resident_library)
    shapes = work(dev, args.sweeps)
    ms = {src: {label: [] for label in shapes} for src in libs}
    grids = {}
    for rnd, src in in_turns(libs, args.rounds):
        with version(libs[src]) as (run, grid):
            if rnd == 0:
                check(src, run, dev)
                grids[src] = {label: grid(red.shape[0], red.shape[1])
                              for label, (red, _, _) in shapes.items()}
            for label, (red, black, tables) in shapes.items():
                ms[src][label].append(per_sweep_ms(run, red, black, tables, args.sweeps))
        print(f"round {rnd} {src}: " + ", ".join(
            f"{label} {v[-1]:.6f} ms" for label, v in ms[src].items()), flush=True)
    print(json.dumps({"card": card(), "sweeps": args.sweeps, "ms_per_sweep": ms,
                      "grid": grids}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
