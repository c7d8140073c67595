"""Time versions of a kernel's source against each other on one card.

Run from the repository root on a machine with a card:

    python3 -m tsu_tpu_torch.tools.bodies KERNEL [SOURCE ...] [--rounds N] [--sweeps S]

KERNEL is K3 (the exact-sigmoid half-sweep), K4 or K5 (the bond kernels, one
source) or K6 or K7 (the resident kernels, one source). Each SOURCE is a
version of that kernel's source (default: as below). To hold another
commit's against this tree's, write it out first:

    git show <commit>:tsu_tpu_torch/csrc/checkerboard_bonds.cu > build/parent.cu
    python3 -m tsu_tpu_torch.tools.bodies K4 build/parent.cu \\
        tsu_tpu_torch/csrc/checkerboard_bonds.cu

Each source is built with the port's nvcc flags (``ops/_build.py``) under
its own name and held against the plain version; then the sources take
turns, forward in even rounds and backward in odd ones, so that a drift of
the card falls on all of them alike. The last line is one JSON object: the
card and, per source and shape, the ms of each round.

- K3: a source is the strip body, whose C entry ``tsu_halfsweep`` takes the
  column halos' row strides (``csrc/checkerboard_halfsweep.cu``), or the
  first body, whose C entry is ``tsu_halfsweep_scalar``
  (``checkerboard_halfsweep_scalar.cu``); the default is the first body,
  then this tree's. To try a variant, copy a source under ``build/`` with
  one constant changed (``STRIP_TR``, ...) and pass it too. At every shape,
  two half-sweeps, injected 24-bit uniforms and Philox, equal the plain
  version outside CONTINUOUS_BAND and the first source at every site, band
  included. Timed per half-sweep from a CUDA graph of 1000 half-sweeps of
  one plane: 4096^2 f32 and bf16 periodic (the plane's wrap rows as halos),
  and the 2048^2 f32 shard of a 2 x 2 mesh of that lattice at rows 2048..,
  compact columns 1024.., its halos the neighbour shards' rows and columns
  (the strip body reads the columns in place, strided; the first body gets
  them contiguous, copied before the timing). JSON: ``ms_per_half_sweep``.
- K4/K5 (default: ``csrc/checkerboard_bonds.cu``): at every shape, two
  half-sweeps in Philox mode equal the plain versions (discrete bit for bit,
  continuous outside CONTINUOUS_BAND). Timed per half-sweep from a CUDA
  graph of 1000 chained half-sweeps at the shapes of the spin-glass paths
  and the bench: K4 discrete at 4096^2 and 4096x4094 bf16, K4 continuous at
  4096^2 f32 (Gaussian bonds and a field, T = 1.5), K5 discrete at
  284 x 256^2 and 64 x 256^2 bf16. JSON: ``ms_per_half_sweep``.
- K6/K7 (default: ``csrc/checkerboard_resident.cu``): bit for bit equal to
  the plain version over 2 sweeps in Philox mode at 4096^2 bf16 periodic
  and 3 sweeps of injected uniforms at 1002x1000 f32 open. Timed per sweep
  with CUDA events over one call of S sweeps (default 500): K6 at 4096^2
  bf16 (one table, T = 2.269), K7 at 4096^2 bf16 (a schedule from T = 5 to
  0.05), and ``barrier``, K6 on a lattice of one row per block of the
  banded grid and 64 columns, where a sweep is little more than its two
  grid barriers and halo exchanges. JSON: ``sweeps``, ``ms_per_sweep`` and
  each source's ``grid``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path
from typing import Callable, NamedTuple
from unittest import mock

import numpy as np
import torch

from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.ops import _build
from tsu_tpu_torch.ops import checkerboard_bonds_kernel as bk
from tsu_tpu_torch.ops import checkerboard_resident as cr
from tsu_tpu_torch.ops.checkerboard import sigmoid_table, split_checkerboard, wrap_halos
from tsu_tpu_torch.ops.checkerboard_bonds import color_bond_weights, pack_bond_codes
from tsu_tpu_torch.ops.checkerboard_kernel import (
    _check,
    _kernel_operands,
    halfsweep_band,
    halfsweep_reference,
)
from tsu_tpu_torch.rng import MASK32
from tsu_tpu_torch.samplers.annealing import make_schedule
from tsu_tpu_torch.tools.timing import card, event_ms, graph_ms

CSRC = "tsu_tpu_torch/csrc"
MAIN = (4096, 4096)


def build_versions(sources, prefix: str, library) -> dict:
    """{source: its build, loaded}: each source built as ``<prefix>_<i>``
    and loaded with the C entries of ``library(source)``, a key of
    ``_build.ENTRIES``."""
    return {src: _build.load(library(src), _build.library_path(f"{prefix}_{i}",
                                                               (str(Path(src).resolve()),)))
            for i, src in enumerate(sources)}


def in_turns(names, rounds: int):
    """(round, name) pairs: every name once a round, forward in even rounds
    and backward in odd ones."""
    names = list(names)
    for rnd in range(rounds):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            yield rnd, name


def _planes(gen, shape, dtype, dev):
    """The (red, black) planes of a random +-1 lattice, contiguous on ``dev``."""
    lat = torch.where(torch.rand(shape, generator=gen) < 0.5, 1.0, -1.0).to(dtype)
    return tuple(x.contiguous().to(dev) for x in split_checkerboard(lat))


# K3: the first body and the strip body.

K3_KEYS = ((11, 0), (12, 0), (11, 1), (12, 1))     # the keys of two sweeps' half-sweeps


def scalar_library():
    """K3's first body, built and loaded once per process."""
    return _build.library("checkerboard_halfsweep_scalar")


def _k3_library(src) -> str:
    return ("checkerboard_halfsweep_scalar" if "tsu_halfsweep_scalar" in Path(src).read_text()
            else "checkerboard_halfsweep")


def body_halfsweep(lib, other, up_row, down_row, *, update_red: bool, temperature,
                   J: float = 1.0, field: float = 0.0, periodic: bool = True, key=(0, 0),
                   row0: int = 0, col0: int = 0, left_col=None, right_col=None, uniforms=None):
    """One half-sweep by a build of either K3 body (``halfsweep``'s
    arguments); returns the new plane. The first body takes contiguous
    column halos."""
    _check(other, up_row, down_row, left_col, right_col, uniforms, row0, col0)
    strides = _kernel_operands(other, up_row, down_row, left_col, right_col, uniforms)
    out = torch.empty_like(other)
    tail = (*other.shape, int(update_red), int(periodic), float(J), float(field),
            float(temperature), row0, col0, key[0] & MASK32, key[1] & MASK32,
            int(other.dtype == torch.bfloat16))
    if hasattr(lib, "tsu_halfsweep_scalar"):
        if any(c is not None and not c.is_contiguous() for c in (left_col, right_col)):
            raise ValueError("the first body takes contiguous column halos")
        _build.call(lib.tsu_halfsweep_scalar, other.device, other, out, up_row, down_row,
                    left_col, right_col, uniforms, *tail)
    else:
        _build.call(lib.tsu_halfsweep, other.device, other, out, up_row, down_row, left_col,
                    right_col, *strides, uniforms, *tail)
    return out


def k3_shapes(dev, _sweeps=None) -> dict:
    """{label: (other, (up, down, left, right), contiguous columns, where)}
    of K3's timed shapes; ``where`` holds periodic, row0 and col0."""
    gen = torch.Generator().manual_seed(71)
    out = {}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        other = _planes(gen, MAIN, dtype, dev)[1]
        out[f"{MAIN[0]}x{MAIN[1]} {name}"] = (other, (*wrap_halos(other, True), None, None),
                                              (None, None), dict(periodic=True))
    plane = _planes(gen, MAIN, torch.float32, "cpu")[1]
    R, C2 = MAIN[0] // 2, MAIN[1] // 4
    shards = [[plane[i * R:(i + 1) * R, j * C2:(j + 1) * C2].contiguous().to(dev)
               for j in range(2)] for i in range(2)]
    # Shard (1, 1): its up and down neighbour is shard (0, 1), its left and
    # right one shard (1, 0), as _halo_exchange and _halo_exchange_cols give
    # them on one card.
    left, right = shards[1][0][:, -1:], shards[1][0][:, :1]
    out[f"{R}x{2 * C2} f32 shard"] = (
        shards[1][1], (shards[0][1][-1:], shards[0][1][:1], left, right),
        (left.contiguous(), right.contiguous()), dict(periodic=True, row0=R, col0=C2))
    return out


def k3_half_sweep(lib, work, k: int, uniforms=None, temperature=2.269):
    """Half-sweep k of ``work`` (red on even k) by ``lib``, or by the plain
    version where ``lib`` is None."""
    other, (up, down, left, right), contiguous, where = work
    if lib is not None and hasattr(lib, "tsu_halfsweep_scalar"):
        left, right = contiguous
    kw = dict(update_red=k % 2 == 0, temperature=temperature, J=1.0, field=0.1, key=K3_KEYS[k],
              left_col=left, right_col=right, uniforms=uniforms, **where)
    if lib is None:
        return halfsweep_reference(other, up, down, **kw)
    return body_halfsweep(lib, other, up, down, **kw)


def _k3_check(libs: dict, work: dict, _dev) -> dict:
    """Raise unless every build equals the plain version outside the band and
    the first build at every site, over two half-sweeps, injected and
    Philox."""
    gen = torch.Generator().manual_seed(72)
    for label, w in work.items():
        other, (up, down, left, right), _, where = w
        R, C2 = other.shape
        for injected in (True, False):
            for k in range(2):
                u = None
                if injected:
                    u = torch.randint(0, 1 << 24, (R, C2), generator=gen,
                                      dtype=torch.int32).to(other.device)
                want = k3_half_sweep(None, w, k, u)
                band = halfsweep_band(other, up, down, update_red=k % 2 == 0,
                                      temperature=2.269, J=1.0, field=0.1, key=K3_KEYS[k],
                                      left_col=left, right_col=right, uniforms=u, **where)
                first = None
                for src, lib in libs.items():
                    got = k3_half_sweep(lib, w, k, u)
                    if ((got != want) & ~band).any():
                        raise AssertionError(f"{src} {label}: differs from the plain version "
                                             f"outside the band at half-sweep {k} "
                                             f"(injected={injected})")
                    if first is not None and not torch.equal(got, first):
                        raise AssertionError(f"{src} {label}: differs from {next(iter(libs))} "
                                             f"at {int((got != first).sum())} sites "
                                             f"(injected={injected})")
                    first = got if first is None else first
        torch.cuda.synchronize()
        print(f"{label}: every source == the plain version outside the band and == "
              f"{Path(next(iter(libs))).name} at every site", flush=True)
    return {}


def k3_timed(lib, work):
    """``run(n)``: n half-sweeps of ``work``'s plane by ``lib``, for graph_ms."""
    def run(n):
        for k in range(n):
            k3_half_sweep(lib, work, k % 4)
    return run


def _k3_ms(lib, work, _sweeps) -> float:
    return graph_ms(k3_timed(lib, work), 1000)


# K4 and K5: the bond kernels.

def _codes(gen, shape, dev):
    Jh, Jv = (torch.where(torch.rand(shape, generator=gen) < 0.5, 1.0, -1.0) for _ in range(2))
    return pack_bond_codes(color_bond_weights(Jh.to(dev), Jv.to(dev)))


def _k4_shapes(dev, _sweeps=None) -> dict:
    """{label: (kernel, other plane(s), weights, mode)} of the timed shapes."""
    gen = torch.Generator().manual_seed(51)
    table = {"table": sigmoid_table(1.0, 0.0, 1.0).to(dev)}
    out = {f"K4 discrete {R}x{C}": ("K4", _planes(gen, (R, C), torch.bfloat16, dev)[1],
                                    _codes(gen, (R, C), dev), table)
           for R, C in ((4096, 4096), (4096, 4094))}
    Jh, Jv, field = (torch.randn((4096, 4096), generator=gen) for _ in range(3))
    weights = color_bond_weights(Jh.to(dev), Jv.to(dev), (0.3 * field).to(dev))
    out["K4 continuous 4096x4096 f32"] = (
        "K4", _planes(gen, (4096, 4096), torch.float32, dev)[1], weights, {"temperature": 1.5})
    for B in (284, 64):
        temps = torch.tensor(np.geomspace(0.3, 2.0, B), dtype=torch.float32)
        out[f"K5 discrete {B} x 256x256"] = (
            "K5", _planes(gen, (B, 256, 256), torch.bfloat16, dev)[1],
            _codes(gen, (256, 256), dev),
            {"tables": sigmoid_table(1.0, 0.0, temps).to(dev),
             "keys": bk.bond_sweep_keys(np.arange(B), 500).to(dev).reshape(1000, B, 2)})
    return out


def _k4_half_sweep(kind, other, weights, k, mode, plain=False):
    """Half-sweep k of a chain (red on even k), by the kernel or its plain
    version."""
    color = "red" if k % 2 == 0 else "black"
    if kind == "K4":
        fn = bk.bond_halfsweep_reference if plain else bk.bond_halfsweep
        return fn(other, weights[color], update_red=k % 2 == 0, key=(5, k), **mode)
    fn = bk.bond_halfsweep_batched_reference if plain else bk.bond_halfsweep_batched
    return fn(other, weights[color], mode["keys"][k], update_red=k % 2 == 0,
              tables=mode["tables"])


@contextlib.contextmanager
def _k4_version(lib):
    with mock.patch.object(bk, "library", lambda name: lib):
        yield lib


def _k4_check(libs: dict, work: dict, _dev) -> dict:
    """Raise unless two chained half-sweeps of each build equal the plain
    version's."""
    for src, lib in libs.items():
        with _k4_version(lib):
            for label, (kind, other, weights, mode) in work.items():
                for k in range(2):
                    got = _k4_half_sweep(kind, other, weights, k, mode)
                    differ = got != _k4_half_sweep(kind, other, weights, k, mode, plain=True)
                    if "temperature" in mode:
                        differ &= ~bk.continuous_band(
                            other, weights["red" if k % 2 == 0 else "black"],
                            update_red=k % 2 == 0, key=(5, k), temperature=mode["temperature"])
                    if differ.any():
                        raise AssertionError(f"{src} {label}: {int(differ.sum())} sites differ "
                                             f"at half-sweep {k}")
                    other = got
    return {}


def _k4_ms(_lib, work, _sweeps) -> float:
    kind, other, weights, mode = work

    def chain(count):
        o = other
        for k in range(count):
            o = _k4_half_sweep(kind, o, weights, k, mode)
    return graph_ms(chain, 1000)


# K6 and K7: the resident kernel.

@contextlib.contextmanager
def _k6_version(lib):
    with mock.patch.object(cr, "library", lambda name: lib):
        cr.resident_grid.cache_clear()
        cr._card_limits.cache_clear()
        try:
            yield lib
        finally:
            cr.resident_grid.cache_clear()
            cr._card_limits.cache_clear()


def barrier_shape(dev) -> tuple:
    """One row per block of this tree's banded grid at 4096^2, 64 columns."""
    blocks = cr.resident_grid(MAIN[0], MAIN[1] // 2, torch.bfloat16, dev.index or 0).blocks
    return (blocks + blocks % 2, 64)


def _k6_shapes(dev, sweeps: int) -> dict:
    """{label: (red, black, tables)} of the timed shapes."""
    red, black = _planes(torch.Generator().manual_seed(19), MAIN, torch.bfloat16, dev)
    table = sigmoid_table(1.0, 0.0, 2.269).to(dev)
    tables = sigmoid_table(1.0, 0.0, torch.from_numpy(make_schedule(5.0, 0.05, sweeps))).to(dev)
    small = _planes(torch.Generator().manual_seed(20), barrier_shape(dev), torch.bfloat16, dev)
    return {"K6 4096x4096 bf16": (red, black, table),
            "K7 4096x4096 bf16": (red, black, tables),
            "barrier": (*small, table)}


def _k6_check(libs: dict, work: dict, dev) -> dict:
    """Raise unless each build equals the plain version bit for bit; returns
    each build's grid at the timed shapes."""
    grids = {}
    cases = [(MAIN, torch.bfloat16, True, 2, False), ((1002, 1000), torch.float32, False, 3, True)]
    for src, lib in libs.items():
        with _k6_version(lib):
            for shape, dtype, periodic, S, injected in cases:
                red, black = _planes(torch.Generator().manual_seed(7), shape, dtype, dev)
                table = sigmoid_table(1.0, 0.1, 2.3).to(dev)
                U = None
                if injected:
                    U = torch.randint(0, 1 << 24, (S, 2, shape[0], shape[1] // 2),
                                      dtype=torch.int32, device=dev,
                                      generator=torch.Generator(device=dev).manual_seed(8))
                got = cr._launch(9, red, black, table, S, periodic, U)
                want = cr.resident_sweeps_table_reference(9, red, black, table, S,
                                                          periodic=periodic, uniforms=U)
                for a, b in zip(got, want):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{src}: {int((a != b).sum())} sites differ from "
                                             f"the plain version at {shape} {dtype}")
            plans = {label: cr.resident_grid(*red.shape) for label, (red, _, _) in work.items()}
            grids[src] = {label: vars(p) | {"blocks": p.blocks} for label, p in plans.items()}
    return {"grid": grids}


def _k6_ms(_lib, work, sweeps: int) -> float:
    """ms per sweep of one S-sweep call, after a 2-sweep warm-up call."""
    red, black, tables = work
    warm = tables if tables.dim() == 1 else tables[:2]
    cr._launch(1, red, black, warm, 2, True, None)
    return event_ms(lambda n: cr._launch(2, red, black,
                                         tables if tables.dim() == 1 else tables[:n], n, True,
                                         None), sweeps)


class Tool(NamedTuple):
    prefix: str                  # the builds' name prefix
    sources: tuple               # the default sources
    library: Callable            # source -> its key of _build.ENTRIES
    shapes: Callable             # (dev, sweeps) -> {label: work}
    check: Callable              # (builds, shapes, dev) -> fields of the JSON line
    version: Callable            # build -> context in which the wrappers run it
    ms: Callable                 # (build, work, sweeps) -> ms of one timing
    unit: str                    # the JSON line's key of the times


TOOLS = {
    "K3": Tool("halfsweep_body", (f"{CSRC}/checkerboard_halfsweep_scalar.cu",
                                  f"{CSRC}/checkerboard_halfsweep.cu"),
               _k3_library, k3_shapes, _k3_check, contextlib.nullcontext, _k3_ms,
               "ms_per_half_sweep"),
    "K4": Tool("bond_body", (f"{CSRC}/checkerboard_bonds.cu",),
               lambda src: "checkerboard_bonds", _k4_shapes, _k4_check, _k4_version, _k4_ms,
               "ms_per_half_sweep"),
    "K6": Tool("resident_body", (f"{CSRC}/checkerboard_resident.cu",),
               lambda src: "checkerboard_resident", _k6_shapes, _k6_check, _k6_version, _k6_ms,
               "ms_per_sweep"),
}
TOOLS["K5"], TOOLS["K7"] = TOOLS["K4"], TOOLS["K6"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(TOOLS))
    ap.add_argument("sources", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sweeps", type=int, default=500, help="K6/K7: sweeps a timed call")
    args = ap.parse_args(argv)
    tool = TOOLS[args.kernel]
    dev = resolve_device(None)
    libs = build_versions(args.sources or tool.sources, tool.prefix, tool.library)
    work = tool.shapes(dev, args.sweeps)
    extra = tool.check(libs, work, dev)
    ms = {src: {label: [] for label in work} for src in libs}
    for rnd, src in in_turns(libs, args.rounds):
        with tool.version(libs[src]):
            for label, w in work.items():
                ms[src][label].append(tool.ms(libs[src], w, args.sweeps))
        print(f"round {rnd} {src}: " + ", ".join(
            f"{label} {v[-1]:.6f} ms" for label, v in ms[src].items()), flush=True)
    sweeps = {"sweeps": args.sweeps} if tool.unit == "ms_per_sweep" else {}
    print(json.dumps({"card": card(), **sweeps, tool.unit: ms, **extra}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
