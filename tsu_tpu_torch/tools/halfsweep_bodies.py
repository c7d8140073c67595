"""Time versions of the half-sweep kernel's source against each other on one card.

Run from the repository root on a machine with a card:

    python3 -m tsu_tpu_torch.tools.halfsweep_bodies [SOURCE ...] [--rounds N]

Each SOURCE is a version of the exact-sigmoid half-sweep kernel (K3): the
strip body, whose C entry ``tsu_halfsweep`` takes the column halos' row
strides (``tsu_tpu_torch/csrc/checkerboard_halfsweep.cu``), or the first
body, whose C entry is ``tsu_halfsweep_scalar``
(``checkerboard_halfsweep_scalar.cu``, kept beside it for this comparison).
The default is the first body, then this tree's. To try a variant, copy a
source under ``build/`` with one constant changed (``STRIP_TR``, ...) and
pass it too.

Each source is built with the port's nvcc flags (``ops/_build.py``) and, at
every shape below, held over two half-sweeps, injected 24-bit uniforms and
Philox, against the plain version outside CONTINUOUS_BAND and against the
first source at every site, band included. Then each is timed per
half-sweep from a CUDA graph of 1000 half-sweeps of one plane: 4096^2 f32
and bf16 periodic (the plane's wrap rows as halos), and the 2048^2 f32 shard
of a 2 x 2 mesh of that lattice at rows 2048.., compact columns 1024.., its
halos the neighbour shards' rows and columns (the strip body reads the
columns in place, strided; the first body gets them contiguous, copied
before the timing). The sources take turns, forward in even rounds and
backward in odd ones (``tools/bodies.py``). The last line is one JSON
object: the card and, per source and shape, the ms of each round.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import sys
from pathlib import Path

import torch

from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.ops import _build
from tsu_tpu_torch.ops.checkerboard import split_checkerboard, wrap_halos
from tsu_tpu_torch.ops.checkerboard_kernel import (
    _check,
    _kernel_operands,
    halfsweep_band,
    halfsweep_reference,
)
from tsu_tpu_torch.rng import MASK32
from tsu_tpu_torch.tools.bodies import build_versions, in_turns
from tsu_tpu_torch.tools.timing import card, graph_ms

TREE_SOURCE = "tsu_tpu_torch/csrc/checkerboard_halfsweep.cu"
SCALAR_SOURCE = "tsu_tpu_torch/csrc/checkerboard_halfsweep_scalar.cu"
MAIN = (4096, 4096)
KEYS = ((11, 0), (12, 0), (11, 1), (12, 1))     # the keys of two sweeps' half-sweeps


@functools.cache
def scalar_library() -> ctypes.CDLL:
    """The first body, built and loaded once per process."""
    return _build.halfsweep_body_library(_build.library_path(
        "checkerboard_halfsweep_scalar", ("checkerboard_halfsweep_scalar.cu",)))


def body_halfsweep(lib, other, up_row, down_row, *, update_red: bool, temperature,
                   J: float = 1.0, field: float = 0.0, periodic: bool = True, key=(0, 0),
                   row0: int = 0, col0: int = 0, left_col=None, right_col=None, uniforms=None):
    """One half-sweep by a build of either body (``halfsweep``'s arguments);
    returns the new plane. The first body takes contiguous column halos."""
    _check(other, up_row, down_row, left_col, right_col, uniforms, row0, col0)
    strides = _kernel_operands(other, up_row, down_row, left_col, right_col, uniforms)
    ptr = [None if t is None else t.data_ptr()
           for t in (up_row, down_row, left_col, right_col, uniforms)]
    out = torch.empty_like(other)
    tail = (*other.shape, int(update_red), int(periodic), float(J), float(field),
            float(temperature), row0, col0, key[0] & MASK32, key[1] & MASK32,
            int(other.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    if hasattr(lib, "tsu_halfsweep_scalar"):
        if any(c is not None and not c.is_contiguous() for c in (left_col, right_col)):
            raise ValueError("the first body takes contiguous column halos")
        err = lib.tsu_halfsweep_scalar(other.data_ptr(), out.data_ptr(), *ptr, *tail)
    else:
        err = lib.tsu_halfsweep(other.data_ptr(), out.data_ptr(), *ptr[:4], *strides, ptr[4],
                                *tail)
    if err:
        raise RuntimeError(f"half-sweep kernel launch failed with CUDA error {err}")
    return out


def _lattice(gen, shape, dtype):
    """The black plane of a random +-1 lattice."""
    lat = torch.where(torch.rand(shape, generator=gen) < 0.5, 1.0, -1.0).to(dtype)
    return split_checkerboard(lat)[1].contiguous()


def shapes(dev) -> dict:
    """{label: (other, (up, down, left, right), contiguous columns, where)}
    of the timed shapes; ``where`` holds periodic, row0 and col0."""
    gen = torch.Generator().manual_seed(71)
    out = {}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        other = _lattice(gen, MAIN, dtype).to(dev)
        out[f"{MAIN[0]}x{MAIN[1]} {name}"] = (other, (*wrap_halos(other, True), None, None),
                                              (None, None), dict(periodic=True))
    plane = _lattice(gen, MAIN, torch.float32)
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


def half_sweep(lib, work, k: int, uniforms=None, temperature=2.269):
    """Half-sweep k of ``work`` (red on even k) by ``lib``, or by the plain
    version where ``lib`` is None."""
    other, (up, down, left, right), contiguous, where = work
    if lib is not None and hasattr(lib, "tsu_halfsweep_scalar"):
        left, right = contiguous
    kw = dict(update_red=k % 2 == 0, temperature=temperature, J=1.0, field=0.1, key=KEYS[k],
              left_col=left, right_col=right, uniforms=uniforms, **where)
    if lib is None:
        return halfsweep_reference(other, up, down, **kw)
    return body_halfsweep(lib, other, up, down, **kw)


def check(label, libs: dict, work, gen) -> None:
    """Raise unless every build equals the plain version outside the band and
    the first build at every site, over two half-sweeps, injected and
    Philox."""
    other, (up, down, left, right), _, where = work
    R, C2 = other.shape
    for injected in (True, False):
        for k in range(2):
            u = None
            if injected:
                u = torch.randint(0, 1 << 24, (R, C2), generator=gen, dtype=torch.int32).to(
                    other.device)
            want = half_sweep(None, work, k, u)
            band = halfsweep_band(other, up, down, update_red=k % 2 == 0, temperature=2.269,
                                  J=1.0, field=0.1, key=KEYS[k], left_col=left, right_col=right,
                                  uniforms=u, **where)
            first = None
            for src, lib in libs.items():
                got = half_sweep(lib, work, k, u)
                if ((got != want) & ~band).any():
                    raise AssertionError(f"{src} {label}: differs from the plain version outside "
                                         f"the band at half-sweep {k} (injected={injected})")
                if first is not None and not torch.equal(got, first):
                    raise AssertionError(f"{src} {label}: differs from {next(iter(libs))} at "
                                         f"{int((got != first).sum())} sites (injected={injected})")
                first = got if first is None else first
    torch.cuda.synchronize()


def timed(lib, work):
    """``run(n)``: n half-sweeps of ``work``'s plane by ``lib``, for graph_ms."""
    def run(n):
        for k in range(n):
            half_sweep(lib, work, k % 4)
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", default=[SCALAR_SOURCE, TREE_SOURCE])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    libs = build_versions(args.sources, "halfsweep_body", _build.halfsweep_body_library)
    work = shapes(dev)
    gen = torch.Generator().manual_seed(72)
    for label, w in work.items():
        check(label, libs, w, gen)
        print(f"{label}: every source == the plain version outside the band and == "
              f"{Path(args.sources[0]).name} at every site", flush=True)
    ms = {src: {label: [] for label in work} for src in libs}
    for rnd, src in in_turns(libs, args.rounds):
        for label, w in work.items():
            ms[src][label].append(graph_ms(timed(libs[src], w), 1000))
        print(f"round {rnd} {src}: " + ", ".join(
            f"{label} {v[-1]:.6f} ms" for label, v in ms[src].items()), flush=True)
    print(json.dumps({"card": card(), "ms_per_half_sweep": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
