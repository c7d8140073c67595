"""Resident multi-sweep checkerboard sweeps: S sweeps in one kernel launch.

Counterpart of ``tsu_tpu/ops/checkerboard_resident.py``. ``resident_sweeps``
(S sweeps at one temperature) and ``resident_anneal`` (one temperature per
sweep) keep the reference's signatures and return ``(red, black)``. They
build the 24-bit threshold tables of :func:`sigmoid_table` and call the
lower-level pair that takes the tables directly,
:func:`resident_sweeps_table` ((9,) table, n_sweeps) and
:func:`resident_anneal_tables` ((S, 9) tables, one row per sweep). On a CUDA
tensor those launch the hand-written kernel of
``tsu_tpu_torch/csrc/checkerboard_resident.cu`` once per call, and their
``launches`` counts grow by one; on a CPU tensor they run the plain PyTorch
versions (``*_reference``), which the kernel matches bit for bit.

A sweep resamples red from black, then black from the new red, with the
heat-bath rule ``s = +1 if u24 < table[nbr + 4] else -1``: ``nbr`` is the
4-neighbour sum in {-4..4} and ``u24`` a 24-bit uniform, the top 24 bits of
the site's Philox4x32-10 word under the key (fold_seed(seed), 2 * sweep +
colour) at counter (row, col // 4), or injected as (S, 2, R, C2) int32 in
[0, 2^24) ([s, 0] drives red, [s, 1] black of sweep s). The reference lacks
the injected mode.

The JAX functions return new arrays and leave their inputs alone; these
return new planes too. The kernel holds the whole lattice on chip as bits,
a tile of it in each block's shared memory (:func:`resident_plan` cuts it
into tiles), so the size it takes is a limit of the card: a lattice whose
tiles do not fit the shared memory of the grid the card keeps resident raises
``ConfigurationError`` naming the limit (about 240 M sites at 132 blocks of
227 KB: a 15,500^2 lattice), with no fall-back. Below it any even R and
C >= 2 is accepted, every shape the reference's kernel runs among them
(R a multiple of its 16-row chunks, planes within ``resident_fits``'s 48 MB
and, as the TPU lays them out, within its VMEM); the reference's row-chunk
height (``_pick_chunk``) and its miscompile guard are TPU limits, not
carried over. The plain versions take any size.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from tsu_tpu_torch.config import ConfigurationError
from tsu_tpu_torch.ops._build import PLANE_DTYPES, call, check_on, cuda_index, library
from tsu_tpu_torch.ops.checkerboard import neighbor_sum_half, sigmoid_table
from tsu_tpu_torch.rng import MASK32, fold_seed, philox_words


def _check(red, black, tables, n_sweeps, uniforms):
    """Raise unless the operands fit: tables (9,) for one table (K6) or
    (n_sweeps, 9) for one per sweep (K7)."""
    if red.dim() != 2 or red.dtype not in PLANE_DTYPES or black.shape != red.shape \
            or black.dtype != red.dtype:
        raise ValueError(f"red and black must be (R, C2) planes of one dtype, float32 or "
                         f"bfloat16, got {tuple(red.shape)} {red.dtype} and "
                         f"{tuple(black.shape)} {black.dtype}")
    R, C2 = red.shape
    if R < 2 or R % 2 or C2 < 1:
        raise ValueError(f"plane shape must be (even R >= 2, C/2 >= 1), got {(R, C2)}")
    want = (9,) if tables.dim() == 1 else (n_sweeps, 9)
    if tables.dtype != torch.int32 or tables.shape != want:
        raise ValueError(f"tables must be {want} int32, got {tuple(tables.shape)} "
                         f"{tables.dtype}")
    if n_sweeps < 0:
        raise ValueError(f"n_sweeps must be >= 0, got {n_sweeps}")
    if uniforms is not None and (uniforms.shape != (n_sweeps, 2, R, C2)
                                 or uniforms.dtype != torch.int32):
        raise ValueError(f"uniforms must be {(n_sweeps, 2, R, C2)} int32, got "
                         f"{tuple(uniforms.shape)} {uniforms.dtype}")


def _halfstep(other, table, u24, update_red: bool, periodic: bool):
    nbr = neighbor_sum_half(other.float(), update_red, periodic)
    thresh = torch.gather(table, 0, (nbr.long() + 4).flatten()).view_as(nbr)
    return torch.where(u24 < thresh, 1.0, -1.0).to(other.dtype)


_WORDS_PER_DRAW = 1 << 22   # Philox words drawn at once: several sweeps of a small lattice


def _u24_chunks(k0: int, n_sweeps: int, R: int, C2: int, device):
    """(sweep, (S', 2, R, C2) uniforms) for consecutive chunks of sweeps: the
    top 24 bits of Philox under (k0, 2 * sweep + colour), drawn for as many
    sweeps at once as _WORDS_PER_DRAW allows."""
    per = max(1, _WORDS_PER_DRAW // (2 * R * C2))
    for s0 in range(0, n_sweeps, per):
        n = min(per, n_sweeps - s0)
        k1 = torch.arange(2 * s0, 2 * (s0 + n), dtype=torch.int64, device=device)[:, None, None]
        yield s0, (philox_words(k0, k1, R, C2, device=device) >> 8).view(n, 2, R, C2)


def _plain(seed, red, black, tables, n_sweeps, periodic, uniforms):
    _check(red, black, tables, n_sweeps, uniforms)
    tables = tables.to(black.device)
    R, C2 = black.shape
    chunks = ([(0, uniforms)] if uniforms is not None
              else _u24_chunks(fold_seed(seed) & MASK32, n_sweeps, R, C2, black.device))
    for s0, u24 in chunks:
        for i in range(u24.shape[0]):
            table = tables if tables.dim() == 1 else tables[s0 + i]
            red = _halfstep(black, table, u24[i, 0], True, periodic)
            black = _halfstep(red, table, u24[i, 1], False, periodic)
    return red, black


WORD_BITS = 32          # sites per word of a tile
WARP_WORDS = 8          # words of a row a warp updates at a time
TABLE_BYTES = 64        # a block's shared memory before its tiles: the 9-entry table


@dataclass(frozen=True)
class ResidentPlan:
    """How the kernel cuts an (R, C2) lattice into tiles, one per block:
    ``bands`` bands of rows by ``ranges`` ranges of the ceil(C2 / 32) words
    of a row, split as evenly as integers allow (:func:`tile_bounds`). A
    block's shared memory holds the table and both colours' tiles of at most
    ``rows`` rows plus two halo rows, each row ``stride`` words:
    ``smem_bytes`` in all."""
    bands: int
    ranges: int
    rows: int
    stride: int
    smem_bytes: int

    @property
    def blocks(self) -> int:
        return self.bands * self.ranges


def resident_plan(R: int, C2: int, blocks: int, smem_per_block: int):
    """The tiling of an (R, C2) lattice over at most ``blocks`` blocks of
    ``smem_per_block`` bytes of dynamic shared memory, or None if none fits:
    the fewest ranges of words (one, whole rows, whenever the bands fit),
    then as many bands of rows as the blocks allow, at most one per row."""
    W = -(-C2 // WORD_BITS)
    for ranges in range(1, min(W, blocks) + 1):
        bands = min(R, blocks // ranges)
        rows, words = -(-R // bands), -(-W // ranges)
        stride = WARP_WORDS * -(-words // WARP_WORDS) + 2   # a warp's words past the last, halos
        smem = TABLE_BYTES + 2 * (rows + 2) * stride * 4
        if smem <= smem_per_block:
            return ResidentPlan(bands, ranges, rows, stride, smem)
    return None


def tile_bounds(plan: ResidentPlan, R: int, C2: int) -> list:
    """[(first row, rows, first word, words)] of every block's tile, in
    block order, as the kernel computes them."""
    W = -(-C2 // WORD_BITS)
    out = []
    for b in range(plan.blocks):
        by, bx = divmod(b, plan.ranges)
        r0, w0 = by * R // plan.bands, bx * W // plan.ranges
        out.append((r0, (by + 1) * R // plan.bands - r0, w0,
                    (bx + 1) * W // plan.ranges - w0))
    return out


@functools.cache
def _card_limits(index: int) -> tuple:
    sms, optin, coop = (ctypes.c_int(0) for _ in range(3))
    call(library("checkerboard_resident").tsu_resident_limits, index, ctypes.byref(sms),
         ctypes.byref(optin), ctypes.byref(coop))
    if not coop.value:
        raise ConfigurationError("the resident kernel needs a card that takes cooperative "
                                 "launches")
    return sms.value, optin.value


def _blocks_per_sm(index: int, smem_bytes: int, bf16: bool) -> int:
    per_sm = ctypes.c_int(0)
    call(library("checkerboard_resident").tsu_resident_occupancy, index, smem_bytes, int(bf16),
         ctypes.byref(per_sm))
    return per_sm.value


@functools.cache
def resident_grid(R: int, C2: int, dtype=torch.bfloat16, device_index: int = 0) -> ResidentPlan:
    """The plan of the cooperative launch at (R, C2) on a card: the most
    blocks per SM the card keeps resident with its tiles in shared memory.
    Raises ``ConfigurationError`` when no plan fits."""
    sms, optin = _card_limits(device_index)
    bf16 = dtype == torch.bfloat16
    limit = optin
    for per_sm in range(_blocks_per_sm(device_index, 0, bf16), 0, -1):
        plan = resident_plan(R, C2, per_sm * sms, limit)
        if plan is not None and plan.blocks <= _blocks_per_sm(device_index, plan.smem_bytes,
                                                              bf16) * sms:
            return plan
    raise ConfigurationError(
        f"a {R} x {2 * C2} lattice does not fit the resident kernel: its tiles, two bit planes "
        f"with halos, need more than the {limit} B of shared memory each of this card's "
        f"{sms} resident blocks may hold (the limit is about {8 * limit * sms // 10**6} M "
        f"sites); use fused_sweeps")


def _launch(seed, red, black, tables, n_sweeps, periodic, uniforms):
    """Run n_sweeps sweeps from (red, black) in one cooperative launch;
    returns new (red, black)."""
    _check(red, black, tables, n_sweeps, uniforms)
    check_on(black.device, tables=tables, uniforms=uniforms)
    if red.device != black.device:
        raise ValueError(f"red lies on {red.device}, black on {black.device}")
    R, C2 = red.shape
    if n_sweeps == 0:
        return tuple(torch.clone(x, memory_format=torch.contiguous_format) for x in (red, black))
    plan = resident_grid(R, C2, red.dtype, cuda_index(black.device))
    # The kernel reads black once, before its first grid barrier, and writes
    # both planes after its last: in place on a copy. Red is recomputed
    # before it is read, so its copy is never filled.
    black = torch.clone(black, memory_format=torch.contiguous_format)
    red = torch.empty_like(black)
    # Scratch: each colour's edges as bits, and each block's count of
    # half-steps published.
    img = torch.empty(2 * R * -(-C2 // WORD_BITS), dtype=torch.int32, device=black.device)
    flags = torch.zeros(plan.blocks, dtype=torch.int32, device=black.device)
    call(library("checkerboard_resident").tsu_resident_run, black.device, red, black, tables,
         0 if tables.dim() == 1 else 9, uniforms, n_sweeps, R, C2, int(periodic),
         fold_seed(seed) & MASK32, int(red.dtype == torch.bfloat16), plan.bands, plan.ranges,
         plan.rows, plan.stride, img, flags)
    return red, black


def _on_cuda(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {t.device}")


def _one_table(table):
    if table.dim() != 1:
        raise ValueError(f"one table is (9,), got {tuple(table.shape)}")
    return table


def _per_sweep(tables):
    if tables.dim() != 2:
        raise ValueError(f"per-sweep tables are (S, 9), got {tuple(tables.shape)}")
    return tables


def resident_sweeps_table_reference(seed: int, red, black, table, n_sweeps: int, *,
                                    periodic: bool = True, uniforms=None):
    """Plain PyTorch version of the resident kernel at one table; returns
    (red, black)."""
    return _plain(seed, red, black, _one_table(table), n_sweeps, periodic, uniforms)


def resident_sweeps_table(seed: int, red, black, table, n_sweeps: int, *,
                          periodic: bool = True, uniforms=None):
    """n_sweeps full sweeps at one (9,) int32 table (:func:`sigmoid_table`);
    returns new (red, black) planes. A CUDA tensor launches the kernel once,
    and ``resident_sweeps_table.launches`` grows by one (not for
    n_sweeps == 0); a CPU tensor runs :func:`resident_sweeps_table_reference`.
    """
    if black.device.type == "cpu":
        return resident_sweeps_table_reference(seed, red, black, table, n_sweeps,
                                               periodic=periodic, uniforms=uniforms)
    _on_cuda("resident_sweeps_table", black)
    out = _launch(seed, red, black, _one_table(table), n_sweeps, periodic, uniforms)
    if n_sweeps:
        resident_sweeps_table.launches += 1
    return out


resident_sweeps_table.launches = 0


def resident_anneal_tables_reference(seed: int, red, black, tables, *, periodic: bool = True,
                                     uniforms=None):
    """Plain PyTorch version of the resident kernel over (S, 9) tables, row s
    for sweep s; returns (red, black)."""
    return _plain(seed, red, black, _per_sweep(tables), tables.shape[0], periodic, uniforms)


def resident_anneal_tables(seed: int, red, black, tables, *, periodic: bool = True,
                           uniforms=None):
    """S = len(tables) full sweeps, sweep s at the (9,) int32 row tables[s];
    returns new (red, black) planes. A CUDA tensor launches the kernel once,
    and ``resident_anneal_tables.launches`` grows by one (not for S == 0); a
    CPU tensor runs :func:`resident_anneal_tables_reference`."""
    if black.device.type == "cpu":
        return resident_anneal_tables_reference(seed, red, black, tables, periodic=periodic,
                                                uniforms=uniforms)
    _on_cuda("resident_anneal_tables", black)
    out = _launch(seed, red, black, _per_sweep(tables), tables.shape[0], periodic, uniforms)
    if tables.shape[0]:
        resident_anneal_tables.launches += 1
    return out


resident_anneal_tables.launches = 0


def _uniforms(uniforms, device):
    return None if uniforms is None else torch.as_tensor(uniforms, dtype=torch.int32,
                                                         device=device)


def resident_sweeps_reference(seed: int, red, black, temperature, n_sweeps: int, *,
                              J: float = 1.0, field: float = 0.0, periodic: bool = True,
                              uniforms=None):
    """Plain PyTorch version of :func:`resident_sweeps`."""
    table = sigmoid_table(J, field, float(temperature)).to(black.device)
    return resident_sweeps_table_reference(int(seed), red, black, table, int(n_sweeps),
                                           periodic=periodic,
                                           uniforms=_uniforms(uniforms, black.device))


def resident_sweeps(seed: int, red, black, temperature, n_sweeps: int, *, J: float = 1.0,
                    field: float = 0.0, periodic: bool = True, uniforms=None):
    """n_sweeps full sweeps at ``temperature`` in one launch; returns
    (red, black). ``red``/``black``: (R, C2) float32 or bfloat16 planes, R
    even. ``uniforms``: optional (n_sweeps, 2, R, C2) int32 in [0, 2^24)."""
    table = sigmoid_table(J, field, float(temperature)).to(black.device)
    return resident_sweeps_table(int(seed), red, black, table, int(n_sweeps), periodic=periodic,
                                 uniforms=_uniforms(uniforms, black.device))


def _schedule_tables(J, field, schedule, device):
    temps = torch.as_tensor(schedule, dtype=torch.float32).cpu().reshape(-1)
    return sigmoid_table(J, field, temps).reshape(-1, 9).to(device)


def resident_anneal_reference(seed: int, red, black, schedule, *, J: float = 1.0,
                              field: float = 0.0, periodic: bool = True, uniforms=None):
    """Plain PyTorch version of :func:`resident_anneal`."""
    tables = _schedule_tables(J, field, schedule, black.device)
    return resident_anneal_tables_reference(int(seed), red, black, tables, periodic=periodic,
                                            uniforms=_uniforms(uniforms, black.device))


def resident_anneal(seed: int, red, black, schedule, *, J: float = 1.0, field: float = 0.0,
                    periodic: bool = True, uniforms=None):
    """Anneal over an (S,) temperature schedule in one launch, sweep s at
    schedule[s]; returns (red, black). The S tables go to the device in one
    copy. ``uniforms``: optional (S, 2, R, C2) int32 in [0, 2^24)."""
    tables = _schedule_tables(J, field, schedule, black.device)
    return resident_anneal_tables(int(seed), red, black, tables, periodic=periodic,
                                  uniforms=_uniforms(uniforms, black.device))


def resident_grid_blocks(R: int, C2: int, dtype=torch.bfloat16) -> int:
    """The grid size (blocks) of the cooperative launch at (R, C2) on the
    current card: one block per tile of :func:`resident_grid`."""
    return resident_grid(R, C2, dtype, torch.cuda.current_device()).blocks
