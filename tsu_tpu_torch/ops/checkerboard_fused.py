"""Fused full checkerboard sweep: both colours in one kernel launch.

Counterpart of ``tsu_tpu/ops/checkerboard_fused.py``. ``fused_sweep`` (one
lattice) and ``fused_sweep_batched`` (B lattices, each with its own key and
table) wrap the hand-written CUDA kernels of
``tsu_tpu_torch/csrc/checkerboard_fused.cu``: on a CUDA tensor they launch
the kernel, on a CPU tensor they run ``fused_sweep_reference`` or
``fused_sweep_batched_reference``, the plain PyTorch versions, which the
kernels match bit for bit.

One sweep resamples red from black, then black from the new red, with the
heat-bath rule ``s = +1 if u < table[nbr + 4] else -1``: ``nbr`` is the
4-neighbour sum in {-4..4}, ``u`` a 16-bit uniform and ``table`` the 16-bit
thresholds of :func:`sigmoid_table16`. Uniforms come from the counter-based
Philox of ``tsu_tpu_torch/rng.py`` (lo16 of a site's word drives red, hi16
black) or are injected as (2, R, C2) int32 in [0, 2^16).
"""

from __future__ import annotations

import numpy as np
import torch

from tsu_tpu_torch import profiling
from tsu_tpu_torch.ops._build import (
    MAX_BATCH,
    PLANE_DTYPES,
    call,
    check_on,
    cuda_index,
    library,
)
from tsu_tpu_torch.ops.checkerboard import (  # noqa: F401 (sigmoid_table: the JAX module's name)
    neighbor_sum_half,
    neighbor_sum_half_halo,
    sigmoid_table,
    sigmoid_table16,
)
from tsu_tpu_torch.rng import MASK32, fold_seed, philox_words, sweep_keys


def _check(black: torch.Tensor, table: torch.Tensor, uniforms, keys=None):
    """Raise unless the operands fit a kernel: the single-lattice one (keys
    None; black (R, C2), table (9,), uniforms (2, R, C2)) or the batched one
    (black (B, R, C2), table (B, 9), keys (B, 2), uniforms (B, 2, R, C2))."""
    nd = 2 if keys is None else 3
    if black.dim() != nd or black.dtype not in PLANE_DTYPES:
        raise ValueError(f"black must be {nd}-D float32 or bfloat16 planes, got "
                         f"{tuple(black.shape)} {black.dtype}")
    *batch, R, C2 = black.shape
    if R < 2 or R % 2 or C2 < 1:
        raise ValueError(f"plane shape must be (even R >= 2, C/2 >= 1), got {(R, C2)}")
    if batch and not 1 <= batch[0] <= MAX_BATCH:
        raise ValueError(f"a batched sweep takes 1 to {MAX_BATCH} lattices, got {batch[0]}")
    if table.shape != (*batch, 9) or table.dtype != torch.int32:
        raise ValueError(f"table must be {(*batch, 9)} int32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if keys is not None and (keys.shape != (*batch, 2) or keys.dtype != torch.int32):
        raise ValueError(f"keys must be {(*batch, 2)} int32, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    if uniforms is not None and (uniforms.shape != (*batch, 2, R, C2)
                                 or uniforms.dtype != torch.int32):
        raise ValueError(f"uniforms must be {(*batch, 2, R, C2)} int32, got "
                         f"{tuple(uniforms.shape)} {uniforms.dtype}")


def _heatbath(nbr: torch.Tensor, u: torch.Tensor, table: torch.Tensor):
    """+1 where u < table[nbr + 4], else -1; ``table`` is (9,), or (B, 9)
    with one row per lattice of a (B, R, C2) ``nbr``."""
    thresh = torch.gather(table, -1, (nbr.long() + 4).flatten(-2)).view_as(nbr)
    return torch.where(u < thresh, 1.0, -1.0)


def _plain_sweep(black, table, u_red, u_black, periodic):
    table = table.to(black.device)
    red = _heatbath(neighbor_sum_half(black.float(), True, periodic), u_red, table)
    new_black = _heatbath(neighbor_sum_half(red, False, periodic), u_black, table)
    return red.to(black.dtype), new_black.to(black.dtype)


def _check_shard(black, uniforms, up2, down2, shard_info, uniforms_halo):
    """Raise unless the shard-mode operands fit the plane: up2 and down2
    (2, C2) of black's dtype; shard_info (row0, R_global, is_top, is_bot)
    with row0 even and the plane inside the lattice; uniforms_halo two
    (1, C2) int32 rows exactly when uniforms are injected."""
    R, C2 = black.shape
    for name, t in (("up2", up2), ("down2", down2)):
        if t is None or t.shape != (2, C2) or t.dtype != black.dtype:
            raise ValueError(f"{name} must be {(2, C2)} {black.dtype}, got "
                             f"{None if t is None else (tuple(t.shape), t.dtype)}")
    if shard_info is None or len(shard_info) != 4:
        raise ValueError("shard mode takes shard_info = (row0, R_global, is_top, is_bot)")
    row0, R_global = int(shard_info[0]), int(shard_info[1])
    if row0 % 2 or row0 < 0 or row0 + R > R_global:
        raise ValueError(f"a shard of {R} rows must start on an even row inside the lattice's "
                         f"{R_global}, got row0 {row0}")
    if (uniforms is None) != (uniforms_halo is None):
        raise ValueError("injected uniforms in shard mode take uniforms_halo, and only they")
    if uniforms_halo is not None and any(
            u.numel() != C2 or u.dtype != torch.int32 for u in uniforms_halo):
        raise ValueError(f"uniforms_halo must be two rows of {C2} int32")


def _plain_shard_sweep(black, table, u_red_ext, u_black, up2, down2, is_top, is_bot,
                       periodic):
    """The sweep of one shard: red on its rows -1..R from black extended by
    the halo rows (the first of them has odd parity, so it takes the black
    rule's neighbour sum), the extension rows zeroed at an open global edge,
    then black from the extended red."""
    table = table.to(black.device)
    ext = torch.cat([up2, black, down2]).float()
    red = _heatbath(neighbor_sum_half_halo(ext[1:-1], ext[:1], ext[-1:], False, periodic),
                    u_red_ext, table)
    if not periodic:
        row = torch.arange(red.shape[0], device=black.device)[:, None]
        red = torch.where(((row == 0) & bool(is_top)) | ((row == red.shape[0] - 1) & bool(is_bot)),
                          0.0, red)
    new_black = _heatbath(neighbor_sum_half_halo(red[1:-1], red[:1], red[-1:], False, periodic),
                          u_black, table)
    return red[1:-1].to(black.dtype), new_black.to(black.dtype)


def fused_sweep_reference(black: torch.Tensor, table: torch.Tensor, *,
                          seed: int = 0, sweep: int = 0, periodic: bool = True,
                          uniforms: torch.Tensor | None = None, up2=None, down2=None,
                          shard_info=None, uniforms_halo=None):
    """Plain PyTorch version of the fused sweep kernel; returns (red, black)."""
    _check(black, table, uniforms)
    R, C2 = black.shape
    if up2 is not None or shard_info is not None:
        _check_shard(black, uniforms, up2, down2, shard_info, uniforms_halo)
        row0, R_global, is_top, is_bot = (int(v) for v in shard_info)
        if uniforms is None:
            rows = (row0 - 1 + torch.arange(R + 2)) % R_global
            words = philox_words(fold_seed(seed), sweep, R + 2, C2, device=black.device,
                                 rows=rows)
            u_red, u_black = words & 0xFFFF, words[1:-1] >> 16
        else:
            u_red = torch.cat([uniforms_halo[0].reshape(1, C2), uniforms[0],
                               uniforms_halo[1].reshape(1, C2)])
            u_black = uniforms[1]
        return _plain_shard_sweep(black, table, u_red, u_black, up2, down2, is_top, is_bot,
                                  periodic)
    if uniforms is None:
        words = philox_words(fold_seed(seed), sweep, R, C2, device=black.device)
        u_red, u_black = words & 0xFFFF, words >> 16
    else:
        u_red, u_black = uniforms[0], uniforms[1]
    return _plain_sweep(black, table, u_red, u_black, periodic)


def fused_sweep(black: torch.Tensor, table: torch.Tensor, *, seed: int = 0,
                sweep: int = 0, periodic: bool = True,
                uniforms: torch.Tensor | None = None, up2=None, down2=None,
                shard_info=None, uniforms_halo=None):
    """One full sweep (red, then black); returns new (red, black) planes.

    ``black``: (R, C2) float32 or bfloat16 plane, R even. ``table``: (9,)
    int32 from :func:`sigmoid_table16`. ``seed``/``sweep`` key the Philox
    stream as (fold_seed(seed), sweep); ``uniforms``: optional (2, R, C2)
    int32 replacing it. A CUDA tensor launches the kernel, and the count
    ``fused_sweep.launches`` grows by one; a CPU tensor runs
    :func:`fused_sweep_reference`. The red plane is never read: heat-bath
    red depends only on black.

    Shard mode, for a shard of a row-sharded lattice
    (:mod:`tsu_tpu_torch.parallel.lattice`): ``up2``/``down2`` are the
    (2, C2) black rows above and below the shard (global rows row0-2,
    row0-1 and row0+R, row0+R+1; zeros at an open global edge), which
    replace the plane's wrap; ``shard_info`` = (row0, R_global, is_top,
    is_bot): the shard's first global row (even), the lattice's rows, and
    whether the shard holds the lattice's first or last row; with injected
    uniforms, ``uniforms_halo`` = (u_top, u_bot), the (1, C2) red uniforms
    of global rows row0-1 and row0+R, which the neighbour shards hold.
    Draws are keyed by global rows, so the red rows a shard recomputes at
    its edges are its neighbours' stored rows.
    """
    if black.device.type == "cpu":
        return fused_sweep_reference(black, table, seed=seed, sweep=sweep,
                                     periodic=periodic, uniforms=uniforms, up2=up2,
                                     down2=down2, shard_info=shard_info,
                                     uniforms_halo=uniforms_halo)
    if black.device.type != "cuda":
        raise ValueError(f"fused_sweep runs on cpu or cuda tensors, got {black.device}")
    _check(black, table, uniforms)
    check_on(black.device, black=black, table=table, uniforms=uniforms)
    shard = up2 is not None or shard_info is not None
    if shard:
        _check_shard(black, uniforms, up2, down2, shard_info, uniforms_halo)
        u_top, u_bot = (None, None) if uniforms_halo is None else uniforms_halo
        check_on(black.device, up2=up2, down2=down2, u_top=u_top, u_bot=u_bot)

    lib = library("checkerboard_fused")
    k0, k1 = fold_seed(seed) & MASK32, sweep & MASK32
    red_out, black_out = torch.empty_like(black), torch.empty_like(black)
    if shard:
        call(lib.tsu_fused_sweep_shard, black.device, black, red_out, black_out, table, uniforms,
             up2, down2, u_top, u_bot, *black.shape, *(int(v) for v in shard_info),
             int(periodic), k0, k1, int(black.dtype == torch.bfloat16))
    else:
        call(lib.tsu_fused_sweep, black.device, black, red_out, black_out, table, uniforms,
             *black.shape, int(periodic), k0, k1, int(black.dtype == torch.bfloat16))
    fused_sweep.launches += 1
    return red_out, black_out


fused_sweep.launches = 0


def fused_sweeps(seed: int, red: torch.Tensor, black: torch.Tensor,
                 temperature, n_sweeps: int, *, J: float = 1.0,
                 field: float = 0.0, periodic: bool = True,
                 uniforms: torch.Tensor | None = None):
    """n_sweeps full sweeps with the fused kernel; returns (red, black).

    ``temperature``: a scalar, or an (n_sweeps,) schedule (sweep k runs at
    temperature[k]). ``uniforms``: optional (n_sweeps, 2, R, C2) int32 in
    [0, 2^16). Sweep k draws from the Philox stream (fold_seed(seed), k).
    On the card the checks, the library, the stream, the key, the table and
    uniform rows and the output planes are set up once, so a sweep costs one
    kernel call; ``fused_sweep.launches`` grows by one per sweep.
    """
    with profiling.annotate("lattice.sweeps", black.device):
        temps = torch.as_tensor(temperature, dtype=torch.float32).cpu().reshape(-1)
        tables = sigmoid_table16(J, field, temps.broadcast_to((n_sweeps,)))
        profiling.count("host_syncs", n_sweeps > 0)   # the table's copy in, from pageable memory
        tables = tables.to(black.device).contiguous()
        if uniforms is not None:
            uniforms = torch.as_tensor(uniforms, dtype=torch.int32,
                                       device=black.device).contiguous()
            if uniforms.shape != (n_sweeps, 2, *black.shape):
                raise ValueError(f"uniforms must be (n_sweeps, 2, R, C2), got "
                                 f"{tuple(uniforms.shape)}")
        if black.device.type != "cuda" or n_sweeps == 0:
            for k in range(n_sweeps):
                red, black = fused_sweep(
                    black, tables[k], seed=seed, sweep=k, periodic=periodic,
                    uniforms=None if uniforms is None else uniforms[k])
            return red, black
        _check(black, tables[0], None if uniforms is None else uniforms[0])
        check_on(black.device, black=black)
        entry = library("checkerboard_fused").tsu_fused_sweep
        index = cuda_index(black.device)
        k0 = fold_seed(seed) & MASK32
        stream = torch.cuda.current_stream(black.device).cuda_stream
        table_step = tables.stride(0) * tables.element_size()
        u_step = 0 if uniforms is None else uniforms.stride(0) * uniforms.element_size()
        # Red is never read, so one plane takes every sweep's red; black
        # takes turns between two, a sweep reading one and writing the other.
        red, outs = torch.empty_like(black), (torch.empty_like(black), torch.empty_like(black))
        fixed, bf16 = (*black.shape, int(periodic), k0), int(black.dtype == torch.bfloat16)
        for k in range(n_sweeps):
            call(entry, index, black, red, outs[k % 2], tables.data_ptr() + k * table_step,
                 None if uniforms is None else uniforms.data_ptr() + k * u_step, *fixed,
                 k & MASK32, bf16, stream=stream)
            black = outs[k % 2]
            fused_sweep.launches += 1
        return red, black


def fused_sweep_batched_reference(blacks: torch.Tensor, tables: torch.Tensor,
                                  keys: torch.Tensor, *, periodic: bool = True,
                                  uniforms: torch.Tensor | None = None):
    """Plain PyTorch version of the batched fused sweep kernel; returns
    (reds, blacks). Element b equals :func:`fused_sweep_reference` under the
    key row b and table row b."""
    _check(blacks, tables, uniforms, keys)
    _, R, C2 = blacks.shape
    if uniforms is None:
        k = keys.to(blacks.device, torch.int64) & MASK32
        words = philox_words(k[:, 0, None, None], k[:, 1, None, None], R, C2,
                             device=blacks.device)
        u_red, u_black = words & 0xFFFF, words >> 16
    else:
        u_red, u_black = uniforms[:, 0], uniforms[:, 1]
    return _plain_sweep(blacks, tables, u_red, u_black, periodic)


def fused_sweep_batched(blacks: torch.Tensor, tables: torch.Tensor,
                        keys: torch.Tensor, *, periodic: bool = True,
                        uniforms: torch.Tensor | None = None):
    """One full sweep of B lattices in one launch; returns new (reds, blacks).

    ``blacks``: (B, R, C2) float32 or bfloat16 planes, R even,
    1 <= B <= MAX_BATCH. ``tables``: (B, 9) int32, row b from
    :func:`sigmoid_table16` at lattice b's temperature. ``keys``: (B, 2)
    int32 rows (fold_seed(seed_b), sweep_b), as :func:`sweep_keys` builds
    them. ``uniforms``: optional (B, 2, R, C2) int32 replacing the Philox
    stream. A CUDA tensor launches the kernel, and the count
    ``fused_sweep_batched.launches`` grows by one; a CPU tensor runs
    :func:`fused_sweep_batched_reference`. Tables, keys and uniforms are
    taken as they lie: callers upload them once per call, not per launch.
    """
    if blacks.device.type == "cpu":
        return fused_sweep_batched_reference(blacks, tables, keys,
                                             periodic=periodic, uniforms=uniforms)
    if blacks.device.type != "cuda":
        raise ValueError(f"fused_sweep_batched runs on cpu or cuda tensors, got {blacks.device}")
    _check(blacks, tables, uniforms, keys)
    check_on(blacks.device, blacks=blacks, tables=tables, keys=keys, uniforms=uniforms)

    reds_out, blacks_out = torch.empty_like(blacks), torch.empty_like(blacks)
    call(library("checkerboard_fused").tsu_fused_sweep_batched, blacks.device, blacks, reds_out,
         blacks_out, tables, keys, uniforms, *blacks.shape, int(periodic),
         int(blacks.dtype == torch.bfloat16))
    fused_sweep_batched.launches += 1
    return reds_out, blacks_out


fused_sweep_batched.launches = 0


def fused_sweeps_keyed(reds: torch.Tensor, blacks: torch.Tensor,
                       tables: torch.Tensor, keys: torch.Tensor, *,
                       periodic: bool = True, uniforms: torch.Tensor | None = None):
    """len(keys) batched sweeps with keys and tables built beforehand;
    returns (reds, blacks), the inputs when there is no sweep.

    ``keys``: (n, B, 2) int32, row k those of sweep k (:func:`sweep_keys`).
    ``tables``: (B, 9) int32 for every sweep, or (n, B, 9), row k for sweep
    k. ``uniforms``: optional (n, B, 2, R, C2) int32. All lie on the planes'
    device, so a sweep copies nothing to it.
    """
    for k in range(keys.shape[0]):
        reds, blacks = fused_sweep_batched(
            blacks, tables if tables.dim() == 2 else tables[k], keys[k],
            periodic=periodic, uniforms=None if uniforms is None else uniforms[k])
    return reds, blacks


def fused_sweeps_batched(seeds, reds: torch.Tensor, blacks: torch.Tensor,
                         temperatures, n_sweeps: int, *, J: float = 1.0,
                         field: float = 0.0, periodic: bool = True,
                         uniforms: torch.Tensor | None = None):
    """n_sweeps full sweeps of a batch of lattices, one batched launch per
    sweep; returns (reds, blacks).

    ``seeds``: (B,) distinct per-lattice stream ids, or (B, 2) rows whose
    second column is ignored (the sweep counter comes from this loop):
    sweep k of lattice b draws from (fold_seed(seeds[b]), k).
    ``temperatures``: a scalar or (B,). ``uniforms``: optional
    (n_sweeps, B, 2, R, C2) int32 in [0, 2^16). The keys and tables of all
    sweeps go to the device in one copy each; :func:`fused_sweeps_keyed`
    runs them.
    """
    seeds = np.asarray(seeds.cpu() if isinstance(seeds, torch.Tensor) else seeds, np.int64)
    if seeds.ndim == 2:
        seeds = seeds[:, 0]
    B = blacks.shape[0]
    if seeds.shape != (B,):
        raise ValueError(f"seeds must be ({B},) or ({B}, 2), got {seeds.shape}")
    temps = torch.as_tensor(temperatures, dtype=torch.float32).cpu().reshape(-1)
    tables = sigmoid_table16(J, field, temps.broadcast_to((B,))).to(blacks.device)
    keys = sweep_keys(seeds[None, :], np.arange(n_sweeps)[:, None]).to(blacks.device)
    if uniforms is not None:
        uniforms = torch.as_tensor(uniforms, dtype=torch.int32, device=blacks.device)
        if uniforms.shape != (n_sweeps, B, 2, *blacks.shape[1:]):
            raise ValueError(f"uniforms must be (n_sweeps, B, 2, R, C2), got "
                             f"{tuple(uniforms.shape)}")
    return fused_sweeps_keyed(reds, blacks, tables, keys, periodic=periodic,
                              uniforms=uniforms)
