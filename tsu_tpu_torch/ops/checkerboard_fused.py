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

from tsu_tpu_torch.ops._build import fused_sweep_library
from tsu_tpu_torch.ops.checkerboard import neighbor_sum_half
from tsu_tpu_torch.rng import MASK32, fold_seed, philox_words, sweep_keys

_DTYPES = (torch.float32, torch.bfloat16)
MAX_BATCH = 65535   # lattices per batched launch: the grid's z extent


def _table(J: float, field: float, temperature, scale: float) -> torch.Tensor:
    k = torch.arange(-4, 5, dtype=torch.float32)
    T = torch.as_tensor(temperature, dtype=torch.float32).cpu()[..., None]
    p = torch.sigmoid(2.0 * (J * k + field) / T)
    return torch.clamp(p * scale, 0, scale - 1).to(torch.int32)


def sigmoid_table(J: float, field: float, temperature) -> torch.Tensor:
    """(..., 9) int32 24-bit thresholds for neighbour sums -4..4, one row per
    temperature; computed on the CPU in float32."""
    return _table(J, field, temperature, 16777216.0)


def sigmoid_table16(J: float, field: float, temperature) -> torch.Tensor:
    """(..., 9) int32 16-bit thresholds matching the 16-bit uniforms of the
    fused sweep; computed on the CPU in float32."""
    return _table(J, field, temperature, 65536.0)


def _check(black: torch.Tensor, table: torch.Tensor, uniforms, keys=None):
    """Raise unless the operands fit a kernel: the single-lattice one (keys
    None; black (R, C2), table (9,), uniforms (2, R, C2)) or the batched one
    (black (B, R, C2), table (B, 9), keys (B, 2), uniforms (B, 2, R, C2))."""
    nd = 2 if keys is None else 3
    if black.dim() != nd or black.dtype not in _DTYPES:
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


def _check_on(device, **tensors):
    for name, t in tensors.items():
        if t is not None and (t.device != device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {device}")


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


def fused_sweep_reference(black: torch.Tensor, table: torch.Tensor, *,
                          seed: int = 0, sweep: int = 0, periodic: bool = True,
                          uniforms: torch.Tensor | None = None):
    """Plain PyTorch version of the fused sweep kernel; returns (red, black)."""
    _check(black, table, uniforms)
    R, C2 = black.shape
    if uniforms is None:
        words = philox_words(fold_seed(seed), sweep, R, C2, device=black.device)
        u_red, u_black = words & 0xFFFF, words >> 16
    else:
        u_red, u_black = uniforms[0], uniforms[1]
    return _plain_sweep(black, table, u_red, u_black, periodic)


def fused_sweep(black: torch.Tensor, table: torch.Tensor, *, seed: int = 0,
                sweep: int = 0, periodic: bool = True,
                uniforms: torch.Tensor | None = None):
    """One full sweep (red, then black); returns new (red, black) planes.

    ``black``: (R, C2) float32 or bfloat16 plane, R even. ``table``: (9,)
    int32 from :func:`sigmoid_table16`. ``seed``/``sweep`` key the Philox
    stream as (fold_seed(seed), sweep); ``uniforms``: optional (2, R, C2)
    int32 replacing it. A CUDA tensor launches the kernel, and the count
    ``fused_sweep.launches`` grows by one; a CPU tensor runs
    :func:`fused_sweep_reference`. The red plane is never read: heat-bath
    red depends only on black.
    """
    if black.device.type == "cpu":
        return fused_sweep_reference(black, table, seed=seed, sweep=sweep,
                                     periodic=periodic, uniforms=uniforms)
    if black.device.type != "cuda":
        raise ValueError(f"fused_sweep runs on cpu or cuda tensors, got {black.device}")
    _check(black, table, uniforms)
    _check_on(black.device, black=black, table=table, uniforms=uniforms)

    lib = fused_sweep_library()
    R, C2 = black.shape
    red_out = torch.empty_like(black)
    black_out = torch.empty_like(black)
    with torch.cuda.device(black.device):
        err = lib.tsu_fused_sweep(
            black.data_ptr(), red_out.data_ptr(), black_out.data_ptr(),
            table.data_ptr(), None if uniforms is None else uniforms.data_ptr(),
            R, C2, int(periodic), fold_seed(seed) & MASK32, sweep & MASK32,
            int(black.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fused sweep kernel launch failed with CUDA error {err}")
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
    """
    temps = torch.as_tensor(temperature, dtype=torch.float32).cpu().reshape(-1)
    tables = sigmoid_table16(J, field, temps.broadcast_to((n_sweeps,)))
    tables = tables.to(black.device)
    if uniforms is not None:
        uniforms = torch.as_tensor(uniforms, dtype=torch.int32, device=black.device)
        if uniforms.shape != (n_sweeps, 2, *black.shape):
            raise ValueError(f"uniforms must be (n_sweeps, 2, R, C2), got "
                             f"{tuple(uniforms.shape)}")
    for k in range(n_sweeps):
        red, black = fused_sweep(
            black, tables[k], seed=seed, sweep=k, periodic=periodic,
            uniforms=None if uniforms is None else uniforms[k])
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
    _check_on(blacks.device, blacks=blacks, tables=tables, keys=keys, uniforms=uniforms)

    lib = fused_sweep_library()
    B, R, C2 = blacks.shape
    reds_out = torch.empty_like(blacks)
    blacks_out = torch.empty_like(blacks)
    with torch.cuda.device(blacks.device):
        err = lib.tsu_fused_sweep_batched(
            blacks.data_ptr(), reds_out.data_ptr(), blacks_out.data_ptr(),
            tables.data_ptr(), keys.data_ptr(),
            None if uniforms is None else uniforms.data_ptr(),
            B, R, C2, int(periodic), int(blacks.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"batched fused sweep kernel launch failed with CUDA error {err}")
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
