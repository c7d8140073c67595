"""Fused full checkerboard sweep: both colours in one kernel launch.

Counterpart of ``tsu_tpu/ops/checkerboard_fused.py``. ``fused_sweep`` is the
wrapper of the hand-written CUDA kernel
(``tsu_tpu_torch/csrc/checkerboard_fused.cu``): on a CUDA tensor it launches
the kernel, on a CPU tensor it runs ``fused_sweep_reference``, the plain
PyTorch version, which the kernel matches bit for bit.

One sweep resamples red from black, then black from the new red, with the
heat-bath rule ``s = +1 if u < table[nbr + 4] else -1``: ``nbr`` is the
4-neighbour sum in {-4..4}, ``u`` a 16-bit uniform and ``table`` the 16-bit
thresholds of :func:`sigmoid_table16`. Uniforms come from the counter-based
Philox of ``tsu_tpu_torch/rng.py`` (lo16 of a site's word drives red, hi16
black) or are injected as (2, R, C2) int32 in [0, 2^16).
"""

from __future__ import annotations

import torch

from tsu_tpu_torch.ops._build import fused_sweep_library
from tsu_tpu_torch.ops.checkerboard import neighbor_sum_half
from tsu_tpu_torch.rng import MASK32, fold_seed, philox_words

_DTYPES = (torch.float32, torch.bfloat16)


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


def _check(black: torch.Tensor, table: torch.Tensor, uniforms):
    if black.dim() != 2 or black.dtype not in _DTYPES:
        raise ValueError(f"black must be a 2-D float32 or bfloat16 plane, got "
                         f"{tuple(black.shape)} {black.dtype}")
    R, C2 = black.shape
    if R < 2 or R % 2 or C2 < 1:
        raise ValueError(f"plane shape must be (even R >= 2, C/2 >= 1), got {(R, C2)}")
    if table.shape != (9,) or table.dtype != torch.int32:
        raise ValueError(f"table must be (9,) int32, got {tuple(table.shape)} {table.dtype}")
    if uniforms is not None and (uniforms.shape != (2, R, C2)
                                 or uniforms.dtype != torch.int32):
        raise ValueError(f"uniforms must be (2, {R}, {C2}) int32, got "
                         f"{tuple(uniforms.shape)} {uniforms.dtype}")


def _heatbath(nbr: torch.Tensor, u: torch.Tensor, table: torch.Tensor):
    return torch.where(u < table[nbr.long() + 4], 1.0, -1.0)


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
    table = table.to(black.device)
    red = _heatbath(neighbor_sum_half(black.float(), True, periodic), u_red, table)
    new_black = _heatbath(neighbor_sum_half(red, False, periodic), u_black, table)
    return red.to(black.dtype), new_black.to(black.dtype)


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
    for name, t in (("black", black), ("table", table), ("uniforms", uniforms)):
        if t is not None and (t.device != black.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {black.device}")

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
