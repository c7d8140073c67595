"""Bond half-sweeps (per-bond couplings) on the hand-written CUDA kernels.

Counterpart of ``tsu_tpu/ops/checkerboard_bonds_pallas.py``.
``bond_halfsweep`` (one lattice) and ``bond_halfsweep_batched`` (B replicas
sharing one bond set, each at its own temperature) wrap the kernels of
``tsu_tpu_torch/csrc/checkerboard_bonds.cu``: on a CUDA tensor they launch
the kernel, on a CPU tensor they run ``bond_halfsweep_reference`` or
``bond_halfsweep_batched_reference``, the plain PyTorch versions.

A half-sweep resamples one colour from the other colour's plane, in one of
two modes:

- continuous: ``weights`` is that colour's 5-tuple of (R, C/2) planes from
  :func:`~tsu_tpu_torch.ops.checkerboard_bonds.color_bond_weights` (float32
  or bfloat16, all of one dtype) and ``temperature`` a scalar;
  p = sigmoid(2 * local / T) in float32 and the site is +1 if
  u24 * 2^-24 < p. torch's, JAX's and CUDA's ``exp`` may differ by an ulp,
  so two right implementations may disagree where |u - p| is within
  ``CONTINUOUS_BAND``; everywhere else they agree;
- discrete: ``weights`` is that colour's uint8 code plane from
  :func:`~tsu_tpu_torch.ops.checkerboard_bonds.pack_bond_codes` and
  ``table`` the 9 int32 thresholds of
  :func:`~tsu_tpu_torch.ops.checkerboard_fused.sigmoid_table`; the site is
  +1 if u24 < table[local + 4]. Kernel and plain version agree bit for bit.

Uniforms are 24 bits: the top 24 bits of the site's Philox4x32-10 word at
counter (row, col // 4) under the launch's key, or injected (R, C/2) int32
in [0, 2^24). The sweep loops key the single-lattice kernel by
(fold_seed(seed, colour), sweep) and replica b of the batched one by
(fold_seed(seed_b), 2 * sweep + colour).
"""

from __future__ import annotations

import numpy as np
import torch

from tsu_tpu_torch.ops._build import bond_sweep_library
from tsu_tpu_torch.ops.checkerboard import wrap_halos
from tsu_tpu_torch.ops.checkerboard_bonds import _neighbor_values, local_field, pack_bond_codes
from tsu_tpu_torch.ops.checkerboard_fused import MAX_BATCH, _check_on, sigmoid_table
from tsu_tpu_torch.rng import MASK32, fold_seed, philox_words, sweep_keys

CONTINUOUS_BAND = 1e-6   # |u - p| within which implementations may disagree
MAX_ROWS = 8 * 65535     # the kernels' grid: 8 rows per block, gridDim.y <= 65535
_DTYPES = (torch.float32, torch.bfloat16)
_U24_SCALE = 1.0 / 16777216.0


def bond_key(seed: int, color: int, sweep: int):
    """Philox key (fold_seed(seed, colour), sweep) of the single-lattice
    kernel's half-sweep, as two uint32 ints; colour 0 is red, 1 black."""
    return fold_seed(seed, color) & MASK32, sweep & MASK32


def bond_sweep_keys(seeds, n_sweeps: int) -> torch.Tensor:
    """Keys (fold_seed(seed_b), 2k + colour) of the batched kernel for
    n_sweeps sweeps: seeds (..., B) give (..., n_sweeps, 2, B, 2) int32, row
    [..., k, colour] the key rows of sweep k's half-sweep of that colour."""
    seeds = np.asarray(seeds, np.int64)[..., None, None, :]
    counters = (2 * np.arange(n_sweeps)[:, None] + np.arange(2)[None, :])[..., None]
    return sweep_keys(seeds, counters)


def _check(other, weights, uniforms, *, batch=None, temps=None, table=None, keys=None):
    """Raise unless the operands fit a kernel: other (R, C2), or (B, R, C2)
    when ``batch`` is B; weights five planes or one uint8 code plane of
    (R, C2); table (9,) or (B, 9) int32 with codes, temps (B,) float32
    otherwise in the batched form; keys (B, 2) int32; uniforms like other,
    int32."""
    nd = 2 if batch is None else 3
    if other.dim() != nd or other.dtype not in _DTYPES:
        raise ValueError(f"the other plane must be {nd}-D float32 or bfloat16, got "
                         f"{tuple(other.shape)} {other.dtype}")
    *lead, R, C2 = other.shape
    if R < 2 or R % 2 or R > MAX_ROWS or C2 < 1:
        raise ValueError(f"plane shape must be (even R in 2..{MAX_ROWS}, C/2 >= 1), got {(R, C2)}")
    if lead and not 1 <= lead[0] <= MAX_BATCH:
        raise ValueError(f"a batched half-sweep takes 1 to {MAX_BATCH} replicas, got {lead[0]}")
    planes = (weights,) if isinstance(weights, torch.Tensor) else tuple(weights)
    packed = len(planes) == 1
    if packed and planes[0].dtype != torch.uint8 or not packed and (
            len(planes) != 5 or planes[0].dtype not in _DTYPES
            or any(w.dtype != planes[0].dtype for w in planes)):
        raise ValueError("weights must be five float32 or bfloat16 planes of one dtype, "
                         "or one uint8 code plane")
    if any(w.shape != (R, C2) for w in planes):
        raise ValueError(f"weight planes must be {(R, C2)}, got {[tuple(w.shape) for w in planes]}")
    if packed != (table is not None) or batch is not None and (temps is None) != packed:
        raise ValueError("a code plane takes a threshold table, weight planes a temperature")
    if table is not None and (table.shape != (*lead, 9) or table.dtype != torch.int32):
        raise ValueError(f"table must be {(*lead, 9)} int32, got {tuple(table.shape)} {table.dtype}")
    if temps is not None and (temps.shape != tuple(lead) or temps.dtype != torch.float32):
        raise ValueError(f"temperatures must be {tuple(lead)} float32, got "
                         f"{tuple(temps.shape)} {temps.dtype}")
    if keys is not None and (keys.shape != (*lead, 2) or keys.dtype != torch.int32):
        raise ValueError(f"keys must be {(*lead, 2)} int32, got {tuple(keys.shape)} {keys.dtype}")
    if uniforms is not None and (uniforms.shape != other.shape or uniforms.dtype != torch.int32):
        raise ValueError(f"uniforms must be {tuple(other.shape)} int32, got "
                         f"{tuple(uniforms.shape)} {uniforms.dtype}")
    return planes


def _packed_local(other, codes, update_red: bool, periodic: bool) -> torch.Tensor:
    """Integer local field in -4..4 from a code plane (int64)."""
    other = other.float()
    values = _neighbor_values(other, *wrap_halos(other, periodic), update_red)
    c = codes.to(torch.int32)
    local = sum((((c >> (2 * i)) & 3) - 1).float() * v for i, v in enumerate(values))
    return local.long()


def _u24(keys, R: int, C2: int, device) -> torch.Tensor:
    """24-bit uniforms from Philox under ``keys``: a (k0, k1) pair of ints,
    or a (B, 2) int32 tensor for B replicas."""
    if isinstance(keys, torch.Tensor):
        k = keys.to(device, torch.int64) & MASK32
        return philox_words(k[:, 0, None, None], k[:, 1, None, None], R, C2, device=device) >> 8
    return philox_words(keys[0], keys[1], R, C2, device=device) >> 8


def _plain(other, weights, update_red, periodic, u24, temps=None, table=None):
    if table is not None:
        local = _packed_local(other, weights, update_red, periodic)
        thresh = torch.gather(table.to(other.device), -1, (local + 4).flatten(-2)).view_as(local)
        plus = u24 < thresh
    else:
        local = local_field(other, weights, update_red, periodic)
        plus = u24.float() * _U24_SCALE < torch.sigmoid(2.0 * local / temps)
    return torch.where(plus, 1.0, -1.0).to(other.dtype)


def _temperature(temperature, device) -> torch.Tensor:
    # A tensor on the planes' device, so that the division by T is a true
    # division on every device (a CUDA tensor divided by a CPU scalar is
    # multiplied by its reciprocal).
    return torch.full((), float(temperature), dtype=torch.float32, device=device)


def bond_halfsweep_reference(other, weights, *, update_red: bool, key=(0, 0),
                             periodic: bool = True, temperature=None, table=None,
                             uniforms=None):
    """Plain PyTorch version of the single-lattice bond kernel; returns the
    new plane of the updated colour."""
    _check(other, weights, uniforms, table=table)
    if table is None and temperature is None:
        raise ValueError("weight planes take a temperature")
    R, C2 = other.shape
    u24 = uniforms if uniforms is not None else _u24(key, R, C2, other.device)
    temps = None if table is not None else _temperature(temperature, other.device)
    return _plain(other, weights, update_red, periodic, u24, temps, table)


def bond_halfsweep(other, weights, *, update_red: bool, key=(0, 0), periodic: bool = True,
                   temperature=None, table=None, uniforms=None):
    """One bond half-sweep of one lattice; returns the new plane of the
    updated colour (red if ``update_red``) in ``other``'s dtype.

    ``other``: (R, C2) float32 or bfloat16 plane of the other colour, R
    even. ``weights``/``temperature`` or ``weights``/``table``: the mode, as
    the module docstring says. ``key``: the Philox key (k0, k1) as ints
    (:func:`bond_key`); ``uniforms``: optional (R, C2) int32 replacing it. A
    CUDA tensor launches the kernel, and ``bond_halfsweep.launches`` grows
    by one; a CPU tensor runs :func:`bond_halfsweep_reference`.
    """
    if other.device.type == "cpu":
        return bond_halfsweep_reference(other, weights, update_red=update_red, key=key,
                                        periodic=periodic, temperature=temperature,
                                        table=table, uniforms=uniforms)
    if other.device.type != "cuda":
        raise ValueError(f"bond_halfsweep runs on cpu or cuda tensors, got {other.device}")
    planes = _check(other, weights, uniforms, table=table)
    _check_on(other.device, table=table, uniforms=uniforms,
              **{f"weights[{i}]": w for i, w in enumerate(planes)})
    wkind = 2 if table is not None else int(planes[0].dtype == torch.bfloat16)
    ptrs = [w.data_ptr() for w in planes] + [None] * (5 - len(planes))
    R, C2 = other.shape
    out = torch.empty_like(other)
    with torch.cuda.device(other.device):
        err = bond_sweep_library().tsu_bond_halfsweep(
            other.data_ptr(), out.data_ptr(), *ptrs, wkind,
            int(other.dtype == torch.bfloat16), 1.0 if temperature is None else float(temperature),
            None if table is None else table.data_ptr(),
            None if uniforms is None else uniforms.data_ptr(), R, C2, int(update_red),
            int(periodic), key[0] & MASK32, key[1] & MASK32,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"bond half-sweep kernel launch failed with CUDA error {err}")
    bond_halfsweep.launches += 1
    return out


bond_halfsweep.launches = 0


def bond_halfsweep_batched_reference(others, weights, keys, *, update_red: bool,
                                     periodic: bool = True, temperatures=None,
                                     tables=None, uniforms=None):
    """Plain PyTorch version of the batched bond kernel. Element b equals
    :func:`bond_halfsweep_reference` under key row b and temperature b (or
    table row b)."""
    _check(others, weights, uniforms, batch=True, temps=temperatures, table=tables, keys=keys)
    _, R, C2 = others.shape
    u24 = uniforms if uniforms is not None else _u24(keys, R, C2, others.device)
    temps = None if temperatures is None else temperatures.to(others.device)[:, None, None]
    return _plain(others, weights, update_red, periodic, u24, temps, tables)


def bond_halfsweep_batched(others, weights, keys, *, update_red: bool, periodic: bool = True,
                           temperatures=None, tables=None, uniforms=None):
    """One bond half-sweep of B replicas sharing one bond set, in one
    launch; returns the new (B, R, C2) planes of the updated colour.

    ``others``: (B, R, C2) float32 or bfloat16, 1 <= B <= MAX_BATCH.
    ``weights``: the shared weight planes or code plane. ``temperatures``:
    (B,) float32 (continuous) or ``tables``: (B, 9) int32 (codes), row b for
    replica b. ``keys``: (B, 2) int32 Philox key rows
    (:func:`bond_sweep_keys`). ``uniforms``: optional (B, R, C2) int32. A
    CUDA tensor launches the kernel, and ``bond_halfsweep_batched.launches``
    grows by one; a CPU tensor runs :func:`bond_halfsweep_batched_reference`.
    Temperatures, tables and keys are taken as they lie: callers upload them
    once per call, not per launch.
    """
    if others.device.type == "cpu":
        return bond_halfsweep_batched_reference(
            others, weights, keys, update_red=update_red, periodic=periodic,
            temperatures=temperatures, tables=tables, uniforms=uniforms)
    if others.device.type != "cuda":
        raise ValueError(f"bond_halfsweep_batched runs on cpu or cuda tensors, got {others.device}")
    planes = _check(others, weights, uniforms, batch=True, temps=temperatures, table=tables,
                    keys=keys)
    _check_on(others.device, temperatures=temperatures, tables=tables, keys=keys,
              uniforms=uniforms, **{f"weights[{i}]": w for i, w in enumerate(planes)})
    wkind = 2 if tables is not None else int(planes[0].dtype == torch.bfloat16)
    ptrs = [w.data_ptr() for w in planes] + [None] * (5 - len(planes))
    B, R, C2 = others.shape
    out = torch.empty_like(others)
    with torch.cuda.device(others.device):
        err = bond_sweep_library().tsu_bond_halfsweep_batched(
            others.data_ptr(), out.data_ptr(), *ptrs, wkind,
            int(others.dtype == torch.bfloat16),
            None if temperatures is None else temperatures.data_ptr(),
            None if tables is None else tables.data_ptr(), keys.data_ptr(),
            None if uniforms is None else uniforms.data_ptr(), B, R, C2, int(update_red),
            int(periodic), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"batched bond half-sweep kernel launch failed with CUDA error {err}")
    bond_halfsweep_batched.launches += 1
    return out


bond_halfsweep_batched.launches = 0


def continuous_band(other, weights, *, update_red: bool, temperature, key=(0, 0),
                    periodic: bool = True, uniforms=None) -> torch.Tensor:
    """Boolean mask of the sites of a continuous half-sweep whose uniform
    lies within CONTINUOUS_BAND of its probability, where implementations
    of ``exp`` may disagree. ``other`` is (R, C2), or (B, R, C2) with
    ``temperature`` (B,) and ``key`` a (B, 2) tensor of key rows."""
    *lead, R, C2 = other.shape
    u24 = uniforms if uniforms is not None else _u24(key, R, C2, other.device)
    temps = torch.as_tensor(temperature, dtype=torch.float32).to(other.device)
    temps = temps.reshape(*lead, 1, 1) if lead else temps
    p = torch.sigmoid(2.0 * local_field(other, weights, update_red, periodic) / temps)
    return (u24.double() * _U24_SCALE - p.double()).abs() <= CONTINUOUS_BAND


def bond_kernel_weights(weights: dict, discrete: bool) -> dict:
    """The kernels' form of a ``{"red", "black"}`` bond dict: the code
    planes for the discrete mode (packing weight planes), the weight planes
    as they are for the continuous one."""
    if isinstance(weights["red"], torch.Tensor):
        if not discrete:
            raise ValueError("code planes run only in the discrete mode")
        return weights
    return pack_bond_codes(weights) if discrete else weights


def bond_sweeps(red, black, weights: dict, keys, *, temperatures=None, tables=None,
                periodic: bool = True, uniforms=None):
    """len(keys) full sweeps of one lattice (red, then black) on the
    single-lattice kernel; returns (red, black).

    ``weights``: kernel form (:func:`bond_kernel_weights`) on the planes'
    device. ``keys``: (n, 2, 2) ints, keys[k][colour] the key of sweep k's
    half-sweep of that colour. ``temperatures``: n floats (continuous), or
    ``tables``: (n, 9) int32 on the device (codes). ``uniforms``: optional
    (n, 2, R, C2) int32.
    """
    for k in range(len(keys)):
        mode = ({"table": tables[k]} if tables is not None
                else {"temperature": float(temperatures[k])})
        u = (None, None) if uniforms is None else uniforms[k]
        red = bond_halfsweep(black, weights["red"], update_red=True, key=tuple(keys[k][0]),
                             periodic=periodic, uniforms=u[0], **mode)
        black = bond_halfsweep(red, weights["black"], update_red=False, key=tuple(keys[k][1]),
                               periodic=periodic, uniforms=u[1], **mode)
    return red, black


def checkerboard_sweeps_bonds_kernel(seed: int, red, black, weights: dict, temperature,
                                     n_sweeps: int, *, periodic: bool = True,
                                     discrete: bool = False, pure: bool = False,
                                     uniforms=None):
    """n_sweeps full bond sweeps of one lattice; returns (red, black).

    ``weights``: ``{"red", "black"}`` from ``color_bond_weights`` (packed
    here when ``discrete``) or from ``pack_bond_codes`` (``discrete``
    only). ``temperature``: a scalar or an (n_sweeps,) schedule. Sweep k's
    half-sweep of colour c draws from (fold_seed(seed, c), k). ``pure``
    (every bond +-1, periodic) is accepted for the JAX signature: the
    9-entry table gives the 5-entry parity table's bits. ``uniforms``:
    optional (n_sweeps, 2, R, C2) int32 in [0, 2^24). The tables go to the
    device in one copy.
    """
    del pure
    temps = np.broadcast_to(np.asarray(temperature, np.float32).reshape(-1), (n_sweeps,))
    weights = bond_kernel_weights(weights, discrete)
    tables = None
    if discrete:
        tables = sigmoid_table(1.0, 0.0, torch.from_numpy(temps.copy())).to(black.device)
    keys = [[bond_key(seed, c, k) for c in (0, 1)] for k in range(n_sweeps)]
    if uniforms is not None:
        uniforms = torch.as_tensor(uniforms, dtype=torch.int32, device=black.device)
        if uniforms.shape != (n_sweeps, 2, *black.shape):
            raise ValueError(f"uniforms must be (n_sweeps, 2, R, C2), got {tuple(uniforms.shape)}")
    return bond_sweeps(red, black, weights, keys, temperatures=temps, tables=tables,
                       periodic=periodic, uniforms=uniforms)


def bond_sweeps_keyed(reds, blacks, weights: dict, keys, *, temperatures=None, tables=None,
                      periodic: bool = True, uniforms=None):
    """len(keys) full sweeps of B replicas on the batched kernel, with keys
    and temperatures or tables built beforehand; returns (reds, blacks), the
    inputs when there is no sweep.

    ``keys``: (n, 2, B, 2) int32 (:func:`bond_sweep_keys`). ``temperatures``:
    (B,) or (n, B) float32; ``tables``: (B, 9) or (n, B, 9) int32, row k for
    sweep k. ``uniforms``: optional (n, B, 2, R, C2) int32. All lie on the
    planes' device, so a sweep copies nothing to it.
    """
    name, mode = (("temperatures", temperatures) if temperatures is not None
                  else ("tables", tables))
    per_sweep = mode.dim() == (2 if temperatures is not None else 3)
    for k in range(keys.shape[0]):
        kw = {name: mode[k] if per_sweep else mode}
        u = (None, None) if uniforms is None else (uniforms[k, :, 0].contiguous(),
                                                   uniforms[k, :, 1].contiguous())
        reds = bond_halfsweep_batched(blacks, weights["red"], keys[k, 0], update_red=True,
                                      periodic=periodic, uniforms=u[0], **kw)
        blacks = bond_halfsweep_batched(reds, weights["black"], keys[k, 1], update_red=False,
                                        periodic=periodic, uniforms=u[1], **kw)
    return reds, blacks


def bond_modes(temperatures, discrete: bool, device):
    """``{"temperatures": float32}`` or ``{"tables": int32 sigmoid_table}``
    for temperatures of any shape, on ``device``: the mode arguments of
    :func:`bond_sweeps_keyed`."""
    temps = torch.tensor(np.asarray(temperatures, np.float32))
    if discrete:
        return {"tables": sigmoid_table(1.0, 0.0, temps).to(device)}
    return {"temperatures": temps.to(device)}


def checkerboard_sweeps_bonds_batched(seeds, reds, blacks, weights: dict, temperatures,
                                      n_sweeps: int, *, periodic: bool = True,
                                      discrete: bool = False, pure: bool = False,
                                      uniforms=None):
    """n_sweeps full bond sweeps of B replicas sharing one bond set, one
    batched launch per half-sweep; returns (reds, blacks).

    ``seeds``: (B,) distinct per-replica stream ids: sweep k's half-sweep of
    colour c draws from (fold_seed(seeds[b]), 2k + c). ``temperatures``: a
    scalar, (B,), or an (n_sweeps, B) schedule. ``weights``, ``discrete``
    and ``pure`` as in :func:`checkerboard_sweeps_bonds_kernel`.
    ``uniforms``: optional (n_sweeps, B, 2, R, C2) int32. Keys and
    temperatures or tables go to the device in one copy each.
    """
    del pure
    B = reds.shape[0]
    seeds = np.asarray(seeds.cpu() if isinstance(seeds, torch.Tensor) else seeds, np.int64)
    if seeds.shape != (B,):
        raise ValueError(f"seeds must be ({B},), got {seeds.shape}")
    temps = np.asarray(temperatures, np.float32)
    temps = np.broadcast_to(temps, (n_sweeps, B) if temps.ndim == 2 else (B,))
    weights = bond_kernel_weights(weights, discrete)
    keys = bond_sweep_keys(seeds, n_sweeps).to(blacks.device)
    if uniforms is not None:
        uniforms = torch.as_tensor(uniforms, dtype=torch.int32, device=blacks.device)
        if uniforms.shape != (n_sweeps, B, 2, *blacks.shape[1:]):
            raise ValueError(f"uniforms must be (n_sweeps, B, 2, R, C2), got "
                             f"{tuple(uniforms.shape)}")
    return bond_sweeps_keyed(reds, blacks, weights, keys, periodic=periodic, uniforms=uniforms,
                             **bond_modes(temps, discrete, blacks.device))
