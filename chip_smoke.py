#!/usr/bin/env python3
"""Drive the PyTorch port (tsu_tpu_torch) once on one NVIDIA GPU and check it.

Run from the repository root:

    python3 chip_smoke.py

Phases, each of which raises on failure:
 1. print the card (nvidia-smi name and power limit), torch and CUDA versions,
    and build the fused-sweep kernel from tsu_tpu_torch/csrc;
 2. kernel against its plain PyTorch version with injected uniforms, bit for
    bit: 3 sweeps over a temperature schedule at 4096^2 bf16 periodic and at
    1002x1000 f32 open;
 3. the same in Philox mode: 2 sweeps at 4096^2 bf16;
 4. statistics: 4x4 periodic at T=2.5 against exact enumeration, T=1e9 at
    1024^2 against m=0, T=2.0 at 512^2 against Onsager's magnetization;
 5. the main path, IsingGrid((4096, 4096), periodic=True).sample(...), with
    a count of kernel launches;
 6. kernel and plain times per sweep at 4096^2 bf16, timed with CUDA events.

The last two lines are a JSON line per kernel and the result line
{"ok": true, "device": {...}}. Without CUDA the script exits non-zero before
printing either.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from tsu_tpu_torch import IsingConfig, IsingGrid
from tsu_tpu_torch.ops import _build
from tsu_tpu_torch.ops.checkerboard import split_checkerboard
from tsu_tpu_torch.ops.checkerboard_fused import (
    fused_sweep,
    fused_sweep_reference,
    fused_sweeps,
    sigmoid_table16,
)

MAIN_SHAPE = (4096, 4096)
SCHEDULE = [2.269, 4.0, 0.5]


def log(msg: str):
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0].strip()


def random_black(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    up = torch.rand(shape, generator=gen) < 0.5
    lat = torch.where(up, 1.0, -1.0).to(dtype)
    return split_checkerboard(lat)[1].contiguous().to(device)


def compare_chains(black, temps, periodic, uniforms=None, seed=0) -> float:
    """Run kernel and plain version sweep by sweep from one input; raise
    unless every plane agrees bit for bit. Returns the max abs difference."""
    b_k = b_p = black
    err = 0.0
    for k, T in enumerate(temps):
        table = sigmoid_table16(1.0, 0.1, T).to(black.device)
        u = None if uniforms is None else uniforms[k]
        r_k, b_k = fused_sweep(b_k, table, seed=seed, sweep=k, periodic=periodic, uniforms=u)
        r_p, b_p = fused_sweep_reference(b_p, table, seed=seed, sweep=k,
                                         periodic=periodic, uniforms=u)
        for a, b in ((r_k, r_p), (b_k, b_p)):
            err = max(err, float((a.float() - b.float()).abs().max()))
            if not torch.equal(a, b):
                raise AssertionError(
                    f"kernel != plain at sweep {k}: {int((a != b).sum())} sites differ "
                    f"(shape {tuple(black.shape)}, {black.dtype}, periodic={periodic}, "
                    f"injected={uniforms is not None})")
    torch.cuda.synchronize()
    return err


def batch_means(x: np.ndarray, n_batches: int = 50):
    b = x[: len(x) // n_batches * n_batches].reshape(n_batches, -1).mean(axis=1)
    return float(b.mean()), float(b.std(ddof=1) / np.sqrt(n_batches))


def exact_4x4(T: float):
    """<|m|> and <e> per site of the 4x4 periodic lattice by enumerating all
    2^16 states."""
    bits = (np.arange(2**16)[:, None] >> np.arange(16)) & 1
    s = (2 * bits - 1).reshape(-1, 4, 4).astype(np.float64)
    E = -(s * np.roll(s, -1, 2)).sum((1, 2)) - (s * np.roll(s, -1, 1)).sum((1, 2))
    w = np.exp(-(E - E.min()) / T)
    w /= w.sum()
    return float(w @ np.abs(s.mean((1, 2)))), float(w @ E) / 16


def phase_statistics(dev):
    T = 2.5
    grid = IsingGrid((4, 4), periodic=True, seed=1, device=dev,
                     config=IsingConfig(n_burnin=100, n_sweeps=1))
    s = grid.sample(n_samples=20000, temperature=T)
    m, se_m = batch_means(np.abs(s.mean(axis=1)).astype(np.float64))
    e, se_e = batch_means(grid.energies(s) / 16)
    m_x, e_x = exact_4x4(T)
    log(f"4x4 T=2.5: <|m|> {m:.5f} +- {se_m:.5f} (exact {m_x:.5f}); "
        f"<e> {e:.5f} +- {se_e:.5f} (exact {e_x:.5f})")
    if abs(m - m_x) > 4 * se_m or abs(e - e_x) > 4 * se_e:
        raise AssertionError("4x4 moments differ from exact enumeration by more than 4 SE")

    s = IsingGrid((1024, 1024), periodic=True, seed=2, device=dev,
                  config=IsingConfig(n_burnin=5, n_sweeps=1)).sample(
        n_samples=2, temperature=1e9)
    m_hot = float(np.abs(s.mean(axis=1)).max())
    log(f"1024^2 T=1e9: max |m| {m_hot:.6f}")
    if m_hot >= 0.01 or np.all(s == s[:, :1]):
        raise AssertionError("infinite-temperature lattice is not disordered")

    T = 2.0
    onsager = (1.0 - np.sinh(2.0 / T) ** -4) ** 0.125
    s = IsingGrid((512, 512), periodic=True, seed=3, device=dev,
                  config=IsingConfig(n_burnin=200, n_sweeps=5)).sample(
        n_samples=40, initial_state=np.ones(512 * 512), temperature=T)
    m = float(np.abs(s.mean(axis=1)).mean())
    log(f"512^2 T=2.0 ordered start: <|m|> {m:.5f} (Onsager {onsager:.5f})")
    if abs(m - onsager) > 0.01:
        raise AssertionError("512^2 magnetization differs from Onsager's by more than 0.01")


def phase_main_path(dev):
    cfg = IsingConfig()
    n_samples = 4
    fused_sweep.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = IsingGrid(MAIN_SHAPE, periodic=True, seed=0, device=dev)
    states = grid.sample(n_samples=n_samples, temperature=2.269)
    wall = time.perf_counter() - t0
    launches = fused_sweep.launches
    sweeps = cfg.n_burnin + n_samples * cfg.n_sweeps
    n = MAIN_SHAPE[0] * MAIN_SHAPE[1]
    log(f"main path: IsingGrid({MAIN_SHAPE}).sample(4) {wall:.3f} s wall, "
        f"{launches} launches for {sweeps} sweeps, "
        f"{sweeps * n / wall:.4e} flips/s end to end (init and copy-out included)")
    if launches != sweeps:
        raise AssertionError(f"expected {sweeps} kernel launches, counted {launches}")
    if states.shape != (n_samples, n) or not np.all(np.abs(states) == 1.0):
        raise AssertionError(f"bad states: shape {states.shape}")
    e = grid.energies(states) / n
    m = states.mean(axis=1)
    log(f"main path: e/site {e.tolist()}, m {m.tolist()}")
    if not (np.all(np.isfinite(e)) and np.all((e > -2.0) & (e < -1.0))):
        raise AssertionError("energy per site outside (-2, -1) after 140 sweeps at T_c")

    small = dict(periodic=True, seed=5, config=IsingConfig(n_burnin=20, n_sweeps=2))
    a = IsingGrid((64, 48), device=dev, **small).sample(3, temperature=2.269)
    b = IsingGrid((64, 48), device="cpu", **small).sample(3, temperature=2.269)
    if not np.array_equal(a, b):
        raise AssertionError("IsingGrid on cuda and on cpu differ for one seed")
    log("main path: 64x48 samples on cuda equal those on cpu bit for bit")
    return launches


def time_sweeps(fn, n: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn(n)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_timing(dev, name):
    gen = torch.Generator().manual_seed(6)
    black = random_black(gen, MAIN_SHAPE, torch.bfloat16, dev)
    red = torch.empty_like(black)
    table = sigmoid_table16(1.0, 0.0, 2.269).to(dev)

    def kernel(n):
        fused_sweeps(7, red, black, 2.269, n, periodic=True)

    def plain(n):
        b = black
        for k in range(n):
            _, b = fused_sweep_reference(b, table, seed=7, sweep=k, periodic=True)

    kernel(10)
    plain(2)
    ms = time_sweeps(kernel, 1000)
    plain_ms = time_sweeps(plain, 20)
    n = MAIN_SHAPE[0] * MAIN_SHAPE[1]
    log(f"timing 4096^2 bf16 periodic on {name}: kernel {ms:.6f} ms/sweep "
        f"({n / ms * 1e3:.4e} flips/s, 1000 sweeps), plain {plain_ms:.6f} ms/sweep "
        f"({n / plain_ms * 1e3:.4e} flips/s, 20 sweeps)")
    return ms, plain_ms


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    name = card()
    log(name)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.fused_sweep_library()
    log(f"phase 1: built the fused-sweep kernel in {time.perf_counter() - t0:.2f} s")

    gen = torch.Generator().manual_seed(0)
    cgen = torch.Generator(device=dev).manual_seed(0)
    err = 0.0
    for shape, dtype, periodic in ((MAIN_SHAPE, torch.bfloat16, True),
                                   ((1002, 1000), torch.float32, False)):
        black = random_black(gen, shape, dtype, dev)
        U = torch.randint(0, 1 << 16, (3, 2, shape[0], shape[1] // 2),
                          generator=cgen, device=dev, dtype=torch.int32)
        err = max(err, compare_chains(black, SCHEDULE, periodic, U))
        log(f"phase 2: injected uniforms, {shape} {dtype} periodic={periodic}: "
            "kernel == plain over 3 sweeps")
    black = random_black(gen, MAIN_SHAPE, torch.bfloat16, dev)
    err = max(err, compare_chains(black, SCHEDULE[:2], True, seed=11))
    log(f"phase 3: Philox mode, {MAIN_SHAPE} bf16: kernel == plain over 2 sweeps")

    phase_statistics(dev)
    log("phase 4: statistics agree with the exact references")

    launches = phase_main_path(dev)
    log("phase 5: main path ran through the kernel")

    ms, plain_ms = phase_timing(dev, name)
    log("phase 6: timed")

    print(json.dumps({"kernels": [{
        "name": "fused_sweep",
        "route": "cuda",
        "source": "tsu_tpu_torch/csrc/checkerboard_fused.cu",
        "replaces": "tsu_tpu/ops/checkerboard_fused.py:136",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
