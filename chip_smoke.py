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
 6. kernel and plain times per sweep at 4096^2 bf16, timed with CUDA events;
 7. the batched kernel against its plain version, bit for bit, at the shape
    and tables of each batched path: injected uniforms over 3 sweeps and
    Philox mode over 2 at 16 x 1024^2 bf16 (the phase scan's 16
    temperatures), 2 x 4096^2 bf16 (rows of the anneal's schedule, keyed by
    its global sweep counter) and 64 x 256^2 bf16 (the tempering ladder);
    injected uniforms at 3 x 1002x1000 f32 open; and element b of one
    batched launch against the single-lattice kernel under seed b;
 8. statistics of the batched paths: a 4x4 ensemble and the cold rung of a
    4x4 tempering ladder against exact enumeration, decorrelated members at
    one temperature, a 16x16 anneal to the ground state;
 9. the batched paths at full size, each with its launch counts and wall
    time: the phase scan (16 x 1024^2), IsingGrid((4096, 4096))
    .find_ground_state(1000) and tempering over 64 rungs of 256^2, with
    physics checks, and each at 16x16 equal on cuda and on cpu;
10. batched kernel and plain times per sweep at 16 x 1024^2 bf16.

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

from tsu_tpu_torch import IsingConfig, IsingGrid, demonstrate_phase_transition
from tsu_tpu_torch.models.lattice_sampler import sample_grid_ensemble
from tsu_tpu_torch.ops import _build
from tsu_tpu_torch.ops.checkerboard import lattice_energy_batch, split_checkerboard
from tsu_tpu_torch.ops.checkerboard_fused import (
    fused_sweep,
    fused_sweep_batched,
    fused_sweep_batched_reference,
    fused_sweep_reference,
    fused_sweeps,
    sigmoid_table16,
)
from tsu_tpu_torch.rng import sweep_keys
from tsu_tpu_torch.samplers import make_schedule, parallel_tempering_lattice

MAIN_SHAPE = (4096, 4096)
SCHEDULE = [2.269, 4.0, 0.5]
ENSEMBLE = (16, 1024, 1024)              # the phase scan's batch: 16 x 1024^2
SCAN_TEMPS = np.linspace(1.5, 3.5, ENSEMBLE[0])
PT_SHAPE, PT_RUNGS = (256, 256), 64


def log(msg: str):
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0].strip()


def reset_counts():
    fused_sweep.launches = 0
    fused_sweep_batched.launches = 0


def counts():
    return fused_sweep.launches, fused_sweep_batched.launches


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
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = IsingGrid(MAIN_SHAPE, periodic=True, seed=0, device=dev)
    states = grid.sample(n_samples=n_samples, temperature=2.269)
    wall = time.perf_counter() - t0
    launches, batched = counts()
    sweeps = cfg.n_burnin + n_samples * cfg.n_sweeps
    n = MAIN_SHAPE[0] * MAIN_SHAPE[1]
    log(f"main path: IsingGrid({MAIN_SHAPE}).sample(4) {wall:.3f} s wall, "
        f"{launches} launches for {sweeps} sweeps, "
        f"{sweeps * n / wall:.4e} flips/s end to end (init and copy-out included)")
    if (launches, batched) != (sweeps, 0):
        raise AssertionError(f"expected {sweeps} kernel launches and 0 batched, counted "
                             f"{launches} and {batched}")
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


def compare_batched(blacks, temps, periodic, seeds, sweeps, uniforms=None) -> float:
    """Run the batched kernel and its plain version sweep by sweep from one
    input; raise unless every plane agrees bit for bit. Returns the max abs
    difference.

    Sweep k of lattice b runs at temps[b], or temps[k, b] for a 2-D temps,
    under the key (fold_seed(seeds[b]), sweeps[k, b]); ``sweeps`` is (n, 1)
    or (n, B)."""
    tables = sigmoid_table16(1.0, 0.1, torch.as_tensor(temps, dtype=torch.float32))
    tables = tables.to(blacks.device)
    keys = sweep_keys(np.asarray(seeds)[None, :], sweeps).to(blacks.device)
    b_k = b_p = blacks
    err = 0.0
    for k in range(len(keys)):
        u = None if uniforms is None else uniforms[k]
        t = tables if tables.dim() == 2 else tables[k]
        r_k, b_k = fused_sweep_batched(b_k, t, keys[k], periodic=periodic, uniforms=u)
        r_p, b_p = fused_sweep_batched_reference(b_p, t, keys[k], periodic=periodic,
                                                 uniforms=u)
        for a, b in ((r_k, r_p), (b_k, b_p)):
            err = max(err, float((a.float() - b.float()).abs().max()))
            if not torch.equal(a, b):
                raise AssertionError(
                    f"batched kernel != plain at sweep {k}: {int((a != b).sum())} sites "
                    f"differ (shape {tuple(blacks.shape)}, {blacks.dtype}, "
                    f"periodic={periodic}, injected={uniforms is not None})")
    torch.cuda.synchronize()
    return err


def phase_batched_exact(dev, gen, cgen) -> float:
    # Each shape a batched path launches at, with its tables: the phase scan's
    # 16 temperatures; the anneal's schedule, a different row per lattice and
    # sweep, keyed by the global sweep counter; the tempering ladder. Then an
    # open f32 batch with a ragged last tile.
    at = np.array([[0, 999], [500, 830], [830, 500]])    # sweeps of a 1000-step anneal
    cases = [
        (ENSEMBLE, torch.bfloat16, True, SCAN_TEMPS, np.arange(3)[:, None]),
        ((2, *MAIN_SHAPE), torch.bfloat16, True, make_schedule(5.0, 0.05, 1000)[at], at),
        ((PT_RUNGS, *PT_SHAPE), torch.bfloat16, True, np.geomspace(1.8, 3.0, PT_RUNGS),
         np.arange(3)[:, None]),
        ((3, 1002, 1000), torch.float32, False, SCHEDULE, np.arange(3)[:, None]),
    ]
    err = 0.0
    for shape, dtype, periodic, temps, sweeps in cases:
        B, R, C = shape
        blacks = random_black(gen, shape, dtype, dev)
        U = torch.randint(0, 1 << 16, (3, B, 2, R, C // 2), generator=cgen, device=dev,
                          dtype=torch.int32)
        err = max(err, compare_batched(blacks, temps, periodic, np.arange(B), sweeps, U))
        del U
        log(f"phase 7: injected uniforms, {shape} {dtype} periodic={periodic}: "
            "kernel == plain over 3 sweeps")
        if periodic:
            seeds = torch.randint(0, 2**30, (B,), generator=gen).numpy()
            temps2 = temps[:2] if np.ndim(temps) == 2 else temps
            err = max(err, compare_batched(blacks, temps2, periodic, seeds, sweeps[:2]))
            log(f"phase 7: Philox mode, {shape} {dtype}: kernel == plain over 2 sweeps")

    B = ENSEMBLE[0]
    blacks = random_black(gen, ENSEMBLE, torch.bfloat16, dev)
    seeds = 1000 + 7 * np.arange(B)
    sweep = 3
    tables = sigmoid_table16(1.0, 0.0, torch.as_tensor(SCAN_TEMPS, dtype=torch.float32)).to(dev)
    keys = sweep_keys(seeds, sweep).to(dev)
    reds, news = fused_sweep_batched(blacks, tables, keys, periodic=True)
    for b in range(B):
        r1, b1 = fused_sweep(blacks[b], tables[b], seed=int(seeds[b]), sweep=sweep,
                             periodic=True)
        if not (torch.equal(r1, reds[b]) and torch.equal(b1, news[b])):
            raise AssertionError(f"batched kernel element {b} != single-lattice kernel")
        err = max(err, float((r1.float() - reds[b].float()).abs().max()),
                  float((b1.float() - news[b].float()).abs().max()))
    torch.cuda.synchronize()
    log(f"phase 7: each of the {B} elements of one batched launch == the "
        "single-lattice kernel under its seed")
    return err


def phase_batched_statistics(dev):
    T = 2.5
    gen = torch.Generator().manual_seed(21)
    out = sample_grid_ensemble(gen, torch.ones((8, 4, 4), device=dev), T,
                               n_samples=4000, n_burnin=100)
    m, se_m = batch_means(out["magnetization"].abs().mean(1).cpu().numpy())
    e, se_e = batch_means(out["energy"].mean(1).cpu().numpy() / 16)
    m_x, e_x = exact_4x4(T)
    log(f"ensemble 8 x 4x4 T=2.5: <|m|> {m:.5f} +- {se_m:.5f} (exact {m_x:.5f}); "
        f"<e> {e:.5f} +- {se_e:.5f} (exact {e_x:.5f})")
    if abs(m - m_x) > 4 * se_m or abs(e - e_x) > 4 * se_e:
        raise AssertionError("ensemble moments differ from exact enumeration by more than 4 SE")

    out = sample_grid_ensemble(gen, torch.ones((2, 8, 8), device=dev), [2.8, 2.8],
                               n_samples=40, n_burnin=30)
    m = out["magnetization"].cpu().numpy()
    if np.allclose(m[:, 0], m[:, 1]):
        raise AssertionError("ensemble members at one temperature gave the same trace")
    log("ensemble: two members at T=2.8 give different traces")

    T = 2.0
    cold, info = parallel_tempering_lattice(gen, (4, 4), temperatures=np.linspace(2.0, 3.0, 4),
                                            n_samples=5000, swap_interval=1, n_burnin=100,
                                            device=dev)
    m, se_m = batch_means(cold.double().mean((1, 2)).abs().cpu().numpy())
    e, se_e = batch_means(lattice_energy_batch(cold).cpu().numpy() / 16)
    m_x, e_x = exact_4x4(T)
    log(f"tempering 4 rungs 4x4, cold rung T=2.0: <|m|> {m:.5f} +- {se_m:.5f} "
        f"(exact {m_x:.5f}); <e> {e:.5f} +- {se_e:.5f} (exact {e_x:.5f}); swap "
        f"acceptance {info['swap_acceptance_rate']:.4f}")
    if abs(m - m_x) > 4 * se_m or abs(e - e_x) > 4 * se_e:
        raise AssertionError("cold rung differs from exact enumeration by more than 4 SE")

    _, e = IsingGrid((16, 16), periodic=True, seed=8, device=dev).find_ground_state(2000)
    log(f"16x16 anneal: best E {e}")
    if e != -512.0:
        raise AssertionError(f"16x16 anneal reached E = {e}, not the ground state -512")


def run_path(what, fn, want_batched):
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = counts()
    log(f"path {what}: {wall:.3f} s wall, {k2} batched launches, {k1} single-lattice")
    if (k1, k2) != (0, want_batched):
        raise AssertionError(f"{what}: expected {want_batched} batched launches and 0 "
                             f"single-lattice, counted {k2} and {k1}")
    return out, k2


def same_on_cpu(what, fn, dev):
    a, b = fn(dev), fn(torch.device("cpu"))
    for x, y in zip(a, b):
        if not np.array_equal(np.asarray(x), np.asarray(y)):
            raise AssertionError(f"{what} at 16x16 differs between cuda and cpu for one seed")
    log(f"path {what}: 16x16 output on cuda equals that on cpu")


def phase_batched_paths(dev) -> int:
    size = ENSEMBLE[1]
    res, n_scan = run_path(f"phase scan {ENSEMBLE[0]} x {size}^2", lambda: (
        demonstrate_phase_transition(sizes=[size], temperatures=SCAN_TEMPS, n_samples=64,
                                     seed=0, device=dev)[size]), 200 + 64 * 2)
    T_c = 2.0 / np.log(1.0 + np.sqrt(2.0))
    M = res["magnetization"]
    log(f"phase scan: T {np.round(SCAN_TEMPS, 4).tolist()}")
    log(f"phase scan: |M| {M.tolist()}")
    for T, m in zip(SCAN_TEMPS, M):
        onsager = (1.0 - np.sinh(2.0 / T) ** -4) ** 0.125 if T < T_c else 0.0
        if (T <= 2.0 and abs(m - onsager) > 0.01) or (T >= 3.0 and m >= 0.05):
            raise AssertionError(f"phase scan |M| {m} at T={T} (Onsager {onsager})")

    grid = IsingGrid(MAIN_SHAPE, periodic=True, seed=0, device=dev)
    (state, e), n_anneal = run_path(f"ground state 2 x {MAIN_SHAPE}, 1000 steps",
                                    lambda: grid.find_ground_state(n_steps=1000), 1000)
    n = MAIN_SHAPE[0] * MAIN_SHAPE[1]
    log(f"anneal: best e/site {e / n}")
    if not e / n < -1.85 or grid.energy(state) != e or state.shape != (n,):
        raise AssertionError(f"anneal: e/site {e / n}, energy of the returned state "
                             f"{grid.energy(state)}, shape {state.shape}")

    R = PT_RUNGS
    (cold, info), n_pt = run_path(f"tempering {R} x {PT_SHAPE}, 300 rounds", lambda: (
        parallel_tempering_lattice(torch.Generator().manual_seed(0), PT_SHAPE,
                                   temperatures=np.geomspace(1.8, 3.0, R), n_samples=200,
                                   swap_interval=10, n_burnin=100, device=dev)), 300)
    rung_e = info["energies"][100:].mean(0)
    log(f"tempering: {info['swap_accepts']} of {info['swap_attempts']} swaps accepted; "
        f"mean E of the 8 coldest rungs {rung_e[:8].mean()}, of the 8 hottest {rung_e[-8:].mean()}")
    shapes = {"cold": tuple(cold.shape), "energies": info["energies"].shape,
              "final_states": info["final_states"].shape,
              "pair_acceptance": info["pair_acceptance"].shape,
              "pair_attempts": info["pair_attempts"].shape}
    if shapes != {"cold": (200, *PT_SHAPE), "energies": (300, R),
                  "final_states": (R, *PT_SHAPE), "pair_acceptance": (R - 1,),
                  "pair_attempts": (R - 1,)}:
        raise AssertionError(f"tempering: shapes {shapes}")
    if info["swap_accepts"] <= 0 or not rung_e[:8].mean() < rung_e[-8:].mean():
        raise AssertionError("tempering: no swap accepted, or cold rungs not below hot ones")

    same_on_cpu("phase scan", lambda d: list(demonstrate_phase_transition(
        sizes=[16], temperatures=[1.5, 2.5, 3.5], n_samples=4, seed=3, device=d)[16].values()),
        dev)
    same_on_cpu("ground state", lambda d: IsingGrid(
        (16, 16), periodic=True, seed=4, device=d).find_ground_state(50), dev)

    def pt_small(d):
        cold, info = parallel_tempering_lattice(5, (16, 16), temperatures=[2.0, 2.3, 2.6],
                                                n_samples=10, swap_interval=2, n_burnin=5,
                                                device=d)
        return [cold.cpu(), info["energies"], info["final_states"], info["pair_attempts"],
                info["pair_acceptance"]]
    same_on_cpu("tempering", pt_small, dev)
    return n_scan + n_anneal + n_pt


def phase_timing_batched(dev, name):
    gen = torch.Generator().manual_seed(9)
    blacks = random_black(gen, ENSEMBLE, torch.bfloat16, dev)
    tables = sigmoid_table16(1.0, 0.0, torch.as_tensor(SCAN_TEMPS, dtype=torch.float32)).to(dev)
    keys = sweep_keys(np.arange(ENSEMBLE[0])[None, :], np.arange(1000)[:, None]).to(dev)

    def run(sweep):
        def go(n):
            b = blacks
            for k in range(n):
                _, b = sweep(b, tables, keys[k], periodic=True)
        return go

    kernel, plain = run(fused_sweep_batched), run(fused_sweep_batched_reference)
    kernel(10)
    plain(2)
    ms = time_sweeps(kernel, 1000)
    plain_ms = time_sweeps(plain, 20)
    n = ENSEMBLE[0] * ENSEMBLE[1] * ENSEMBLE[2]
    log(f"timing {ENSEMBLE} bf16 periodic on {name}: batched kernel {ms:.6f} ms/sweep "
        f"({n / ms * 1e3:.4e} flips/s, 1000 sweeps), plain {plain_ms:.6f} ms/sweep "
        f"({n / plain_ms * 1e3:.4e} flips/s, 20 sweeps)")
    return ms, plain_ms


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
    log(f"phase 1: built the fused-sweep kernels in {time.perf_counter() - t0:.2f} s")

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

    err2 = phase_batched_exact(dev, gen, cgen)
    log("phase 7: batched kernel == plain version and == the single-lattice kernel")

    phase_batched_statistics(dev)
    log("phase 8: batched statistics agree with the exact references")

    launches2 = phase_batched_paths(dev)
    log("phase 9: the batched paths ran through the batched kernel")

    ms2, plain_ms2 = phase_timing_batched(dev, name)
    log("phase 10: timed")

    source = "tsu_tpu_torch/csrc/checkerboard_fused.cu"
    print(json.dumps({"kernels": [{
        "name": "fused_sweep",
        "route": "cuda",
        "source": source,
        "replaces": "tsu_tpu/ops/checkerboard_fused.py:136",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }, {
        "name": "fused_sweep_batched",
        "route": "cuda",
        "source": source,
        "replaces": "tsu_tpu/ops/checkerboard_fused.py:494",
        "launches": launches2,
        "max_abs_err": err2,
        "ms": ms2,
        "plain_ms": plain_ms2,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
