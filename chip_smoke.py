#!/usr/bin/env python3
"""Drive the PyTorch port (tsu_tpu_torch) once on one NVIDIA GPU and check it.

Run from the repository root:

    python3 chip_smoke.py

Phases, each of which raises on failure:
 1. print the card (nvidia-smi name and power limit), torch and CUDA versions,
    and build the fused-sweep and the bond kernels from tsu_tpu_torch/csrc,
    one nvcc per source, all at once;
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
10. batched kernel and plain times per sweep at 16 x 1024^2 bf16;
11. the bond kernels against their plain versions at the spin-glass paths'
    shapes: K4 discrete (packed, pure) at 4096^2 bf16 on the anneal's
    schedule rows, injected over 3 sweeps and Philox over 2, bit for bit;
    K4 continuous at 4096^2 f32 with Gaussian bonds and a field, half-sweep
    by half-sweep, equal outside the stated band (its size printed); K4 at
    1002x1000 f32 open in both modes; K5 discrete at 284 x 256^2 (a ladder of
    142 rungs x 2 copies) and 64 x 256^2 bf16, injected and Philox; and
    element b of one K5 launch against K4 under the matching key;
12. spin-glass statistics: a 4x4 +-J instance against enumeration through
    IsingGrid(bonds).sample (continuous) and the cold rung of a 4-rung
    parallel_tempering_bonds (discrete); a gauge-transformed ferromagnet at
    512^2, T = 2.0, against Onsager's magnetization in both modes;
13. the spin-glass paths at full width, each with its wall time and launch
    counts: IsingGrid(4096^2, Gaussian bonds).sample_observables(4) (280 K4
    launches), IsingGrid(4096^2, +-J).find_ground_state(3000) (6,000 K4
    launches), parallel_tempering_bonds over 64 rungs of 256^2 (600 K5
    launches), build_tempering_ladder at 256^2 then pt_ground_state_search
    with 2 copies and Houdayer moves (K5 only); and each at 16x16 equal on
    cuda and on cpu;
14. bond kernel and plain times per half-sweep: K4 discrete at 4096^2 bf16,
    K4 continuous at 4096^2 f32, K5 discrete at 284 x 256^2 bf16; the
    kernel's time from a CUDA graph of 1000 launches (the JSON line's
    "ms") and launched one by one.

The last two lines are a JSON line per kernel and the result line
{"ok": true, "device": {...}}. Without CUDA the script exits non-zero before
printing either.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tsu_tpu_torch import IsingConfig, IsingGrid, demonstrate_phase_transition
from tsu_tpu_torch.models.lattice_sampler import sample_grid_ensemble
from tsu_tpu_torch.ops import _build
from tsu_tpu_torch.ops.checkerboard import (
    lattice_energy_batch,
    merge_checkerboard,
    split_checkerboard,
)
from tsu_tpu_torch.ops.checkerboard_fused import (
    fused_sweep,
    fused_sweep_batched,
    fused_sweep_batched_reference,
    fused_sweep_reference,
    fused_sweeps,
    sigmoid_table16,
)
from tsu_tpu_torch.ops.checkerboard_bonds import color_bond_weights, pack_bond_codes
from tsu_tpu_torch.ops.checkerboard_bonds_kernel import (
    CONTINUOUS_BAND,
    bond_halfsweep,
    bond_halfsweep_batched,
    bond_halfsweep_batched_reference,
    bond_halfsweep_reference,
    bond_key,
    bond_sweep_keys,
    checkerboard_sweeps_bonds_kernel,
    continuous_band,
)
from tsu_tpu_torch.ops.checkerboard_fused import sigmoid_table
from tsu_tpu_torch.rng import sweep_keys
from tsu_tpu_torch.samplers import (
    build_tempering_ladder,
    make_schedule,
    parallel_tempering_bonds,
    parallel_tempering_lattice,
    pt_ground_state_search,
)

MAIN_SHAPE = (4096, 4096)
SCHEDULE = [2.269, 4.0, 0.5]
ENSEMBLE = (16, 1024, 1024)              # the phase scan's batch: 16 x 1024^2
SCAN_TEMPS = np.linspace(1.5, 3.5, ENSEMBLE[0])
PT_SHAPE, PT_RUNGS = (256, 256), 64
LADDER_BATCH = 284                       # spin_glass_ea's ladder: 142 rungs x 2 copies
EA_GS_DENSITY = -1.4015                  # 2-D +-J EA ground-state energy per site


def log(msg: str):
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0].strip()


KERNELS = (fused_sweep, fused_sweep_batched, bond_halfsweep, bond_halfsweep_batched)


def reset_counts():
    for k in KERNELS:
        k.launches = 0


def counts():
    """Launches of K1, K2, K4 and K5 since the last reset."""
    return tuple(k.launches for k in KERNELS)


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
    launches, batched, *bonds = counts()
    sweeps = cfg.n_burnin + n_samples * cfg.n_sweeps
    n = MAIN_SHAPE[0] * MAIN_SHAPE[1]
    log(f"main path: IsingGrid({MAIN_SHAPE}).sample(4) {wall:.3f} s wall, "
        f"{launches} launches for {sweeps} sweeps, "
        f"{sweeps * n / wall:.4e} flips/s end to end (init and copy-out included)")
    if (launches, batched, *bonds) != (sweeps, 0, 0, 0):
        raise AssertionError(f"expected {sweeps} kernel launches and 0 of the others, counted "
                             f"{(launches, batched, *bonds)}")
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


def run_path(what, fn, want):
    """Run one path from zeroed counts; raise unless the launches of
    (K1, K2, K4, K5) are ``want`` (a function of the output, or a tuple).
    Returns (output, counts)."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    want = want(out) if callable(want) else want
    log(f"path {what}: {wall:.3f} s wall, launches K1 {got[0]}, K2 {got[1]}, K4 {got[2]}, "
        f"K5 {got[3]}")
    if got != want:
        raise AssertionError(f"{what}: expected launches {want}, counted {got}")
    return out, got


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
                                     seed=0, device=dev)[size]), (0, 200 + 64 * 2, 0, 0))
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
                                    lambda: grid.find_ground_state(n_steps=1000),
                                    (0, 1000, 0, 0))
    n = MAIN_SHAPE[0] * MAIN_SHAPE[1]
    log(f"anneal: best e/site {e / n}")
    if not e / n < -1.85 or grid.energy(state) != e or state.shape != (n,):
        raise AssertionError(f"anneal: e/site {e / n}, energy of the returned state "
                             f"{grid.energy(state)}, shape {state.shape}")

    R = PT_RUNGS
    (cold, info), n_pt = run_path(f"tempering {R} x {PT_SHAPE}, 300 rounds", lambda: (
        parallel_tempering_lattice(torch.Generator().manual_seed(0), PT_SHAPE,
                                   temperatures=np.geomspace(1.8, 3.0, R), n_samples=200,
                                   swap_interval=10, n_burnin=100, device=dev)), (0, 300, 0, 0))
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
    return n_scan[1] + n_anneal[1] + n_pt[1]


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


def pm1_bonds(gen: torch.Generator, shape):
    """+-J bond planes (Jh, Jv), float32 CPU tensors."""
    return tuple(torch.where(torch.rand(shape, generator=gen) < 0.5, 1.0, -1.0) for _ in range(2))


def gauss_bonds(gen: torch.Generator, shape):
    return tuple(torch.randn(shape, generator=gen) for _ in range(2))


def compare_bond_halves(other, weights, steps, periodic, uniforms=None):
    """K4 and its plain version half-sweep by half-sweep from one shared
    input; each step is (colour, key, mode) and starts from the kernel's
    last output. Discrete steps must agree bit for bit; continuous ones
    everywhere outside CONTINUOUS_BAND. Returns (max abs difference outside
    the band, sites in the band, of them the sites that differ)."""
    err, n_band, n_differ = 0.0, 0, 0
    for i, (color, key, mode) in enumerate(steps):
        u = None if uniforms is None else uniforms[i]
        w = weights["red" if color == 0 else "black"]
        kw = dict(update_red=color == 0, key=key, periodic=periodic, uniforms=u, **mode)
        got = bond_halfsweep(other, w, **kw)
        want = bond_halfsweep_reference(other, w, **kw)
        outside = torch.ones_like(got, dtype=torch.bool)
        if "temperature" in mode:
            band = continuous_band(other, w, update_red=color == 0, key=key, periodic=periodic,
                                   uniforms=u, temperature=mode["temperature"])
            n_band += int(band.sum())
            n_differ += int(((got != want) & band).sum())
            outside = ~band
        e = float(((got.float() - want.float()).abs() * outside).max())
        if e:
            raise AssertionError(
                f"K4 != plain at half-sweep {i}: {int(((got != want) & outside).sum())} sites "
                f"differ outside the band (shape {tuple(other.shape)}, {other.dtype}, "
                f"periodic={periodic}, mode {list(mode)}, injected={uniforms is not None})")
        err = max(err, e)
        other = got
    torch.cuda.synchronize()
    return err, n_band, n_differ


def compare_bond_batched(others, weights, keys, modes, periodic, uniforms=None) -> float:
    """K5 and its plain version over len(keys) discrete sweeps from one input,
    half-sweep by half-sweep; raise unless equal bit for bit. Returns the
    max abs difference."""
    err = 0.0
    for k in range(keys.shape[0]):
        for c, color in enumerate(("red", "black")):
            u = None if uniforms is None else uniforms[k, c]
            kw = dict(update_red=c == 0, periodic=periodic, uniforms=u, **modes)
            got = bond_halfsweep_batched(others, weights[color], keys[k, c], **kw)
            want = bond_halfsweep_batched_reference(others, weights[color], keys[k, c], **kw)
            err = max(err, float((got.float() - want.float()).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(
                    f"K5 != plain at sweep {k} {color}: {int((got != want).sum())} sites differ "
                    f"(shape {tuple(others.shape)}, injected={uniforms is not None})")
            others = got
    torch.cuda.synchronize()
    return err


def phase_bond_exact(dev, gen, cgen):
    """Phase 11; returns (K4 max abs err, K4 band sites, K4 band sites that
    differ, K5 max abs err)."""
    R, C = MAIN_SHAPE
    Jh, Jv = pm1_bonds(gen, MAIN_SHAPE)
    codes = pack_bond_codes(color_bond_weights(Jh.to(dev), Jv.to(dev), 0.0, True))
    at = [0, 1500, 2999]                                     # rows of a 3000-step anneal
    tables = sigmoid_table(1.0, 0.0, torch.from_numpy(make_schedule(5.0, 0.05, 3000)[at])).to(dev)
    steps = [(c, bond_key(77, c, k), {"table": tables[k]}) for k in range(3) for c in (0, 1)]
    black = random_black(gen, MAIN_SHAPE, torch.bfloat16, dev)
    U = torch.randint(0, 1 << 24, (6, R, C // 2), generator=cgen, device=dev, dtype=torch.int32)
    err4, _, _ = compare_bond_halves(black, codes, steps, True, U)
    del U
    err4 = max(err4, compare_bond_halves(black, codes, steps[:4], True)[0])
    log(f"phase 11: K4 discrete packed pure {MAIN_SHAPE} bf16 on anneal schedule rows: "
        "kernel == plain, injected over 3 sweeps and Philox over 2")

    Jh, Jv = gauss_bonds(gen, MAIN_SHAPE)
    field = 0.3 * torch.randn(MAIN_SHAPE, generator=gen)
    weights = color_bond_weights(Jh.to(dev), Jv.to(dev), field.to(dev), True)
    steps = [(c, bond_key(78, c, k), {"temperature": 1.5}) for k in range(2) for c in (0, 1)]
    e, n_band, n_differ = compare_bond_halves(random_black(gen, MAIN_SHAPE, torch.float32, dev),
                                              weights, steps, True)
    err4 = max(err4, e)
    log(f"phase 11: K4 continuous {MAIN_SHAPE} f32, Gaussian bonds and field, T=1.5, 4 "
        f"half-sweeps: equal outside the band |u - p| <= {CONTINUOUS_BAND}; {n_band} of "
        f"{4 * R * C // 2} site updates in the band, {n_differ} of them differ")

    R, C = 1002, 1000
    for mode in ("codes", "continuous"):
        if mode == "codes":
            Jh, Jv = pm1_bonds(gen, (R, C))
            Jh = torch.where(torch.rand((R, C), generator=gen) < 0.3, 0.0, Jh)
            w = pack_bond_codes(color_bond_weights(Jh.to(dev), Jv.to(dev), 0.0, False))
            modes = [{"table": sigmoid_table(1.0, 0.0, T).to(dev)} for T in (0.7, 2.5)]
        else:
            Jh, Jv = gauss_bonds(gen, (R, C))
            w = color_bond_weights(Jh.to(dev), Jv.to(dev), 0.0, False)
            modes = [{"temperature": T} for T in (0.7, 2.5)]
        steps = [(c, bond_key(79, c, k), modes[k]) for k in range(2) for c in (0, 1)]
        black = random_black(gen, (R, C), torch.float32, dev)
        U = torch.randint(0, 1 << 24, (4, R, C // 2), generator=cgen, device=dev,
                          dtype=torch.int32)
        for u in (U, None):
            e, b, d = compare_bond_halves(black, w, steps, False, u)
            err4, n_band, n_differ = max(err4, e), n_band + b, n_differ + d
        log(f"phase 11: K4 {mode} (1002, 1000) f32 open: kernel == plain over 2 sweeps, "
            "injected and Philox")

    err5 = 0.0
    Jh, Jv = pm1_bonds(gen, PT_SHAPE)
    codes = pack_bond_codes(color_bond_weights(Jh.to(dev), Jv.to(dev), 0.0, True))
    ladder = np.geomspace(0.3, 2.0, LADDER_BATCH // 2)
    for B, temps in ((LADDER_BATCH, np.tile(ladder, 2)), (PT_RUNGS, np.geomspace(1.2, 2.0, PT_RUNGS))):
        blacks = random_black(gen, (B, *PT_SHAPE), torch.bfloat16, dev)
        modes = {"tables": sigmoid_table(1.0, 0.0, torch.tensor(temps, dtype=torch.float32)).to(dev)}
        keys = bond_sweep_keys(torch.randint(0, 2**30, (B,), generator=gen).numpy(), 2).to(dev)
        U = torch.randint(0, 1 << 24, (2, 2, B, *PT_SHAPE[:1], PT_SHAPE[1] // 2), generator=cgen,
                          device=dev, dtype=torch.int32)
        err5 = max(err5, compare_bond_batched(blacks, codes, keys, modes, True, U),
                   compare_bond_batched(blacks, codes, keys, modes, True))
        log(f"phase 11: K5 discrete ({B}, {PT_SHAPE[0]}, {PT_SHAPE[1]}) bf16: kernel == plain "
            "over 2 sweeps, injected and Philox")

    outs = bond_halfsweep_batched(blacks, codes["red"], keys[1, 0], update_red=True, **modes)
    for b in range(PT_RUNGS):
        one = bond_halfsweep(blacks[b], codes["red"], update_red=True,
                             key=tuple(int(x) & 0xFFFFFFFF for x in keys[1, 0, b]),
                             table=modes["tables"][b])
        if not torch.equal(one, outs[b]):
            raise AssertionError(f"K5 element {b} != K4 under its key")
    torch.cuda.synchronize()
    log(f"phase 11: each of the {PT_RUNGS} elements of one K5 launch == K4 under its key")
    return err4, n_band, n_differ, err5


def exact_bonds_4x4(Jh, Jv, T: float):
    """<e> per site and <m^2> of a periodic 4x4 bond instance, by enumerating
    all 2^16 states."""
    bits = (np.arange(2**16)[:, None] >> np.arange(16)) & 1
    s = (2 * bits - 1).reshape(-1, 4, 4).astype(np.float64)
    E = -(Jh * s * np.roll(s, -1, 2)).sum((1, 2)) - (Jv * s * np.roll(s, -1, 1)).sum((1, 2))
    w = np.exp(-(E - E.min()) / T)
    w /= w.sum()
    return float(w @ E) / 16, float(w @ s.mean((1, 2)) ** 2)


def check_moments(what, e, m2, exact):
    (e, se_e), (m2, se_m2) = batch_means(e), batch_means(m2)
    log(f"{what}: <e> {e:.5f} +- {se_e:.5f} (exact {exact[0]:.5f}); <m^2> {m2:.5f} +- "
        f"{se_m2:.5f} (exact {exact[1]:.5f})")
    if abs(e - exact[0]) > 4 * se_e or abs(m2 - exact[1]) > 4 * se_m2:
        raise AssertionError(f"{what}: moments differ from exact enumeration by more than 4 SE")


def phase_bond_statistics(dev):
    gen = torch.Generator().manual_seed(31)
    Jh, Jv = (x.numpy() for x in pm1_bonds(gen, (4, 4)))
    T = 1.5
    exact = exact_bonds_4x4(Jh, Jv, T)
    grid = IsingGrid((4, 4), periodic=True, seed=1, device=dev, bonds=(Jh, Jv),
                     config=IsingConfig(n_burnin=100, n_sweeps=1))
    s = grid.sample(n_samples=10000, temperature=T)
    check_moments(f"4x4 +-J T={T}, IsingGrid(bonds).sample (continuous)",
                  grid.energies(s) / 16, s.mean(axis=1).astype(np.float64) ** 2, exact)
    cold, info = parallel_tempering_bonds(gen, Jh, Jv, temperatures=np.linspace(T, 2.5, 4),
                                          n_samples=5000, swap_interval=1, n_burnin=100,
                                          device=dev)
    if not info["discrete_table_path"]:
        raise AssertionError("+-J tempering did not take the discrete mode")
    check_moments(f"4x4 +-J, cold rung of 4-rung parallel_tempering_bonds (discrete), swap "
                  f"acceptance {info['swap_acceptance_rate']:.4f}",
                  grid.energies(cold.cpu().numpy()) / 16,
                  cold.double().mean((1, 2)).cpu().numpy() ** 2, exact)

    # A ferromagnet in a random gauge tau: J_ij = tau_i tau_j, started at
    # s = tau. |sum tau_i s_i| / N is then the ferromagnet's |m|.
    T, L = 2.0, 512
    onsager = (1.0 - np.sinh(2.0 / T) ** -4) ** 0.125
    tau = torch.where(torch.rand((L, L), generator=gen) < 0.5, 1.0, -1.0)
    Jh, Jv = tau * torch.roll(tau, -1, 1), tau * torch.roll(tau, -1, 0)
    s = IsingGrid((L, L), periodic=True, seed=3, device=dev, bonds=(Jh.numpy(), Jv.numpy()),
                  config=IsingConfig(n_burnin=200, n_sweeps=5)).sample(
        n_samples=40, initial_state=tau.numpy().reshape(-1), temperature=T)
    m_cont = float(np.abs((s * tau.numpy().reshape(1, -1)).mean(axis=1)).mean())
    codes = pack_bond_codes(color_bond_weights(Jh.to(dev), Jv.to(dev)))
    red, black = split_checkerboard(tau.to(dev, torch.bfloat16))
    red, black = checkerboard_sweeps_bonds_kernel(1, red, black, codes, T, 200, discrete=True)
    ms = []
    for i in range(40):
        red, black = checkerboard_sweeps_bonds_kernel(2 + i, red, black, codes, T, 5,
                                                      discrete=True)
        ms.append(abs(float((merge_checkerboard(red, black).float() * tau.to(dev)).mean())))
    m_disc = float(np.mean(ms))
    log(f"gauge-transformed ferromagnet {L}^2 T={T}: <|m_gauge|> continuous {m_cont:.5f}, "
        f"discrete {m_disc:.5f} (Onsager {onsager:.5f})")
    if abs(m_cont - onsager) > 0.01 or abs(m_disc - onsager) > 0.01:
        raise AssertionError("gauge-transformed ferromagnet differs from Onsager's |m| by more "
                             "than 0.01")


def ladder_launches(n_iters: int, quench: int):
    """K5 launches of build_tempering_ladder (pilot 128 + 128 sweeps;
    feedback rounds of 32 + 128 iterations of 2 sweeps) and of
    pt_ground_state_search (n_iters sweeps and the quench), two half-sweeps
    a sweep."""
    def count(out):
        rounds = out[1]["feedback_rounds_run"]
        return (0, 0, 0, 2 * (256 + rounds * 160 * 2 + n_iters + quench))
    return count


def ladder_then_search(gen, Jh, Jv, dev, n_iters=500, quench=64, feedback_iters=128):
    temps, info = build_tempering_ladder(
        gen, Jh, Jv, T_min=0.3, T_max=2.0, target_acceptance=0.3, accept_floor=0.2,
        feedback_iters=feedback_iters, feedback_burnin=feedback_iters // 4, device=dev)
    out = pt_ground_state_search(gen, Jh, Jv, temperatures=temps, n_iters=n_iters, n_sweeps=1,
                                 n_copies=2, houdayer_every=10, quench_sweeps=quench, device=dev)
    return temps, info, out


def phase_bond_paths(dev):
    """Phase 13; returns the K4 and K5 launches of the paths."""
    gen = torch.Generator().manual_seed(41)
    n = MAIN_SHAPE[0] * MAIN_SHAPE[1]
    cfg = IsingConfig()
    grid = IsingGrid(MAIN_SHAPE, periodic=True, seed=0, device=dev,
                     bonds=tuple(x.numpy() for x in gauss_bonds(gen, MAIN_SHAPE)))
    want = 2 * (cfg.n_burnin + 4 * cfg.n_sweeps)
    obs, c1 = run_path(f"sample_observables(4), Gaussian bonds {MAIN_SHAPE}",
                       lambda: grid.sample_observables(n_samples=4, temperature=1.0),
                       (0, 0, want, 0))
    log(f"sample_observables: m {obs['magnetization'].tolist()}, e/site "
        f"{(obs['energy'] / n).tolist()}")
    if (obs["energy"].shape != (4,) or not np.all(np.isfinite(obs["energy"]))
            or not np.all(np.abs(obs["magnetization"]) < 0.05)
            or not np.all((obs["energy"] / n > -2.0) & (obs["energy"] / n < 0.0))):
        raise AssertionError("Gaussian spin glass observables out of range")

    grid = IsingGrid(MAIN_SHAPE, periodic=True, seed=0, device=dev,
                     bonds=tuple(x.numpy() for x in pm1_bonds(gen, MAIN_SHAPE)))
    (state, e), c2 = run_path(f"find_ground_state(3000), +-J {MAIN_SHAPE}",
                              lambda: grid.find_ground_state(n_steps=3000), (0, 0, 6000, 0))
    log(f"spin-glass anneal: best e/site {e / n} (literature ground state {EA_GS_DENSITY})")
    if (not EA_GS_DENSITY - 0.005 <= e / n <= -1.35 or grid.energy(state) != e
            or state.shape != (n,)):
        raise AssertionError(f"spin-glass anneal: e/site {e / n}, energy of the returned state "
                             f"{grid.energy(state)}, shape {state.shape}")

    Jh, Jv = (x.numpy() for x in pm1_bonds(gen, PT_SHAPE))
    (cold, info), c3 = run_path(
        f"parallel_tempering_bonds {PT_RUNGS} x {PT_SHAPE}, 300 rounds",
        lambda: parallel_tempering_bonds(torch.Generator().manual_seed(0), Jh, Jv,
                                         temperatures=np.geomspace(1.2, 2.0, PT_RUNGS),
                                         n_samples=200, swap_interval=10, n_burnin=100,
                                         device=dev), (0, 0, 0, 600))
    rung_e = info["energies"][100:].mean(0)
    log(f"bond tempering: {info['swap_accepts']} of {info['swap_attempts']} swaps accepted; "
        f"mean E of the 8 coldest rungs {rung_e[:8].mean()}, of the 8 hottest "
        f"{rung_e[-8:].mean()}")
    if (info["swap_accepts"] <= 0 or not rung_e[:8].mean() < rung_e[-8:].mean()
            or tuple(cold.shape) != (200, *PT_SHAPE) or not info["discrete_table_path"]):
        raise AssertionError("bond tempering: no swap accepted, cold rungs not below hot ones, "
                             "or a wrong shape or mode")

    (temps, linfo, out), c4 = run_path(
        f"build_tempering_ladder + pt_ground_state_search {PT_SHAPE}, 2 copies, 500 iterations",
        lambda: ladder_then_search(torch.Generator().manual_seed(1), Jh, Jv, dev),
        ladder_launches(500, 64))
    log(f"ladder: {linfo['n_rungs']} rungs, {linfo['feedback_rounds_run']} feedback rounds, "
        f"measured pair acceptance min {linfo['measured_pair_acceptance'].min():.3f}; search: "
        f"swap acceptance {out['swap_acceptance_rate']:.4f}, best e/site "
        f"{out['energy_per_site']} (literature {EA_GS_DENSITY})")
    if (not EA_GS_DENSITY - 0.005 <= out["energy_per_site"] <= -1.35
            or not 0.1 <= out["swap_acceptance_rate"] <= 0.6):
        raise AssertionError("ground-state search: e/site or swap acceptance out of range")

    small = np.random.default_rng(3)
    g16 = small.normal(size=(2, 16, 16)).astype(np.float32)
    p16 = small.choice([-1.0, 1.0], (2, 16, 16)).astype(np.float32)
    same_on_cpu("sample (Gaussian bonds)", lambda d: [IsingGrid(
        (16, 16), periodic=True, seed=6, device=d, bonds=g16,
        config=IsingConfig(n_burnin=10, n_sweeps=2)).sample(3, temperature=1.2)], dev)
    same_on_cpu("find_ground_state (+-J)", lambda d: IsingGrid(
        (16, 16), periodic=True, seed=7, device=d, bonds=p16).find_ground_state(60), dev)

    def pt_small(d):
        cold, info = parallel_tempering_bonds(8, *p16, temperatures=[0.8, 1.2, 1.8],
                                              n_samples=6, swap_interval=2, n_burnin=4, device=d)
        return [cold.cpu(), info["energies"], info["final_states"], info["pair_attempts"]]
    same_on_cpu("parallel_tempering_bonds", pt_small, dev)

    def search_small(d):
        temps, info, out = ladder_then_search(torch.Generator().manual_seed(9), *p16, d,
                                              n_iters=20, quench=4, feedback_iters=8)
        return [temps, out["best_state"], out["best_energy"], out["pair_attempts"]]
    same_on_cpu("build_tempering_ladder + pt_ground_state_search", search_small, dev)
    return c1[2] + c2[2], c3[3] + c4[3]


def graph_ms(fn, n: int) -> float:
    """Device ms per call of fn(n)'s n kernel calls, captured in one CUDA
    graph and replayed. The launches then run back to back: a bond
    half-sweep at these sizes takes less device time than the host's launch
    path (~35-50 us a call), so timing eager launches would time the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(2)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn(n)
    graph.replay()
    return time_sweeps(lambda _: graph.replay(), n)


def chain_ms(halfsweep, other, weights, n, timer=time_sweeps, **mode):
    """ms per half-sweep of n chained half-sweeps (red, black, ...) under
    ``timer``."""
    def go(count):
        o = other
        for k in range(count):
            color = k % 2
            o = halfsweep(o, weights["red" if color == 0 else "black"], update_red=color == 0,
                          **{name: (f(k) if callable(f) else f) for name, f in mode.items()})
    go(4)
    return timer(go, n)


def timings(kernel, plain, other, weights, mode):
    """(kernel ms under a CUDA graph, kernel ms launched one by one, plain
    version ms) per half-sweep."""
    return (chain_ms(kernel, other, weights, 1000, graph_ms, **mode),
            chain_ms(kernel, other, weights, 1000, **mode),
            chain_ms(plain, other, weights, 20, **mode))


def phase_bond_timing(dev, name):
    gen = torch.Generator().manual_seed(51)
    sites = MAIN_SHAPE[0] * MAIN_SHAPE[1] // 2
    codes = pack_bond_codes(color_bond_weights(*(x.to(dev) for x in pm1_bonds(gen, MAIN_SHAPE))))
    table = sigmoid_table(1.0, 0.0, 1.0).to(dev)
    black = random_black(gen, MAIN_SHAPE, torch.bfloat16, dev)
    kw = dict(table=table, key=lambda k: (5, k))
    t = {"K4 discrete": timings(bond_halfsweep, bond_halfsweep_reference, black, codes, kw)}
    weights = color_bond_weights(*(x.to(dev) for x in gauss_bonds(gen, MAIN_SHAPE)),
                                 0.3 * torch.randn(MAIN_SHAPE, generator=gen).to(dev))
    black = random_black(gen, MAIN_SHAPE, torch.float32, dev)
    kw = dict(temperature=1.5, key=lambda k: (6, k))
    t["K4 continuous"] = timings(bond_halfsweep, bond_halfsweep_reference, black, weights, kw)
    codes = pack_bond_codes(color_bond_weights(*(x.to(dev) for x in pm1_bonds(gen, PT_SHAPE))))
    temps = np.tile(np.geomspace(0.3, 2.0, LADDER_BATCH // 2), 2)
    tables = sigmoid_table(1.0, 0.0, torch.tensor(temps, dtype=torch.float32)).to(dev)
    keys = bond_sweep_keys(np.arange(LADDER_BATCH), 500).to(dev).reshape(1000, LADDER_BATCH, 2)
    blacks = random_black(gen, (LADDER_BATCH, *PT_SHAPE), torch.bfloat16, dev)

    def batched(fn):
        return lambda o, w, update_red, k: fn(o, w, keys[k], update_red=update_red, tables=tables)
    kw = dict(k=lambda k: k)
    t["K5 discrete"] = timings(batched(bond_halfsweep_batched),
                               batched(bond_halfsweep_batched_reference), blacks, codes, kw)
    n_sites = {"K4 discrete": sites, "K4 continuous": sites,
               "K5 discrete": LADDER_BATCH * PT_SHAPE[0] * PT_SHAPE[1] // 2}
    for what, (ms, eager_ms, plain_ms) in t.items():
        n = n_sites[what]
        log(f"timing {what} on {name}: kernel {ms:.6f} ms/half-sweep ({n / ms * 1e3:.4e} site "
            f"updates/s, a CUDA graph of 1000 half-sweeps; {eager_ms:.6f} ms launched one by "
            f"one), plain {plain_ms:.6f} ms/half-sweep ({n / plain_ms * 1e3:.4e}/s, 20 "
            "half-sweeps)")
    return t


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    name = card()
    log(name)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        list(pool.map(lambda build: build(), (_build.fused_sweep_library,
                                              _build.bond_sweep_library)))
    log(f"phase 1: built the fused-sweep and the bond kernels in "
        f"{time.perf_counter() - t0:.2f} s")

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

    err4, n_band, n_differ, err5 = phase_bond_exact(dev, gen, cgen)
    log("phase 11: K4 and K5 == their plain versions (K4 continuous outside the band)")

    phase_bond_statistics(dev)
    log("phase 12: spin-glass statistics agree with the exact references")

    launches4, launches5 = phase_bond_paths(dev)
    log("phase 13: the spin-glass paths ran through K4 and K5")

    bond_times = phase_bond_timing(dev, name)
    log("phase 14: timed")

    source = "tsu_tpu_torch/csrc/checkerboard_fused.cu"
    bonds = "tsu_tpu_torch/csrc/checkerboard_bonds.cu"
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
    }, {
        "name": "bond_halfsweep",
        "route": "cuda",
        "source": bonds,
        "replaces": "tsu_tpu/ops/checkerboard_bonds_pallas.py:71",
        "launches": launches4,
        "max_abs_err": err4,
        "ms": bond_times["K4 discrete"][0],
        "plain_ms": bond_times["K4 discrete"][2],
        "continuous_ms": bond_times["K4 continuous"][0],
        "continuous_plain_ms": bond_times["K4 continuous"][2],
        "continuous_band_sites": n_band,
        "continuous_band_differ": n_differ,
    }, {
        "name": "bond_halfsweep_batched",
        "route": "cuda",
        "source": bonds,
        "replaces": "tsu_tpu/ops/checkerboard_bonds_pallas.py:320",
        "launches": launches5,
        "max_abs_err": err5,
        "ms": bond_times["K5 discrete"][0],
        "plain_ms": bond_times["K5 discrete"][2],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
