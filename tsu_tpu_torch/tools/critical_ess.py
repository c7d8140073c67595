"""Statistical efficiency of the lattice path at and away from criticality.

Near T_c single-spin-flip dynamics pay critical slowing down (tau_int ~
L^z, z ~= 2.2 for heat-bath), so raw flip throughput overstates usable
sampling power where the physics is interesting. This tool measures the
integrated autocorrelation time of |m| and e/site with the Geyer estimator
(``ops/stats.py``) on the fused sweep (K1, bf16 planes) through
``fused_sweeps``:

* at T_c = 2.269 for L = 64..512, fitting tau = A * L^z;
* away from T_c (T = 3.0) for L = 256 and 4096;
* projecting tau and ESS/s of the 4096^2 lattice at T_c from the fit and
  from the literature z = 2.17 anchored at L = 256, at the kernel's own
  rate: K1's sweeps/s at 4096^2 measured in the same run (one headline call
  of ``tools.bench``), beside the card's name and power limit.

ESS/s uses the measured wall rate of the loop that produced the series
(sweeps and observables). The counterpart of ``scripts/critical_ess.py``,
with its rows, settings and JSON layout; its output goes to
``visual_output/critical_ess.json`` (``--quick``: a file in the temporary
directory). Run from the repository root:

    python3 -m tsu_tpu_torch.tools.critical_ess [--quick] [--device cpu]

It runs on the card and raises without one, unless ``--device cpu`` asks
for the plain versions. The full run is host-bound (at L = 512, ~6.1e7
sweeps of a small lattice, each one host launch): about 32 minutes on one
NVIDIA H100 80GB HBM3 at 700 W.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from datetime import date

import numpy as np
import torch

from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.ops.checkerboard import plane_energy_batch, split_checkerboard
from tsu_tpu_torch.ops.checkerboard_fused import fused_sweeps
from tsu_tpu_torch.ops.stats import effective_sample_size
from tsu_tpu_torch.oracle import wolff_chain
from tsu_tpu_torch.rng import fold_seed, to_int32

T_C = 2.269
SEED = 20260821
SEED_STRIDE = 1_000_033      # measurement t's sweeps are keyed by seed0 + t * SEED_STRIDE
PROJECTED_L = 4096
HEADLINE_SWEEPS = 5000       # sweeps of tools.bench's headline call


def observables(red: torch.Tensor, black: torch.Tensor) -> torch.Tensor:
    """(|m|, e/site) of the planes: a (2,) float64 tensor on their device.
    The energy comes from the planes (``plane_energy_batch``), periodic."""
    n_sites = 2 * red.numel()
    m = (red.sum(dtype=torch.float64) + black.sum(dtype=torch.float64)) / n_sites
    e = plane_energy_batch(red, black, J=1.0, field=0.0, periodic=True) / n_sites
    return torch.stack((m.abs(), e))


def chunk_size(L: int, thin: int) -> int:
    """Measurements per chunk: the reference's rule (at most 20,000, fewer
    once a chunk would exceed ~1e12 site updates). The padded counts it
    gives are the rows' settings; here it only bounds the device buffer of a
    chunk's observables and the work between two copies to the host."""
    return max(1, min(20_000, int(1e12 // (thin * L * L))))


def measure_series(seed: int, L: int, T: float, *, thin: int, n_meas: int, burnin: int,
                   device=None):
    """Time series of (|m|, e/site) every ``thin`` sweeps after burn-in.

    Ordered start (all +1): at or below T_c a random start would first have
    to coarsen O(L)-sized domains. Burn-in and measurements are padded up to
    whole chunks of :func:`chunk_size`; one chunk, untimed, warms up and
    counts toward burn-in. Measurement t runs ``thin`` sweeps keyed by
    seed0 + t * SEED_STRIDE, seed0 drawn from ``seed``. Each chunk's
    observables stay in one device buffer, copied to the host once.
    Returns (m_abs, e_site, sweeps_per_s_measured).
    """
    dev = resolve_device(device)
    seed0 = int(torch.randint(0, 2**30, (), generator=torch.Generator().manual_seed(seed)))
    chunk = chunk_size(L, thin)
    n_burn = -(-max(burnin // thin, 1) // chunk) * chunk
    n_meas = -(-n_meas // chunk) * chunk
    red, black = split_checkerboard(torch.ones((L, L), dtype=torch.bfloat16, device=dev))
    buf = torch.empty((chunk, 2), dtype=torch.float64, device=dev)

    def run_chunk(t0):
        nonlocal red, black
        for i in range(chunk):
            red, black = fused_sweeps(to_int32(seed0 + (t0 + i) * SEED_STRIDE), red, black,
                                      T, thin)
            buf[i] = observables(red, black)

    run_chunk(0)
    buf.cpu()
    t0 = time.perf_counter()
    done = chunk
    while done < n_burn:
        run_chunk(done)
        done += chunk
    series = []
    while done < n_burn + n_meas:
        run_chunk(done)
        series.append(buf.cpu().numpy())
        done += chunk
    dt = time.perf_counter() - t0
    series = np.concatenate(series)
    return series[:, 0], series[:, 1], (n_burn + n_meas - chunk) * thin / dt


def tau_and_ess(series, thin):
    """(tau_int in sweeps, ESS) via the Geyer estimator on a thinned chain:
    tau_int = N / (2 ESS) in measurement units, times the stride. A lower
    bound when thin >~ tau; the rows keep thin << the expected tau."""
    n = len(series)
    ess = effective_sample_size(series)
    return n / (2.0 * ess) * thin, ess


def run_row(seed, L, T, *, thin, n_meas, burnin, label, device=None, log=print):
    m_abs, e, sweeps_per_s = measure_series(seed, L, T, thin=thin, n_meas=n_meas,
                                            burnin=burnin, device=device)
    n_meas = len(m_abs)  # padded up to whole chunks
    tau_m, ess_m = tau_and_ess(m_abs, thin)
    tau_e, _ = tau_and_ess(e, thin)
    meas_seconds = n_meas * thin / sweeps_per_s
    row = {
        "label": label,
        "L": L,
        "T": T,
        "thin_sweeps": thin,
        "n_meas": n_meas,
        "burnin_sweeps": burnin,
        "mean_abs_m": round(float(m_abs.mean()), 5),
        "mean_e_site": round(float(e.mean()), 5),
        "tau_int_M_sweeps": round(tau_m, 2),
        "tau_int_E_sweeps": round(tau_e, 2),
        "ess_M": round(ess_m, 1),
        "ess_M_per_s": round(ess_m / meas_seconds, 4),
        "sweeps_per_s_measured": round(sweeps_per_s, 1),
        "flips_per_s_measured": round(sweeps_per_s * L * L, 1),
        "run_over_tau": round(n_meas * thin / max(tau_m, 1e-9), 1),
    }
    log(json.dumps(row))
    return row


def tau_guess(L: int) -> float:
    """~0.3 * L^2.17 sweeps: sizes the burn-in (10x) and thinning (<< tau)
    of a T_c row; ``run_over_tau`` shows an undersized run."""
    return 0.3 * L ** 2.17


def tc_settings(L: int, quick: bool) -> dict:
    tg = tau_guess(L)
    thin = max(1, int(tg / 400))
    n_meas = 20_000 if quick else min(120_000, max(60_000, int(250 * tg / thin)))
    return {"thin": thin, "n_meas": n_meas, "burnin": int(10 * tg)}


def away_settings(quick: bool) -> dict:
    return {"thin": 1, "n_meas": 2_000 if quick else 20_000, "burnin": 100 if quick else 2_000}


def wolff_row(w: dict, L: int, rows, log=print) -> dict:
    """The host Wolff yardstick at T_c from ``w``, a ``wolff_chain`` result
    at L, in measured sweep equivalents (cluster size / N per step), beside
    the heat-bath row of the same L."""
    n = len(w["m_abs"])
    tau_steps = n / (2.0 * effective_sample_size(w["m_abs"]))
    tau_sweq = tau_steps * w["sweep_equiv_per_step"]
    row = {
        "L": L, "T": T_C,
        "tau_int_M_wolff_steps": round(tau_steps, 2),
        "sweep_equiv_per_step": round(w["sweep_equiv_per_step"], 4),
        "tau_int_M_sweep_equivalents": round(tau_sweq, 3),
        "mean_abs_m": round(float(w["m_abs"].mean()), 5),
        "mean_cluster_size": round(w["mean_cluster_size"], 1),
    }
    hb = next((r for r in rows if r["L"] == L and r["label"].startswith("Tc")), None)
    if hb is not None:
        row["heatbath_tau_over_wolff_tau_sweeps"] = round(
            hb["tau_int_M_sweeps"] / max(tau_sweq, 1e-9), 1)
    log(json.dumps({"wolff": row}))
    return row


def fit_tc(rows):
    """tau = A * L^z over the T_c rows (least squares in log-log): the
    rounded record and the unrounded (A, z) the projection uses."""
    Ls = np.array([r["L"] for r in rows if r["label"].startswith("Tc")], float)
    taus = np.array([r["tau_int_M_sweeps"] for r in rows if r["label"].startswith("Tc")], float)
    z, logA = np.polyfit(np.log(Ls), np.log(taus), 1)
    A = float(np.exp(logA))
    return ({"z": round(float(z), 3), "A": round(A, 4), "Ls": Ls.astype(int).tolist(),
             "taus_sweeps": taus.tolist()}, A, float(z))


def kernel_sweeps_per_s(device, size: int = PROJECTED_L) -> float:
    """K1's sweeps/s at size^2 bf16 through ``fused_sweeps``: one headline
    call of ``tools.bench`` (HEADLINE_SWEEPS sweeps after a warm-up call,
    CUDA events on the card)."""
    from tsu_tpu_torch.tools.kernel_bench import throughput

    def step(red, black, i, n, T):
        return fused_sweeps(1 + i * 7919, red, black, T, n)

    return 1.0 / throughput(step, size, torch.bfloat16, 1, HEADLINE_SWEEPS,
                            resolve_device(device))


def projection(A: float, z: float, anchor_L: int, anchor_tau: float,
               sweeps_per_s_measured: float, kernel_rate: float, card: str) -> dict:
    """tau and ESS/s of the 4096^2 lattice at T_c: from the fit (A, z) and
    from the literature z = 2.17 through the anchor row, at ``kernel_rate``
    (K1's sweeps/s measured on ``card``). At tau-scale thinning the
    observables' cost vanishes, so the kernel's rate is the denominator;
    the measured-with-observables rate of the T = 3.0 row stays beside it."""
    tau_fit = A * PROJECTED_L ** z
    tau_lit = anchor_tau * (PROJECTED_L / anchor_L) ** 2.17
    return {
        "tau_int_M_sweeps_projected_fit": round(tau_fit, 0),
        "tau_int_M_sweeps_projected_z2.17": round(tau_lit, 0),
        "sweeps_per_s_measured_T3": sweeps_per_s_measured,
        "sweeps_per_s_headline_kernel": round(kernel_rate, 1),
        "kernel_rate_card": card,
        # Both lists ordered [fit z, literature z = 2.17].
        "ess_M_per_s_at_kernel_rate": [round(kernel_rate / (2 * tau_fit), 6),
                                       round(kernel_rate / (2 * tau_lit), 6)],
        "seconds_per_independent_M_sample_at_kernel_rate": [
            round(2 * tau_fit / kernel_rate, 1), round(2 * tau_lit / kernel_rate, 1)],
        "note": (f"direct tau measurement at T_c would need ~300*tau ~ 1e10+ sweeps; "
                 f"projected from the measured T_c fit (effective z) and the literature "
                 f"z=2.17 from the L={anchor_L} anchor, at K1's rate measured on {card}"),
    }


def _git_sha() -> str:
    """The checkout's short commit, or "" outside a git checkout."""
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"], capture_output=True,
                              text=True).stdout.strip()
    except FileNotFoundError:
        return ""


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    quick = args.quick
    dev = resolve_device(args.device)
    log = lambda s: print(s, flush=True)  # noqa: E731

    rows = []
    for i, L in enumerate([16, 32] if quick else [64, 128, 256, 512]):
        rows.append(run_row(fold_seed(SEED, i), L, T_C, label=f"Tc_L{L}", device=dev, log=log,
                            **tc_settings(L, quick)))
    for i, L in enumerate([16] if quick else [256, 4096]):
        rows.append(run_row(fold_seed(SEED, 100 + i), L, 3.0, label=f"T3.0_L{L}", device=dev,
                            log=log, **away_settings(quick)))
    fit, A, z = fit_tc(rows)
    log(json.dumps({"fit": fit}))
    wolff_rows = [wolff_row(wolff_chain(SEED, L, T_C, n_steps=1500 if quick else 4000), L, rows,
                            log) for L in ([16] if quick else [64, 128])]

    out = {
        "date": date.today().isoformat(),
        "git_sha": _git_sha(),
        "backend": dev.type,
        "rows": rows,
        "fit_Tc": fit,
        "wolff_Tc": wolff_rows,
    }
    if not quick:
        from tsu_tpu_torch.tools.timing import card

        r4096 = next(r for r in rows if r["L"] == PROJECTED_L)
        anchor = next(r for r in rows if r["L"] == 256 and r["label"].startswith("Tc"))
        out["projection_4096_Tc"] = projection(
            A, z, 256, anchor["tau_int_M_sweeps"],
            r4096["sweeps_per_s_measured"], kernel_sweeps_per_s(dev), card())
        log(json.dumps({"projection_4096_Tc": out["projection_4096_Tc"]}))

    if quick:
        path = os.path.join(tempfile.gettempdir(), "critical_ess_quick.json")
    else:
        os.makedirs("visual_output", exist_ok=True)
        path = os.path.join("visual_output", "critical_ess.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    log(f"wrote {path}")
    return out


if __name__ == "__main__":
    main()
