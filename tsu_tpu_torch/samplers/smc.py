"""Annealed sequential Monte Carlo (AIS/SMC) with systematic resampling.

Counterpart of ``tsu_tpu/samplers/smc.py``: a population of particles is
carried from N(0, base_sigma^2) to p ∝ exp(-E/T) through a linear
beta-ladder by reweighting, systematic resampling when the effective sample
size drops below ``ess_threshold * P``, and overdamped Langevin moves on
E_beta = (1 - beta) |x|^2 / (2 s^2) + beta E / T. It also estimates log Z.

**One step for one shard or many.** A step runs on a list of particle
shards (one for :func:`annealed_smc`; the mesh's for
``parallel.smc_sharded``): each shard reweights and moves its own rows, and
the shards' log-weights are gathered on the first shard's device, where the
ESS, the log-Z increment and the resampling indices are computed over all
P. The resample-or-not branch is a select (``torch.where`` on the ESS test,
the identity permutation when it does not fire), so a step has one shape
and no host sync, and runs as a CUDA graph when every shard is on one card.
The move's normals are one (n_moves, P, dim) block per step, each shard
taking its rows, so a particle's draws depend on its global index only and
a sharded run equals the one-shard run at one seed, bit for bit.
"""

from __future__ import annotations

import math

import torch

from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.energy import EnergyFn
from tsu_tpu_torch.rng import device_generator
from tsu_tpu_torch.samplers.loop import (
    Draws,
    Potential,
    StepLoop,
    as_states,
    cached_loop,
    canonical,
    chunks,
    scalar,
)

GRADS_PER_GRAPH = 256     # move gradients per CUDA graph


def systematic_resample_indices(u, log_w: torch.Tensor) -> torch.Tensor:
    """Systematic resampling: indices (P,) drawn with one uniform offset
    ``u`` (a number or a 0-dim or (1,) tensor in [0, 1))."""
    P = log_w.shape[0]
    cum = torch.cumsum(torch.softmax(log_w, dim=0), dim=0)
    pos = (u + torch.arange(P, dtype=log_w.dtype, device=log_w.device)) / P
    return torch.searchsorted(cum, pos, side="left").clamp(0, P - 1)


def smc_loop(energy_fn: EnergyFn, devices: tuple, P: int, dim: int, *, n_steps: int,
             n_moves: int, ess_threshold: float, graph: bool = True, probe=None) -> StepLoop:
    """The (cached) SMC step loop over shards of P // len(devices)
    particles on ``devices``; state: the shards' particles "x0", "x1", ...
    and log-weights "w0", "w1", ..., log_z, the step count t, betas, T, dt
    and base_sigma. Records the ESS of each step."""
    devices = tuple(canonical(d) for d in devices)
    ctrl = devices[0]

    def build():
        n = len(devices)
        rows = P // n
        st = {"log_z": scalar(0.0, ctrl), "t": torch.zeros(1, dtype=torch.int64, device=ctrl),
              "betas": torch.linspace(0.0, 1.0, n_steps + 1, dtype=torch.float32, device=ctrl),
              "T": scalar(1.0, ctrl), "dt": scalar(0.05, ctrl), "base_sigma": scalar(3.0, ctrl)}
        for s, dev in enumerate(devices):
            x = torch.zeros((rows, dim), dtype=torch.float32, device=dev)
            if probe is not None:
                x.copy_(probe[s * rows:(s + 1) * rows])
            st[f"x{s}"] = x
            st[f"w{s}"] = torch.zeros(rows, dtype=torch.float32, device=dev)
        T, base_sigma = st["T"], st["base_sigma"]
        beta = {"now": scalar(0.0, ctrl)}

        def e_base(x):
            return torch.sum(x**2) / (2.0 * base_sigma**2)

        def e_target(x):
            return energy_fn(x) / T

        def e_beta(x):
            b = beta["now"]
            return (1.0 - b) * e_base(x) + b * e_target(x)

        base = Potential(e_base, st["x0"], "base energy")
        target = Potential(e_target, st["x0"], "energy")
        moved = Potential(e_beta, st["x0"], "annealed energy")
        batched = base.batched and target.batched and moved.batched
        one_card = graph and all(d == ctrl for d in devices)

        def step(bufs, k):
            t = st["t"]
            b_prev = st["betas"].index_select(0, t).squeeze(0)
            b = st["betas"].index_select(0, t + 1).squeeze(0)
            beta["now"] = b
            # Incremental weights: -(beta - beta_prev) * (E_target - E_base).
            for s in range(n):
                x = st[f"x{s}"]
                st[f"w{s}"].add_((-(b - b_prev) * (target.value(x) - base.value(x))).to(
                    x.device))
            log_w = torch.cat([st[f"w{s}"].to(ctrl) for s in range(n)])
            log_z_inc = torch.logsumexp(log_w, dim=0) - math.log(P)
            ess = 1.0 / torch.sum(torch.softmax(log_w, dim=0) ** 2)
            resample = ess < ess_threshold * P
            # Resample (the identity when the ESS test does not fire),
            # absorbing the weights into the running log-Z estimate.
            idx = torch.where(resample, systematic_resample_indices(bufs["u"][k], log_w),
                              torch.arange(P, device=ctrl))
            parts = torch.cat([st[f"x{s}"].to(ctrl) for s in range(n)])[idx]
            for s in range(n):
                x = st[f"x{s}"]
                x.copy_(parts[s * rows:(s + 1) * rows].to(x.device))
                w = st[f"w{s}"]
                w.copy_(torch.where(resample.to(w.device), 0.0, w))
            st["log_z"].copy_(torch.where(resample, st["log_z"] + log_z_inc, st["log_z"]))
            # n_moves overdamped Langevin steps on E_beta.
            noise = bufs["noise"][k]
            for m in range(n_moves):
                for s in range(n):
                    x = st[f"x{s}"]
                    xi = noise[m, s * rows:(s + 1) * rows].to(x.device)
                    x.copy_(x - moved.grad(x) * st["dt"].to(x.device)
                            + torch.sqrt(2.0 * st["dt"]).to(x.device) * xi)
            t.add_(1)
            bufs["ess"][k].copy_(ess)

        return StepLoop("annealed_smc", ctrl, step, st,
                        {"u": ("uniform", (1,), torch.float32),
                         "noise": ("normal", (n_moves, P, dim), torch.float32)},
                        {"ess": ((), torch.float32)}, graph=one_card, batched=batched)

    return cached_loop(("annealed_smc", energy_fn, devices, P, dim, n_steps, n_moves,
                        ess_threshold, graph), build)


def run_smc(draws: Draws, shards: list, *, energy_fn: EnergyFn, n_steps: int = 50,
            n_moves: int = 5, dt: float = 0.05, temperature: float = 1.0,
            base_sigma: float = 3.0, ess_threshold: float = 0.5, graph: bool = True) -> dict:
    """Annealed SMC on the particle shards ``shards`` (a list of (P_s, dim)
    tensors, each on its device; P_s equal) and ``draws`` ("u": (1,) and
    "noise": (n_moves, P, dim) per step). Returns the shards' final
    particles and log-weights, log_Z, ess_history and route."""
    devices = tuple(x.device for x in shards)
    P = sum(x.shape[0] for x in shards)
    dim = shards[0].shape[1]
    loop = smc_loop(energy_fn, devices, P, dim, n_steps=n_steps, n_moves=n_moves,
                    ess_threshold=ess_threshold, graph=graph, probe=torch.cat(
                        [x.to(devices[0]) for x in shards]))
    st = loop.state
    for s, x in enumerate(shards):
        st[f"x{s}"].copy_(x)
        st[f"w{s}"].zero_()
    st["log_z"].zero_()
    st["t"].zero_()
    st["T"].fill_(temperature)
    st["dt"].fill_(dt)
    st["base_sigma"].fill_(base_sigma)
    ess_history = torch.empty(n_steps, dtype=torch.float32, device=devices[0])
    i = 0
    for L in chunks(n_steps, max(1, GRADS_PER_GRAPH // max(n_moves, 1))):
        ess_history[i:i + L].copy_(loop.run(draws, L)["ess"])
        i += L
    n = len(shards)
    log_w = torch.cat([st[f"w{s}"].to(devices[0]) for s in range(n)])
    log_z = st["log_z"] + torch.logsumexp(log_w, dim=0) - math.log(P)
    return {"particles": [st[f"x{s}"].clone() for s in range(n)],
            "log_weights": [st[f"w{s}"].clone() for s in range(n)],
            "log_Z": log_z, "ess_history": ess_history, "route": loop.route}


def annealed_smc(seed, particles, *, energy_fn: EnergyFn, n_steps: int = 50, n_moves: int = 5,
                 dt: float = 0.05, friction: float = 1.0, temperature: float = 1.0,
                 base_sigma: float = 3.0, ess_threshold: float = 0.5, device=None) -> dict:
    """Anneal particles from N(0, base_sigma^2) to p ∝ exp(-E/T).

    Args:
        seed: an int or a CPU ``torch.Generator`` (seeds the run's device
            generator).
        particles: (P, dim) initial particles ~ N(0, base_sigma^2).
        friction: accepted for the reference's signature; the moves do not
            use it.
        device: where the particles live (default the card).
    Returns:
        dict with particles (P, dim), log_weights (P,), log_Z (0-dim),
        ess_history (n_steps,), all on ``device``, and route.
    """
    dev = resolve_device(device)
    out = run_smc(Draws(device_generator(seed, dev)), [as_states(particles, dev)],
                  energy_fn=energy_fn, n_steps=n_steps, n_moves=n_moves, dt=dt,
                  temperature=temperature, base_sigma=base_sigma, ess_threshold=ess_threshold)
    out["particles"], out["log_weights"] = out["particles"][0], out["log_weights"][0]
    return out
