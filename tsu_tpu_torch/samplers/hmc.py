"""Hamiltonian Monte Carlo with chains batched on one axis.

Counterpart of ``tsu_tpu/samplers/hmc.py``: :func:`sample_hmc` with a fixed
step size and trajectory length, and :func:`sample_hmc_adaptive` with
dual-averaging step adaptation and a trajectory length drawn per chain and
transition from [1, n_leapfrog]. The jittered length is applied by masking
a loop of ``n_leapfrog`` leapfrog steps (the reference's ``cond`` under
``vmap`` is the same select), so every transition has one shape and the
loops run as CUDA graphs on the card (``samplers/loop.py``). A state
carries its energy and gradient, so a leapfrog step evaluates one gradient.
``sample_hmc.last_route`` records the route of the last plain run; the
adaptive sampler's info dict carries its own.
"""

from __future__ import annotations

import torch

from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.energy import EnergyFn
from tsu_tpu_torch.rng import device_generator
from tsu_tpu_torch.samplers.loop import (
    Draws,
    Potential,
    StepLoop,
    adaptation_state,
    as_states,
    cached_loop,
    canonical,
    chunks,
    dual_average,
    record,
    route_of,
    scalar,
)

GRADS_PER_GRAPH = 256     # leapfrog gradients per CUDA graph


def _state(n_chains: int, dim: int, device, probe) -> dict:
    z = torch.zeros((n_chains, dim), dtype=torch.float32, device=device)
    return {"x": z.clone() if probe is None else probe.clone(), "g": z.clone(),
            "U": torch.zeros(n_chains, dtype=torch.float32, device=device),
            "T": scalar(1.0, device)}


def _metropolis(st: dict, p, q, pq, Uq, gq, u, clip: bool):
    """Accept (q, pq) against the state by H = U + |p|^2 / 2, in place.
    ``clip``: log alpha = min(., 0), a non-finite one counted as a rejection.
    Returns (accept, log alpha)."""
    h_old = st["U"] + 0.5 * torch.sum(p**2, dim=-1)
    h_new = Uq + 0.5 * torch.sum(pq**2, dim=-1)
    log_alpha = h_old - h_new
    if clip:
        log_alpha = torch.clamp(log_alpha, max=0.0)
        log_alpha = torch.where(torch.isfinite(log_alpha), log_alpha, float("-inf"))
    accept = torch.log(u) < log_alpha
    st["x"].copy_(torch.where(accept[:, None], q, st["x"]))
    st["U"].copy_(torch.where(accept, Uq, st["U"]))
    st["g"].copy_(torch.where(accept[:, None], gq, st["g"]))
    return accept, log_alpha


def hmc_loop(energy_fn: EnergyFn, n_chains: int, dim: int, device, *, n_leapfrog: int = 10,
             graph: bool = True, probe=None) -> StepLoop:
    """The (cached) transition loop of :func:`sample_hmc`; state x, U = E/T,
    g = grad U, T, eps, half = eps/2 and n_acc."""
    device = canonical(device)

    def build():
        st = _state(n_chains, dim, device, probe)
        st.update({"eps": scalar(0.1, device), "half": scalar(0.05, device),
                   "n_acc": torch.zeros((), dtype=torch.int64, device=device)})
        T, eps, half = st["T"], st["eps"], st["half"]
        pot = Potential(lambda y: energy_fn(y) / T, st["x"])

        def step(bufs, k):
            p = bufs["p"][k]
            q, pq = st["x"], p - half * st["g"]
            for _ in range(n_leapfrog - 1):
                q = q + eps * pq
                pq = pq - eps * pot.grad(q)
            q = q + eps * pq
            Uq, gq = pot.value_and_grad(q)
            pq = pq - half * gq
            accept, _ = _metropolis(st, p, q, pq, Uq, gq, bufs["u"][k], clip=False)
            st["n_acc"].add_(torch.sum(accept))
            bufs["x"][k].copy_(st["x"])

        loop = StepLoop("hmc", device, step, st,
                        {"p": ("normal", (n_chains, dim), torch.float32),
                         "u": ("uniform", (n_chains,), torch.float32)},
                        {"x": ((n_chains, dim), torch.float32)}, graph=graph,
                        batched=pot.batched)
        loop.potential = pot
        return loop

    return cached_loop(("hmc", energy_fn, n_chains, dim, device, n_leapfrog, graph), build)


def _start(loop, x0, temperature: float):
    st = loop.state
    st["T"].fill_(temperature)
    st["x"].copy_(x0)
    U, g = loop.potential.value_and_grad(st["x"])
    st["U"].copy_(U)
    st["g"].copy_(g)


def run_hmc(draws: Draws, x0: torch.Tensor, *, energy_fn: EnergyFn, n_samples: int,
            step_size: float = 0.1, n_leapfrog: int = 10, temperature: float = 1.0,
            n_burnin: int = 100, graph: bool = True):
    """:func:`sample_hmc` on ``draws`` ("p": (chains, dim) momenta and "u":
    (chains,) uniforms per transition, burn-in first). Returns (samples,
    accept_rate, route)."""
    C, dim = x0.shape
    loop = hmc_loop(energy_fn, C, dim, x0.device, n_leapfrog=n_leapfrog, graph=graph,
                    probe=x0)
    st = loop.state
    st["eps"].fill_(step_size)
    st["half"].copy_(0.5 * st["eps"])
    _start(loop, x0, temperature)
    L = max(1, GRADS_PER_GRAPH // n_leapfrog)
    for n in chunks(n_burnin, L):
        loop.run(draws, n)
    st["n_acc"].zero_()
    samples = torch.empty((C, n_samples, dim), dtype=torch.float32, device=x0.device)
    i = 0
    for n in chunks(n_samples, L):
        i = record(loop.run(draws, n), samples, i, n)
    return samples, int(st["n_acc"]) / (C * n_samples), loop.route


def sample_hmc(seed, x0, *, energy_fn: EnergyFn, n_samples: int, step_size: float = 0.1,
               n_leapfrog: int = 10, temperature: float = 1.0, n_burnin: int = 100,
               device=None):
    """HMC targeting p(x) ∝ exp(-E(x)/T).

    Args:
        seed: an int or a CPU ``torch.Generator`` (seeds the run's device
            generator).
        x0: (n_chains, dim) initial states.
        device: where the chains run (default the card).
    Returns:
        (samples (n_chains, n_samples, dim) on ``device``, accept_rate of
        the main loop).
    """
    dev = resolve_device(device)
    samples, rate, route = run_hmc(
        Draws(device_generator(seed, dev)), as_states(x0, dev), energy_fn=energy_fn,
        n_samples=n_samples, step_size=step_size, n_leapfrog=n_leapfrog,
        temperature=temperature, n_burnin=n_burnin)
    sample_hmc.last_route = route
    return samples, rate


sample_hmc.last_route = None


def hmc_adaptive_loops(energy_fn: EnergyFn, n_chains: int, dim: int, device, *,
                       n_leapfrog: int = 16, target_accept: float = 0.8, graph: bool = True,
                       probe=None) -> dict:
    """The (cached) burn-in and main loops of :func:`sample_hmc_adaptive`,
    sharing one state: x, U, g, T, the adaptation's tensors, eps (the main
    loop's step) and acc_sum."""
    device = canonical(device)

    def build():
        st = _state(n_chains, dim, device, probe)
        st.update({"eps": scalar(0.1, device), "acc_sum": scalar(0.0, device),
                   **adaptation_state(0.1, device)})
        T = st["T"]
        pot = Potential(lambda y: energy_fn(y) / T, st["x"])

        def transition(p, n, u, eps):
            half = 0.5 * eps
            q, pq, Uq, gq = st["x"], p - half * st["g"], st["U"], st["g"]
            for i in range(n_leapfrog):
                q1 = q + eps * pq
                U1, g1 = pot.value_and_grad(q1)
                p1 = torch.where((i < n - 1)[:, None], pq - eps * g1, pq)
                active = (i < n)[:, None]
                q = torch.where(active, q1, q)
                pq = torch.where(active, p1, pq)
                gq = torch.where(active, g1, gq)
                Uq = torch.where(active[:, 0], U1, Uq)
            pq = pq - half * gq
            _, log_alpha = _metropolis(st, p, q, pq, Uq, gq, u, clip=True)
            return torch.exp(log_alpha)

        def burn(bufs, k):
            alpha = transition(bufs["p"][k], bufs["n"][k], bufs["u"][k],
                               torch.exp(st["log_eps"]))
            dual_average(st, torch.mean(alpha), target_accept, clip=True)

        def main(bufs, k):
            st["acc_sum"].add_(torch.mean(transition(bufs["p"][k], bufs["n"][k], bufs["u"][k],
                                                     st["eps"])))
            bufs["x"][k].copy_(st["x"])

        draws = {"p": ("normal", (n_chains, dim), torch.float32),
                 "n": ("int", (n_chains,), torch.int64, 1, n_leapfrog + 1),
                 "u": ("uniform", (n_chains,), torch.float32)}
        return {"burn": StepLoop("hmc_adaptive burn-in", device, burn, st, draws, graph=graph,
                                 batched=pot.batched),
                "main": StepLoop("hmc_adaptive", device, main, st, draws,
                                 {"x": ((n_chains, dim), torch.float32)}, graph=graph,
                                 batched=pot.batched),
                "state": st, "potential": pot}

    return cached_loop(("hmc_adaptive", energy_fn, n_chains, dim, device, n_leapfrog,
                        target_accept, graph), build)


def run_hmc_adaptive(draws: Draws, x0: torch.Tensor, *, energy_fn: EnergyFn, n_samples: int,
                     n_leapfrog: int = 16, temperature: float = 1.0, n_burnin: int = 300,
                     target_accept: float = 0.8, graph: bool = True):
    """:func:`sample_hmc_adaptive` on ``draws`` ("p": (chains, dim) momenta,
    "n": (chains,) trajectory lengths in [1, n_leapfrog] and "u": (chains,)
    uniforms per transition, burn-in first)."""
    C, dim = x0.shape
    loops = hmc_adaptive_loops(energy_fn, C, dim, x0.device, n_leapfrog=n_leapfrog,
                               target_accept=target_accept, graph=graph, probe=x0)
    st = loops["state"]
    for name, t in adaptation_state(0.1, x0.device).items():
        st[name].copy_(t)
    st["acc_sum"].zero_()
    st["T"].fill_(temperature)
    st["x"].copy_(x0)
    U, g = loops["potential"].value_and_grad(st["x"])
    st["U"].copy_(U)
    st["g"].copy_(g)
    L = max(1, GRADS_PER_GRAPH // n_leapfrog)
    for n in chunks(n_burnin, L):
        loops["burn"].run(draws, n)
    st["eps"].copy_(torch.exp(st["log_eps_bar"]))
    samples = torch.empty((C, n_samples, dim), dtype=torch.float32, device=x0.device)
    i = 0
    for n in chunks(n_samples, L):
        i = record(loops["main"].run(draws, n), samples, i, n)
    return samples, {"accept_rate": float(st["acc_sum"]) / n_samples,
                     "step_size": float(st["eps"]), "route": route_of(loops["burn"], loops["main"])}


def sample_hmc_adaptive(seed, x0, *, energy_fn: EnergyFn, n_samples: int, n_leapfrog: int = 16,
                        temperature: float = 1.0, n_burnin: int = 300,
                        target_accept: float = 0.8, device=None):
    """HMC with dual-averaging step-size adaptation (from 0.1, log step held
    in [-10, 2]) and trajectory lengths drawn uniformly from [1, n_leapfrog]
    per chain and transition; a divergent trajectory counts as a rejection.
    Acceptance statistics average over all chains.

    Returns (samples (chains, n_samples, dim) on ``device``, info dict with
    accept_rate, step_size and route).
    """
    dev = resolve_device(device)
    return run_hmc_adaptive(Draws(device_generator(seed, dev)), as_states(x0, dev),
                            energy_fn=energy_fn, n_samples=n_samples, n_leapfrog=n_leapfrog,
                            temperature=temperature, n_burnin=n_burnin,
                            target_accept=target_accept)
