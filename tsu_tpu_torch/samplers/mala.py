"""Metropolis-adjusted Langevin (MALA) with dual-averaging step adaptation.

Counterpart of ``tsu_tpu/samplers/mala.py``: an overdamped proposal with a
Metropolis correction; during burn-in the step size adapts toward a target
acceptance rate (0.574 is optimal for MALA) from the acceptance averaged
over all chains. The step size and the adaptation's state are device
tensors, so the burn-in and the main loop each run as CUDA graphs on the
card with no host sync (``samplers/loop.py``). Each state carries its
energy and gradient, so a step evaluates one gradient, at the proposal.
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

CHUNK = 128      # steps per CUDA graph


def mala_loops(energy_fn: EnergyFn, n_chains: int, dim: int, device, *, adapt: bool = True,
               target_accept: float = 0.574, graph: bool = True, probe=None) -> dict:
    """The (cached) burn-in and main loops of ``n_chains`` x ``dim`` states,
    sharing one state: x, U = E(x)/T, g = grad U, T, the adaptation's
    tensors, eps (the main loop's step) and n_acc."""
    device = canonical(device)

    def build():
        z = torch.zeros((n_chains, dim), dtype=torch.float32, device=device)
        st = {"x": z.clone() if probe is None else probe.clone(), "g": z.clone(),
              "U": torch.zeros(n_chains, dtype=torch.float32, device=device),
              "T": scalar(1.0, device), "eps": scalar(1.0, device),
              "n_acc": torch.zeros((), dtype=torch.int64, device=device),
              **adaptation_state(1.0, device)}
        x, U, g, T = st["x"], st["U"], st["g"], st["T"]
        pot = Potential(lambda y: energy_fn(y) / T, x)

        def transition(noise, u, eps):
            prop = x - eps * g + torch.sqrt(2.0 * eps) * noise
            Up, gp = pot.value_and_grad(prop)
            q_back = -torch.sum((x - (prop - eps * gp)) ** 2, dim=-1) / (4.0 * eps)
            q_fwd = -torch.sum((prop - (x - eps * g)) ** 2, dim=-1) / (4.0 * eps)
            accept = torch.log(u) < -Up - (-U) + q_back - q_fwd
            x.copy_(torch.where(accept[:, None], prop, x))
            U.copy_(torch.where(accept, Up, U))
            g.copy_(torch.where(accept[:, None], gp, g))
            return accept

        def burn(bufs, k):
            accept = transition(bufs["noise"][k], bufs["u"][k], torch.exp(st["log_eps"]))
            if adapt:
                dual_average(st, torch.mean(accept.to(torch.float32)), target_accept, clip=False)

        def main(bufs, k):
            st["n_acc"].add_(torch.sum(transition(bufs["noise"][k], bufs["u"][k], st["eps"])))
            bufs["x"][k].copy_(x)

        draws = {"noise": ("normal", (n_chains, dim), torch.float32),
                 "u": ("uniform", (n_chains,), torch.float32)}
        return {"burn": StepLoop("mala burn-in", device, burn, st, draws, graph=graph,
                                 batched=pot.batched),
                "main": StepLoop("mala", device, main, st, draws,
                                 {"x": ((n_chains, dim), torch.float32)}, graph=graph,
                                 batched=pot.batched),
                "state": st, "potential": pot}

    return cached_loop(("mala", energy_fn, n_chains, dim, device, adapt, target_accept, graph),
                       build)


def run_mala(draws: Draws, x0: torch.Tensor, *, energy_fn: EnergyFn, n_samples: int,
             step_size: float = 0.1, temperature: float = 1.0, n_burnin: int = 200,
             target_accept: float = 0.574, adapt: bool = True, graph: bool = True):
    """:func:`sample_mala` on ``draws`` ("noise": (chains, dim) normals and
    "u": (chains,) uniforms per step, burn-in first), on x0's device."""
    C, dim = x0.shape
    loops = mala_loops(energy_fn, C, dim, x0.device, adapt=adapt, target_accept=target_accept,
                       graph=graph, probe=x0)
    st = loops["state"]
    for name, t in adaptation_state(step_size, x0.device).items():
        st[name].copy_(t)
    st["T"].fill_(temperature)
    st["n_acc"].zero_()
    st["x"].copy_(x0)
    U, g = loops["potential"].value_and_grad(st["x"])
    st["U"].copy_(U)
    st["g"].copy_(g)
    for L in chunks(n_burnin, CHUNK):
        loops["burn"].run(draws, L)
    st["eps"].copy_(torch.exp(st["log_eps_bar"]))
    samples = torch.empty((C, n_samples, dim), dtype=torch.float32, device=x0.device)
    i = 0
    for L in chunks(n_samples, CHUNK):
        i = record(loops["main"].run(draws, L), samples, i, L)
    return samples, {"accept_rate": int(st["n_acc"]) / (C * n_samples),
                     "step_size": float(st["eps"]), "route": route_of(loops["burn"], loops["main"])}


def sample_mala(seed, x0, *, energy_fn: EnergyFn, n_samples: int, step_size: float = 0.1,
                temperature: float = 1.0, n_burnin: int = 200, target_accept: float = 0.574,
                adapt: bool = True, device=None):
    """MALA targeting p ∝ exp(-E/T).

    Args:
        seed: an int or a CPU ``torch.Generator`` (seeds the run's device
            generator).
        x0: (n_chains, dim) initial states.
        device: where the chains run (default the card).
    Returns:
        (samples (n_chains, n_samples, dim) on ``device``, info dict with
        accept_rate, the adapted step size exp(log_eps_bar) and the route).
    """
    dev = resolve_device(device)
    return run_mala(Draws(device_generator(seed, dev)), as_states(x0, dev),
                    energy_fn=energy_fn, n_samples=n_samples, step_size=step_size,
                    temperature=temperature, n_burnin=n_burnin, target_accept=target_accept,
                    adapt=adapt)
