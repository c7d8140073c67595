"""Langevin dynamics samplers, batched over chains.

Counterpart of ``tsu_tpu/samplers/langevin.py``. Two integrators:
  * overdamped Euler-Maruyama:
    x += -grad E * dt/gamma + sqrt(2 T dt/gamma) xi
  * underdamped BAOAB (default), second-order accurate.

The gradient of the end of a step is the gradient of the start of the next
(the same state), so each step evaluates one gradient and carries it. On
the card the steps run as a CUDA graph of up to ``CHUNK`` steps, replayed
(``samplers/loop.py``); the step's normals are drawn into the graph's
buffer before each replay. ``sample_langevin.last_route`` records the
route of the last run.
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
    as_states,
    cached_loop,
    canonical,
    chunks,
    scalar,
)

CHUNK = 128      # steps per CUDA graph


def make_langevin_step(energy_fn: EnergyFn, state: dict, *, underdamped: bool = True):
    """One Langevin step ``step(noise)`` on the batch ``state``: x, v
    (chains, dim), g = grad E(x), and the 0-dim constants of the run (hdt =
    dt/2, mass, c1 and c2 for BAOAB; dt, fr = gamma and s = sqrt(2 T dt /
    gamma) for Euler-Maruyama), all updated in place. Returns (step,
    potential)."""
    x, v, g = state["x"], state["v"], state["g"]
    pot = Potential(energy_fn, x)

    if underdamped:
        hdt, mass, c1, c2 = state["hdt"], state["mass"], state["c1"], state["c2"]

        def step(noise):
            # BAOAB splitting (Leimkuhler & Matthews).
            v.sub_(hdt * g / mass)
            x.add_(hdt * v)
            v.mul_(c1).add_(c2 * noise)
            x.add_(hdt * v)
            g.copy_(pot.grad(x))
            v.sub_(hdt * g / mass)
    else:
        dt, fr, s = state["dt"], state["fr"], state["s"]

        def step(noise):
            x.sub_(g * dt / fr).add_(s * noise)
            g.copy_(pot.grad(x))

    return step, pot


def langevin_loop(energy_fn: EnergyFn, n_chains: int, dim: int, device, *,
                  underdamped: bool = True, graph: bool = True, probe=None) -> StepLoop:
    """The (cached) step loop of ``n_chains`` x ``dim`` states; ``probe``
    (chains, dim) is a state the energy can be evaluated at."""

    device = canonical(device)

    def build():
        z = torch.zeros((n_chains, dim), dtype=torch.float32, device=device)
        state = {"x": z.clone(), "v": z.clone(), "g": z.clone()}
        if underdamped:
            state.update({k: scalar(0.0, device) for k in ("hdt", "mass", "c1", "c2")})
        else:
            state.update({k: scalar(0.0, device) for k in ("dt", "fr", "s")})
        if probe is not None:
            state["x"].copy_(probe)
        step, pot = make_langevin_step(energy_fn, state, underdamped=underdamped)
        loop = StepLoop("langevin", device, lambda bufs, k: step(bufs["noise"][k]), state,
                        {"noise": ("normal", (n_chains, dim), torch.float32)}, graph=graph,
                        batched=pot.batched)
        loop.potential = pot
        return loop

    return cached_loop(("langevin", energy_fn, n_chains, dim, device,
                        underdamped, graph), build)


def run_langevin(draws: Draws, x0: torch.Tensor, *, energy_fn: EnergyFn, n_samples: int,
                 temperature: float = 1.0, dt: float = 0.01, friction: float = 1.0,
                 mass: float = 1.0, n_burnin: int = 100, n_steps: int = 10,
                 underdamped: bool = True, graph: bool = True):
    """:func:`sample_langevin` on the draws ``draws`` ("v0": (chains, dim)
    normals of the initial velocity, underdamped only; "noise": one (chains,
    dim) block per step, burn-in first), on x0's device. Returns (samples
    (chains, n_samples, dim), route)."""
    C, dim = x0.shape
    dev = x0.device
    loop = langevin_loop(energy_fn, C, dim, dev, underdamped=underdamped, graph=graph,
                         probe=x0)
    st = loop.state
    T, dt_, fr, m = (scalar(a, dev) for a in (temperature, dt, friction, mass))
    st["x"].copy_(x0)
    if underdamped:
        st["hdt"].copy_(0.5 * dt_)
        st["mass"].copy_(m)
        st["c1"].copy_(torch.exp(-fr * dt_))
        st["c2"].copy_(torch.sqrt((1.0 - st["c1"] ** 2) * T / m))
        draws.fill("v0", "normal", st["v"])
        st["v"].mul_(torch.sqrt(T / m))
    else:
        st["dt"].copy_(dt_)
        st["fr"].copy_(fr)
        st["s"].copy_(torch.sqrt(2.0 * T * dt_ / fr))
    st["g"].copy_(loop.potential.grad(st["x"]))

    for L in chunks(n_burnin, CHUNK):
        loop.run(draws, L)
    samples = torch.empty((C, n_samples, dim), dtype=torch.float32, device=dev)
    for i in range(n_samples):
        for L in chunks(n_steps, CHUNK):
            loop.run(draws, L)
        samples[:, i].copy_(st["x"])
    return samples, loop.route


def sample_langevin(seed, x0, *, energy_fn: EnergyFn, n_samples: int,
                    temperature: float = 1.0, dt: float = 0.01, friction: float = 1.0,
                    mass: float = 1.0, n_burnin: int = 100, n_steps: int = 10,
                    underdamped: bool = True, device=None) -> torch.Tensor:
    """Sample from p(x) ∝ exp(-E(x)/T) with Langevin dynamics.

    Args:
        seed: an int or a CPU ``torch.Generator``; the run's device
            generator is seeded from it.
        x0: initial states (n_chains, dim) (numpy or tensor).
        energy_fn: a scalar energy of one (dim,) state, in torch operations.
        n_samples: samples retained per chain.
        n_steps: integration steps between retained samples (thinning).
        device: where the chains run (default the card).

    Returns:
        samples (n_chains, n_samples, dim) on ``device``. The initial
        velocity is sqrt(T/m) N(0, 1).
    """
    dev = resolve_device(device)
    samples, route = run_langevin(
        Draws(device_generator(seed, dev)), as_states(x0, dev), energy_fn=energy_fn, n_samples=n_samples,
        temperature=temperature, dt=dt, friction=friction, mass=mass, n_burnin=n_burnin,
        n_steps=n_steps, underdamped=underdamped)
    sample_langevin.last_route = route
    return samples


sample_langevin.last_route = None
