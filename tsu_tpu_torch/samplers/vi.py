"""Mean-field Gaussian variational inference for any energy.

Counterpart of ``tsu_tpu/samplers/vi.py``: fits q(x) = N(mu, diag(sigma^2))
to p(x) ∝ exp(-E(x)/T) by maximizing the reparameterized ELBO,

    ELBO(mu, rho) = E_q[-E(x)/T] + H(q),  x = mu + softplus(rho) * eps,

with ``torch.optim.Adam`` at optax's defaults (betas 0.9 / 0.999, eps 1e-8)
and a cosine decay of the learning rate to 0 over ``n_steps``, equal to
``optax.cosine_decay_schedule(lr, n_steps)``. The rate is a device tensor
the step sets from a device step count, so on the card a chunk of steps
(draws, ELBO gradient by ``torch.func``, Adam update) replays as one CUDA
graph (``samplers/loop.py``); Adam runs with ``capturable=True`` there.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.energy import EnergyFn
from tsu_tpu_torch.rng import as_generator, device_generator
from tsu_tpu_torch.samplers.loop import Draws, StepLoop, cached_loop, canonical, chunks, scalar

CHUNK = 64      # optimizer steps per CUDA graph


def softplus(rho: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(rho)), as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(rho, torch.zeros_like(rho))


class MeanFieldParams(NamedTuple):
    mu: torch.Tensor
    rho: torch.Tensor  # sigma = softplus(rho)

    @property
    def sigma(self):
        return softplus(self.rho)


def neg_elbo(mu: torch.Tensor, rho: torch.Tensor, eps: torch.Tensor, energy_fn: EnergyFn,
             temperature) -> torch.Tensor:
    """The negative ELBO on the normals ``eps`` (n_mc, dim):
    mean_i E(mu + sigma eps_i) / T - H(q)."""
    sigma = softplus(rho)
    energies = vmap(energy_fn)(mu + sigma * eps) / temperature
    entropy = torch.sum(torch.log(sigma)) + 0.5 * mu.shape[0] * (1.0 + math.log(2.0 * math.pi))
    return torch.mean(energies) - entropy


def vi_loop(energy_fn: EnergyFn, dim: int, n_mc: int, device, *, graph: bool = True) -> StepLoop:
    """The (cached) optimizer loop: state mu, rho (the parameters, their
    ``.grad`` set in place), the optimizer's moments and step, count, lr,
    lr0, n_steps and T. Records each step's loss."""
    device = canonical(device)

    def build():
        mu = torch.zeros(dim, dtype=torch.float32, device=device)
        rho = torch.zeros(dim, dtype=torch.float32, device=device)
        mu.grad, rho.grad = torch.zeros_like(mu), torch.zeros_like(rho)
        st = {"mu": mu, "rho": rho, "mu_grad": mu.grad, "rho_grad": rho.grad,
              "count": scalar(0.0, device), "lr": scalar(0.0, device),
              "lr0": scalar(0.0, device), "n_steps": scalar(1.0, device),
              "T": scalar(1.0, device)}
        opt = torch.optim.Adam([mu, rho], lr=st["lr"], betas=(0.9, 0.999), eps=1e-8,
                               foreach=False, capturable=device.type == "cuda")
        opt.step()          # zero gradients: creates the moments, moves nothing
        for i, p in enumerate((mu, rho)):
            for name, t in opt.state[p].items():
                t.zero_()
                st[f"adam_{name}_{i}"] = t
        value_grad = grad_and_value(lambda m, r, e: neg_elbo(m, r, e, energy_fn, st["T"]),
                                    argnums=(0, 1))

        def step(bufs, k):
            (g_mu, g_rho), loss = value_grad(mu, rho, bufs["eps"][k])
            mu.grad.copy_(g_mu)
            rho.grad.copy_(g_rho)
            frac = torch.clamp(st["count"], max=st["n_steps"]) / st["n_steps"]
            st["lr"].copy_(st["lr0"] * (0.5 * (1.0 + torch.cos(math.pi * frac))))
            opt.step()
            st["count"].add_(1.0)
            bufs["loss"][k].copy_(loss)

        return StepLoop("fit_meanfield_vi", device, step, st,
                        {"eps": ("normal", (n_mc, dim), torch.float32)},
                        {"loss": ((), torch.float32)}, graph=graph)

    return cached_loop(("vi", energy_fn, dim, n_mc, device, graph), build)


def run_vi(draws: Draws, energy_fn: EnergyFn, dim: int, device, *, temperature: float = 1.0,
           n_steps: int = 1000, n_mc: int = 16, learning_rate: float = 0.05, init_mu=None,
           init_sigma: float = 1.0, graph: bool = True):
    """The fit of :func:`fit_meanfield_vi` on ``draws`` ("eps": (n_mc, dim)
    normals per step). Returns (MeanFieldParams, losses (n_steps,), route)."""
    loop = vi_loop(energy_fn, dim, n_mc, device, graph=graph)
    st = loop.state
    for name, t in st.items():
        if name.startswith("adam_"):
            t.zero_()
    st["mu"].copy_(torch.zeros(dim) if init_mu is None
                   else torch.as_tensor(np.asarray(init_mu, np.float32)))
    st["rho"].fill_(float(np.log(np.expm1(init_sigma))))
    st["count"].zero_()
    st["lr0"].fill_(learning_rate)
    st["n_steps"].fill_(n_steps)
    st["T"].fill_(temperature)
    losses = torch.empty(n_steps, dtype=torch.float32, device=st["mu"].device)
    i = 0
    for L in chunks(n_steps, CHUNK):
        losses[i:i + L].copy_(loop.run(draws, L)["loss"])
        i += L
    return MeanFieldParams(st["mu"].clone(), st["rho"].clone()), losses, loop.route


def fit_meanfield_vi(seed, energy_fn: EnergyFn, dim: int, *, temperature: float = 1.0,
                     n_steps: int = 1000, n_mc: int = 16, learning_rate: float = 0.05,
                     init_mu=None, init_sigma: float = 1.0, device=None) -> dict:
    """Fit N(mu, diag(sigma^2)) to exp(-E/T).

    ``seed``: an int or a CPU ``torch.Generator`` (seeds the run's device
    generator). Returns dict with mu and sigma (on ``device``), the loss
    trace, a ``sample(generator, n)`` closure drawing (n, dim) from the
    fitted q (``generator``: an int or a CPU ``torch.Generator``), the final
    ELBO and the route.
    """
    dev = resolve_device(device)
    params, losses, route = run_vi(
        Draws(device_generator(seed, dev)), energy_fn, dim, dev, temperature=temperature,
        n_steps=n_steps, n_mc=n_mc, learning_rate=learning_rate, init_mu=init_mu,
        init_sigma=init_sigma)
    sigma = params.sigma

    def sample(generator, n_samples: int) -> torch.Tensor:
        eps = torch.randn((n_samples, dim), generator=as_generator(generator))
        return params.mu + sigma * eps.to(dev)

    return {"mu": params.mu, "sigma": sigma, "losses": losses, "sample": sample,
            "elbo": -float(losses[-1]), "route": route}
