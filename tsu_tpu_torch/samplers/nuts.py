"""No-U-Turn Sampler (iterative, multinomial) with chains batched on one axis.

Counterpart of ``tsu_tpu/samplers/nuts.py``: multinomial NUTS (Betancourt
2017) with the iterative subtree construction of Phan & Pradhan. Per
transition the trajectory doubles up to ``max_depth`` times in random
directions; each new subtree of 2^d leapfrog steps checks every balanced
sub-subtree for a U-turn between its endpoints and reservoir-samples its
leaves by exp(-H); a subtree with a U-turn or a divergence stops the
doubling without contributing a candidate, otherwise its candidate replaces
the old one with probability W_new / W_total. The step size adapts by dual
averaging during burn-in.

**Masked, as the reference runs under vmap.** There ``lax.cond(done, ...)``
becomes a select, so every chain builds every subtree of depth 0 ..
max_depth - 1 (2^max_depth - 1 leapfrog steps) and ``done`` only masks the
state. Here too: chains are a batch axis, the doubling and the leaves are
Python loops with static indices, and ``torch.where`` masks a finished
chain. The transition has one shape, needs no host sync and runs as one
CUDA graph on the card (``samplers/loop.py``). On the CPU, where a sync
costs nothing, the doubling stops once every chain is done, which changes
no result.

**One repair against the reference.** A backward subtree's U-turn checks
take the momenta in time order, as the forward ones do; the reference's
(``tsu_tpu/samplers/nuts.py:83-87``) flip their sign, which over-disperses
the slow direction of an anisotropic Gaussian (ROADMAP.md §3).

A transition's draws: (chains, dim) momenta and, per depth d, a direction
uniform, 2^d leaf uniforms and the biased-sampling uniform, laid out
``[dir_0, leaves_0, bias_0, dir_1, ...]`` in one (chains,
2 max_depth + 2^max_depth - 1) block.
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
    dual_average,
    route_of,
    scalar,
)

_DIVERGENCE = 1000.0  # energy-error threshold for divergent trajectories


def n_uniforms(max_depth: int) -> int:
    """Uniforms one transition takes per chain."""
    return 2 * max_depth + 2**max_depth - 1


def _offset(d: int) -> int:
    """Column of depth d's direction uniform in a transition's block."""
    return 2 * d + 2**d - 1


def _uturn(dq, p_left, p_right):
    """U-turn between endpoints, velocities in trajectory order."""
    return (torch.sum(dq * p_left, dim=-1) < 0.0) | (torch.sum(dq * p_right, dim=-1) < 0.0)


def _where(mask, a, b):
    """``torch.where`` with a (chains,) mask against (chains,) or (chains,
    dim) values."""
    return torch.where(mask if a.dim() == 1 else mask[:, None], a, b)


def _build_subtree(pot, q0, p0, g0, direction, depth: int, eps, h0, u_leaves):
    """2^depth leapfrog steps from (q0, p0), whose gradient is g0, in
    ``direction`` ((chains, 1) of ±1), each chain on its own.

    Returns dict with the far end (q, p, g), the multinomial candidate,
    logW and the turned flag (a U-turn or a divergence)."""
    eps_d = direction * eps
    q, p, g = q0, p0, g0
    cand = q0
    logW = torch.full_like(h0, float("-inf"))
    turned = torch.zeros_like(h0, dtype=torch.bool)
    diverged = torch.zeros_like(turned)
    q_stack, p_stack = {}, {}
    for n in range(2**depth):
        p = p - 0.5 * eps_d * g
        q = q + eps_d * p
        U, g = pot.value_and_grad(q)
        p = p - 0.5 * eps_d * g
        h = U + 0.5 * torch.sum(p**2, dim=-1)
        logw = h0 - h
        diverged = diverged | (h - h0 > _DIVERGENCE) | ~torch.isfinite(h)
        # n is the left leaf of the level-l subtrees with n % 2^l == 0; the
        # level-l subtrees with (n + 1) % 2^l == 0 are complete.
        for lvl in range(1, depth + 1):
            if n % 2**lvl == 0:
                q_stack[lvl], p_stack[lvl] = q, p
        # In trajectory (time) order the sub-subtree runs from q_stack to q
        # forward and from q to q_stack backward, and its velocities are
        # the momenta themselves. (The reference multiplies the momenta by
        # the direction as well, which turns the test round on backward
        # subtrees: it stops straight runs and biases the chain.)
        for lvl in range(1, depth + 1):
            if (n + 1) % 2**lvl == 0:
                dq = (q - q_stack[lvl]) * direction
                turned = turned | _uturn(dq, p_stack[lvl], p)
        # Multinomial reservoir over leaves.
        logW_new = torch.logaddexp(logW, logw)
        take = torch.log(u_leaves[:, n]) < logw - logW_new
        cand = _where(take & ~diverged, q, cand)
        logW = torch.where(diverged, logW, logW_new)
    return {"q": q, "p": p, "g": g, "cand": cand, "logW": logW, "turned": turned | diverged}


def nuts_transition(pot: Potential, q, eps, p0, u, max_depth: int, early_exit: bool = False):
    """One NUTS transition of every chain from q (chains, dim) at step size
    ``eps`` (0-dim) on the momenta ``p0`` and the uniforms ``u`` (chains,
    n_uniforms(max_depth)). ``early_exit`` stops the doubling once every
    chain is done (a host sync). Returns (candidate (chains, dim),
    acceptance statistic (chains,), tree depth (chains,) float32)."""
    U0, g0 = pot.value_and_grad(q)
    h0 = U0 + 0.5 * torch.sum(p0**2, dim=-1)
    C = q.shape[0]
    s = {"q_left": q, "p_left": p0, "g_left": g0, "q_right": q, "p_right": p0, "g_right": g0,
         "cand": q, "logW": torch.zeros_like(h0), "depth": torch.zeros_like(h0),
         "done": torch.zeros(C, dtype=torch.bool, device=q.device),
         "sum_alpha": torch.zeros_like(h0), "n_alpha": torch.zeros_like(h0)}
    for d in range(max_depth):
        if early_exit and bool(s["done"].all()):
            break
        o = _offset(d)
        go_right = u[:, o] < 0.5
        right = go_right[:, None]
        direction = torch.where(right, 1.0, -1.0)
        tree = _build_subtree(pot, torch.where(right, s["q_right"], s["q_left"]),
                              torch.where(right, s["p_right"], s["p_left"]),
                              torch.where(right, s["g_right"], s["g_left"]),
                              direction, d, eps, h0, u[:, o + 1:o + 1 + 2**d])
        # Acceptance statistic: mean of min(1, exp(h0 - h)) over the new
        # subtree ~ exp(logW - log L) bounded by 1.
        alpha = torch.clamp(torch.exp(tree["logW"]) / float(2**d), max=1.0)
        new = {"sum_alpha": s["sum_alpha"] + alpha, "n_alpha": s["n_alpha"] + 1.0,
               "depth": s["depth"] + 1.0}
        for side in ("q", "p", "g"):
            new[f"{side}_left"] = torch.where(right, s[f"{side}_left"], tree[side])
            new[f"{side}_right"] = torch.where(right, tree[side], s[f"{side}_right"])
        # Biased progressive sampling from the VALID new subtree.
        accept_new = (torch.log(u[:, o + 1 + 2**d]) < tree["logW"] - s["logW"]) & ~tree["turned"]
        new["cand"] = _where(accept_new, tree["cand"], s["cand"])
        new["logW"] = torch.logaddexp(
            s["logW"], torch.where(tree["turned"], float("-inf"), tree["logW"]))
        # Stop on a subtree U-turn or divergence, or a global U-turn.
        global_turn = _uturn(new["q_right"] - new["q_left"], new["p_left"], new["p_right"])
        new["done"] = tree["turned"] | global_turn
        active = ~s["done"]
        s = {k: _where(active, new[k], v) for k, v in s.items()}
    accept_stat = s["sum_alpha"] / torch.clamp(s["n_alpha"], min=1.0)
    return s["cand"], accept_stat, s["depth"]


def nuts_loops(energy_fn: EnergyFn, n_chains: int, dim: int, device, *, max_depth: int = 8,
               target_accept: float = 0.8, graph: bool = True, probe=None) -> dict:
    """The (cached) burn-in and main loops of :func:`sample_nuts`, one
    transition a step, sharing one state: x, T, the adaptation's tensors,
    eps (the main loop's step), acc and depth_sum."""
    device = canonical(device)

    def build():
        x = (torch.zeros((n_chains, dim), dtype=torch.float32, device=device)
             if probe is None else probe.clone())
        st = {"x": x, "T": scalar(1.0, device), "eps": scalar(0.1, device),
              "acc": scalar(0.0, device), "depth_sum": scalar(0.0, device),
              **adaptation_state(0.1, device)}
        T = st["T"]
        pot = Potential(lambda y: energy_fn(y) / T, x)
        early = device.type != "cuda"

        def burn(bufs, k):
            cand, alpha, _ = nuts_transition(pot, x, torch.exp(st["log_eps"]), bufs["p"][k],
                                             bufs["u"][k], max_depth, early)
            x.copy_(cand)
            dual_average(st, torch.mean(alpha), target_accept, clip=True)

        def main(bufs, k):
            cand, alpha, depth = nuts_transition(pot, x, st["eps"], bufs["p"][k], bufs["u"][k],
                                                 max_depth, early)
            x.copy_(cand)
            st["acc"].add_(torch.mean(alpha))
            st["depth_sum"].add_(torch.mean(depth))
            bufs["x"][k].copy_(x)

        draws = {"p": ("normal", (n_chains, dim), torch.float32),
                 "u": ("uniform", (n_chains, n_uniforms(max_depth)), torch.float32)}
        return {"burn": StepLoop("nuts burn-in", device, burn, st, draws, graph=graph,
                                 batched=pot.batched),
                "main": StepLoop("nuts", device, main, st, draws,
                                 {"x": ((n_chains, dim), torch.float32)}, graph=graph,
                                 batched=pot.batched),
                "state": st, "potential": pot}

    return cached_loop(("nuts", energy_fn, n_chains, dim, device, max_depth, target_accept,
                        graph), build)


def run_nuts(draws: Draws, x0: torch.Tensor, *, energy_fn: EnergyFn, n_samples: int,
             max_depth: int = 8, temperature: float = 1.0, n_burnin: int = 300,
             target_accept: float = 0.8, init_step_size: float = 0.1, graph: bool = True):
    """:func:`sample_nuts` on ``draws`` ("p": (chains, dim) momenta and "u":
    (chains, n_uniforms(max_depth)) uniforms per transition, burn-in
    first), one transition per graph replay."""
    C, dim = x0.shape
    loops = nuts_loops(energy_fn, C, dim, x0.device, max_depth=max_depth,
                       target_accept=target_accept, graph=graph, probe=x0)
    st = loops["state"]
    for name, t in adaptation_state(init_step_size, x0.device).items():
        st[name].copy_(t)
    st["acc"].zero_()
    st["depth_sum"].zero_()
    st["T"].fill_(temperature)
    st["x"].copy_(x0)
    for _ in range(n_burnin):
        loops["burn"].run(draws, 1)
    st["eps"].copy_(torch.exp(st["log_eps_bar"]))
    samples = torch.empty((C, n_samples, dim), dtype=torch.float32, device=x0.device)
    for i in range(n_samples):
        samples[:, i].copy_(loops["main"].run(draws, 1)["x"][0])
    return samples, {"accept_stat": float(st["acc"]) / n_samples,
                     "mean_tree_depth": float(st["depth_sum"]) / n_samples,
                     "step_size": float(st["eps"]), "route": route_of(loops["burn"], loops["main"])}


def sample_nuts(seed, x0, *, energy_fn: EnergyFn, n_samples: int, max_depth: int = 8,
                temperature: float = 1.0, n_burnin: int = 300, target_accept: float = 0.8,
                init_step_size: float = 0.1, device=None):
    """NUTS targeting p ∝ exp(-E/T); batched chains, adapted step size.

    Returns (samples (n_chains, n_samples, dim) on ``device``, info dict
    with accept_stat, mean_tree_depth, step_size and route).
    """
    dev = resolve_device(device)
    return run_nuts(Draws(device_generator(seed, dev)), as_states(x0, dev),
                    energy_fn=energy_fn, n_samples=n_samples, max_depth=max_depth,
                    temperature=temperature, n_burnin=n_burnin, target_accept=target_accept,
                    init_step_size=init_step_size)
