"""The port's continuous samplers against the JAX package on the
reference's own draws.

Each test rebuilds the draws that ``tsu_tpu``'s sampler takes from its key
schedule with ``jax.random`` and hands them to the port's run function
(``Draws(given=...)``), on the CPU. States agree within atol 1e-4 (float32
arithmetic in another order), accept rates and adapted step sizes within
the stated tolerances; ``systematic_resample_indices`` and the NUTS tree
depth are equal. NUTS is held against the reference with its backward
U-turn check repaired, as the port repairs it.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsu_tpu.energy import BNNPosterior as JaxBNNPosterior
from tsu_tpu.energy import MixtureOfGaussians as JaxMixture
from tsu_tpu.energy import Quadratic as JaxQuadratic
from tsu_tpu.samplers import hmc as jax_hmc
from tsu_tpu.samplers import nuts as jax_nuts
from tsu_tpu.samplers import smc as jax_smc
from tsu_tpu.samplers import vi as jax_vi
from tsu_tpu.samplers.langevin import sample_langevin as jax_sample_langevin
from tsu_tpu.samplers.mala import sample_mala as jax_sample_mala
from tsu_tpu_torch.energy import MixtureOfGaussians, Quadratic
from tsu_tpu_torch.interop import bnn_posterior_from_numpy, states_from_numpy
from tsu_tpu_torch.samplers.hmc import run_hmc, run_hmc_adaptive
from tsu_tpu_torch.samplers.langevin import run_langevin
from tsu_tpu_torch.samplers.loop import Draws, Potential
from tsu_tpu_torch.samplers.mala import run_mala
from tsu_tpu_torch.samplers.nuts import n_uniforms, nuts_transition
from tsu_tpu_torch.samplers.smc import run_smc, systematic_resample_indices
from tsu_tpu_torch.samplers.vi import neg_elbo

ATOL = 1e-4      # float32 states after a few hundred steps in another order


def _np(a):
    return np.asarray(a)


def _start(seed, C, D, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=(C, D))).astype(np.float32)


def _given(**draws):
    return Draws(given={k: torch.as_tensor(np.array(v)) for k, v in draws.items()})


@pytest.mark.parametrize("underdamped", [True, False])
def test_langevin_equals_jax(underdamped):
    C, D, nb, ns, nst = 4, 3, 40, 10, 5
    key = jax.random.key(11)
    x0 = _start(0, C, D)
    kw = dict(n_samples=ns, temperature=0.7, dt=0.05, friction=1.3, mass=2.0, n_burnin=nb,
              n_steps=nst, underdamped=underdamped)
    ref = _np(jax_sample_langevin(key, x0, energy_fn=JaxQuadratic(0.5, 1.3), **kw))

    def chain(k):
        v0 = jax.random.normal(jax.random.fold_in(k, 0), (D,))
        k1 = jax.random.fold_in(k, 1)
        subs = []
        for _ in range(nb + ns * nst):
            k1, sub = jax.random.split(k1)
            subs.append(sub)
        return v0, jax.vmap(lambda s: jax.random.normal(s, (D,)))(jnp.stack(subs))

    v0, noise = jax.vmap(chain)(jax.random.split(key, C))
    out, route = run_langevin(_given(v0=v0, noise=np.swapaxes(_np(noise), 0, 1)),
                              torch.tensor(x0), energy_fn=Quadratic(0.5, 1.3), **kw)
    assert route == "eager"
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def _split_steps(key, n, C, per_chain):
    """The reference's per-step draws: split(key, n)[t] -> split(., C)[c]
    -> per_chain(chain key)."""
    return jax.vmap(lambda k: jax.vmap(per_chain)(jax.random.split(k, C)))(
        jax.random.split(key, n))


@pytest.mark.parametrize("adapt", [True, False])
def test_mala_equals_jax(adapt):
    C, D, nb, ns = 6, 3, 60, 30
    key = jax.random.key(3)
    x0 = _start(1, C, D)
    kw = dict(n_samples=ns, step_size=0.05, temperature=1.5, n_burnin=nb, adapt=adapt)
    ref, info = jax_sample_mala(key, x0, energy_fn=JaxQuadratic(1.0, 0.8), **kw)

    def chain(k):
        k_n, k_a = jax.random.split(k)
        return jax.random.normal(k_n, (D,)), jax.random.uniform(k_a)

    k_burn, k_main = jax.random.split(key)
    noise, u = (np.concatenate([_np(a), _np(b)]) for a, b in zip(
        _split_steps(k_burn, nb, C, chain), _split_steps(k_main, ns, C, chain)))
    out, pinfo = run_mala(_given(noise=noise, u=u), torch.tensor(x0),
                          energy_fn=Quadratic(1.0, 0.8), **kw)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATOL)
    assert pinfo["accept_rate"] == pytest.approx(float(info["accept_rate"]), abs=1e-6)
    assert pinfo["step_size"] == pytest.approx(float(info["step_size"]), rel=1e-5)


def test_hmc_equals_jax():
    C, D, nb, ns = 5, 2, 20, 15
    key = jax.random.key(4)
    x0 = _start(2, C, D)
    kw = dict(n_samples=ns, step_size=0.2, n_leapfrog=6, temperature=1.2, n_burnin=nb)
    energy = JaxMixture(((-1.0, 0.0), (1.5, 0.5)), (0.7, 0.9))
    ref, rate = jax_hmc.sample_hmc(key, x0, energy_fn=energy, **kw)

    def steps(k, n):
        def one(kk):
            k_mom, k_acc = jax.random.split(kk)
            return jax.random.normal(k_mom, (D,)), jax.random.uniform(k_acc)
        return jax.vmap(one)(jax.random.split(k, n))

    def chain(k):
        (pb, ub), (pm, um) = steps(jax.random.fold_in(k, 0), nb), steps(jax.random.fold_in(k, 1), ns)
        return jnp.concatenate([pb, pm]), jnp.concatenate([ub, um])

    p, u = jax.vmap(chain)(jax.random.split(key, C))
    out, prate, route = run_hmc(_given(p=np.swapaxes(_np(p), 0, 1), u=np.swapaxes(_np(u), 0, 1)),
                                torch.tensor(x0), energy_fn=MixtureOfGaussians(
                                    ((-1.0, 0.0), (1.5, 0.5)), (0.7, 0.9)), **kw)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATOL)
    assert prate == pytest.approx(float(rate), abs=1e-6)


@pytest.mark.parametrize("nb, ns", [(0, 60), (4, 20)])
def test_hmc_adaptive_equals_jax(nb, ns):
    """The masked, jittered trajectories at the fixed initial step (no
    burn-in) over 60 transitions, and the adaptation over its first four.
    Beyond that the dual averaging's feedback (gain sqrt(t)/gamma) grows
    the one-ulp differences of exp and log between XLA's CPU library and
    torch's about tenfold every four burn-in transitions at this target,
    so later trajectories part by more than float32 tolerance."""
    C, D, L = 6, 3, 8
    key = jax.random.key(5)
    x0 = _start(3, C, D)
    kw = dict(n_samples=ns, n_leapfrog=L, temperature=1.0, n_burnin=nb, target_accept=0.75)
    ref, info = jax_hmc.sample_hmc_adaptive(key, x0, energy_fn=JaxQuadratic(-0.5, 0.6), **kw)

    def chain(k):
        k_m, k_l, k_a = jax.random.split(k, 3)
        return (jax.random.normal(k_m, (D,)), jax.random.randint(k_l, (), 1, L + 1),
                jax.random.uniform(k_a))

    k_burn, k_main = jax.random.split(key)
    p, n, u = (np.concatenate([_np(a), _np(b)]) for a, b in zip(
        _split_steps(k_burn, max(nb, 1), C, chain), _split_steps(k_main, ns, C, chain)))
    if nb == 0:
        p, n, u = p[1:], n[1:], u[1:]
    out, pinfo = run_hmc_adaptive(_given(p=p, n=n, u=u), torch.tensor(x0),
                                  energy_fn=Quadratic(-0.5, 0.6), **kw)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATOL)
    assert pinfo["accept_rate"] == pytest.approx(float(info["accept_rate"]), abs=1e-5)
    assert pinfo["step_size"] == pytest.approx(float(info["step_size"]), rel=1e-5)


def _nuts_draws(keys, D, max_depth):
    """The draws of one reference transition per chain key: the momentum
    and, per depth, the direction, leaf and bias uniforms (keys advance as
    if no chain stopped; a stopped chain's later draws are masked)."""
    def chain(key):
        k_mom, k = jax.random.split(key)
        us = []
        for d in range(max_depth):
            k, k_dir, k_sub, k_bias = jax.random.split(k, 4)
            us.append(jax.random.uniform(k_dir)[None])
            leaves = []
            for _ in range(2**d):
                k_sub, sub = jax.random.split(k_sub)
                leaves.append(jax.random.uniform(sub))
            us.append(jnp.stack(leaves))
            us.append(jax.random.uniform(k_bias)[None])
        return jax.random.normal(k_mom, (D,)), jnp.concatenate(us)

    return jax.vmap(chain)(keys)


def _repaired_build_subtree():
    """The reference's ``_build_subtree`` with its one fault repaired: a
    backward subtree's U-turn checks take the momenta as they are (in time
    order), not multiplied by the direction."""
    src = inspect.getsource(jax_nuts._build_subtree)
    bad = "_uturn(dq, direction * p_stack[l],\n                                             direction * p)"
    assert bad in src
    ns = dict(vars(jax_nuts))
    exec(src.replace(bad, "_uturn(dq, p_stack[l], p)"), ns)
    return ns["_build_subtree"]


@pytest.mark.parametrize("eps", [0.3, 1.1])
def test_nuts_transition_equals_jax(eps, monkeypatch):
    """Against the reference with its backward U-turn check repaired (the
    next test shows the fault)."""
    monkeypatch.setattr(jax_nuts, "_build_subtree", _repaired_build_subtree())
    C, D, max_depth = 8, 3, 4
    keys = jax.random.split(jax.random.key(6), C)
    q = _start(4, C, D, 2.0)
    T = 1.3
    energy = JaxQuadratic(0.2, 0.7)
    grad_e = jax.grad(lambda x: energy(x) / T)

    def hamiltonian(qq, p):
        return energy(qq) / T + 0.5 * jnp.sum(p**2)

    cand, alpha, depth = jax.vmap(lambda k, x: jax_nuts._nuts_transition(
        k, x, jnp.float32(eps), grad_e, hamiltonian, max_depth))(keys, q)
    p0, u = _nuts_draws(keys, D, max_depth)
    assert u.shape == (C, n_uniforms(max_depth))
    port_energy = Quadratic(0.2, 0.7)
    pot = Potential(lambda x: port_energy(x) / T, torch.tensor(q))
    pc, pa, pd = nuts_transition(pot, torch.tensor(q), torch.tensor(eps), torch.tensor(_np(p0)),
                                 torch.tensor(_np(u)), max_depth)
    np.testing.assert_array_equal(pd.numpy(), _np(depth).astype(np.float32))
    np.testing.assert_allclose(pc.numpy(), _np(cand), atol=ATOL)
    np.testing.assert_allclose(pa.numpy(), _np(alpha), atol=1e-5)


def test_nuts_backward_subtree_checks_uturns_in_time_order():
    """A free particle (flat energy) never turns. Built backward, the
    port's subtree finds no U-turn; the reference's flags one at its first
    two-leaf sub-subtree, because it multiplies the momenta by the direction
    (tsu_tpu/samplers/nuts.py:83-87)."""
    q0, p0 = np.zeros(2, np.float32), np.array([1.0, 0.5], np.float32)

    def flat(x):
        return 0.0 * jnp.sum(x)

    ref = jax_nuts._build_subtree(jax.random.key(0), jnp.asarray(q0), jnp.asarray(p0), -1.0, 2,
                                  0.1, jax.grad(flat), lambda q, p: 0.5 * jnp.sum(p**2),
                                  jnp.float32(0.5 * np.sum(p0**2)))
    assert bool(ref["turned"])
    pot = Potential(lambda x: 0.0 * torch.sum(x), torch.zeros(1, 2))
    tree = _port_backward_subtree(pot, q0, p0)
    assert not bool(tree["turned"][0])
    np.testing.assert_allclose(tree["q"][0].numpy(), np.asarray(ref["q_end"]), atol=1e-6)


def _port_backward_subtree(pot, q0, p0):
    """The port's depth-2 subtree from (q0, p0), built backward."""
    from tsu_tpu_torch.samplers.nuts import _build_subtree

    q = torch.tensor(q0)[None]
    p = torch.tensor(p0)[None]
    return _build_subtree(pot, q, p, torch.zeros_like(q), torch.tensor([[-1.0]]), 2,
                          torch.tensor(0.1), 0.5 * torch.sum(p**2, dim=-1), torch.full((1, 4), 0.5))


def test_systematic_resample_indices_equal_jax():
    key = jax.random.key(7)
    for i in range(20):
        k = jax.random.fold_in(key, i)
        log_w = _np(jax.random.normal(jax.random.fold_in(k, 1), (64,)) * 3.0)
        ref = _np(jax_smc.systematic_resample_indices(k, jnp.asarray(log_w)))
        u = float(jax.random.uniform(k))
        got = systematic_resample_indices(torch.tensor(u), torch.tensor(log_w))
        np.testing.assert_array_equal(got.numpy(), ref)


def test_annealed_smc_equals_jax():
    P, D, n_steps, n_moves = 64, 2, 12, 3
    key = jax.random.key(8)
    x0 = _start(5, P, D, 3.0)
    kw = dict(n_steps=n_steps, n_moves=n_moves, dt=0.05, temperature=1.0, base_sigma=3.0,
              ess_threshold=0.6)
    energy = JaxMixture(((-2.0, 0.0), (2.0, 1.0)), (0.6, 0.6))
    ref = jax_smc.annealed_smc(key, jnp.asarray(x0), energy_fn=energy, **kw)

    def step(k):
        k_res, k_move = jax.random.split(k)

        def particle(kp):
            out = []
            for _ in range(n_moves):
                kp, sub = jax.random.split(kp)
                out.append(jax.random.normal(sub, (D,)))
            return jnp.stack(out)

        noise = jax.vmap(particle)(jax.random.split(k_move, P))     # (P, n_moves, D)
        return jax.random.uniform(k_res)[None], jnp.swapaxes(noise, 0, 1)

    u, noise = jax.vmap(step)(jax.random.split(key, n_steps))
    out = run_smc(_given(u=u, noise=noise), [torch.tensor(x0)],
                  energy_fn=MixtureOfGaussians(((-2.0, 0.0), (2.0, 1.0)), (0.6, 0.6)), **kw)
    assert np.any(_np(ref["ess_history"]) < 0.6 * P)      # resampling fired
    np.testing.assert_allclose(out["particles"][0].numpy(), _np(ref["particles"]), atol=ATOL)
    np.testing.assert_allclose(out["log_weights"][0].numpy(), _np(ref["log_weights"]),
                               atol=ATOL)
    np.testing.assert_allclose(out["ess_history"].numpy(), _np(ref["ess_history"]), rtol=1e-4)
    assert float(out["log_Z"]) == pytest.approx(float(ref["log_Z"]), abs=1e-4)


def test_neg_elbo_value_and_gradient_equal_jax():
    D, n_mc, T = 4, 16, 1.7
    key = jax.random.key(9)
    rng = np.random.default_rng(6)
    mu, rho = rng.normal(size=D).astype(np.float32), rng.normal(size=D).astype(np.float32)
    energy = JaxMixture(((0.0, 1.0, -1.0, 0.5), (1.0, 0.0, 0.0, -0.5)), (0.8, 1.2))
    val, (g_mu, g_rho) = jax.value_and_grad(
        lambda m, r: jax_vi._neg_elbo(jax_vi.MeanFieldParams(m, r), key, energy, T, n_mc),
        argnums=(0, 1))(jnp.asarray(mu), jnp.asarray(rho))
    eps = torch.tensor(_np(jax.random.normal(key, (n_mc, D))))
    port = MixtureOfGaussians(((0.0, 1.0, -1.0, 0.5), (1.0, 0.0, 0.0, -0.5)), (0.8, 1.2))
    (pg_mu, pg_rho), pval = torch.func.grad_and_value(
        lambda m, r: neg_elbo(m, r, eps, port, T), argnums=(0, 1))(torch.tensor(mu),
                                                                     torch.tensor(rho))
    assert float(pval) == pytest.approx(float(val), abs=1e-5)
    np.testing.assert_allclose(pg_mu.numpy(), _np(g_mu), atol=1e-5)
    np.testing.assert_allclose(pg_rho.numpy(), _np(g_rho), atol=1e-5)


@pytest.mark.parametrize("activation", ["relu", "tanh", "sigmoid"])
def test_bnn_posterior_energy_and_gradient_equal_jax(activation):
    rng = np.random.default_rng(7)
    x = rng.uniform(-2, 2, (20, 1)).astype(np.float32)
    y = np.sin(x) + 0.1 * rng.normal(size=x.shape).astype(np.float32)
    sizes = (1, 8, 8, 1)
    ref = JaxBNNPosterior(jnp.asarray(x), jnp.asarray(y), sizes, activation, 1.5, 0.2)
    theta = (0.5 * rng.normal(size=ref.dim)).astype(np.float32)
    e, g = jax.value_and_grad(ref)(jnp.asarray(theta))
    port = bnn_posterior_from_numpy(x, y, sizes, activation, 1.5, 0.2)
    assert port.dim == ref.dim == 97
    pg, pe = torch.func.grad_and_value(port)(states_from_numpy(theta))
    assert float(pe) == pytest.approx(float(e), rel=1e-5)
    np.testing.assert_allclose(pg.numpy(), _np(g), rtol=1e-4, atol=1e-3)
