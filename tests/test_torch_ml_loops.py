"""The port's BNN loops against the JAX package on carried weights and the
reference's own draws: 20 full-batch ELBO steps (``_train_scan``) of [1, 8,
1] and [1, 16, 16, 1], 50 steps of an anchored ensemble
(``_anchored_train``) and the body of ``predict_mcmc`` (MALA over the
weight posterior, then every draw's forward pass). Losses within 1e-5
relative (the ensemble's within 1e-4), parameters and predictions within
1e-4, on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_ml_reference import (
    ATOL,
    CPU,
    RTOL,
    _carry,
    _data,
    _jax_flat,
    _jax_net,
    _np,
    _port_trainable,
    draws_of,
)
from tsu_tpu.models import ml as jml
from tsu_tpu.samplers.mala import sample_mala as jax_sample_mala
from tsu_tpu_torch.interop import ensemble_from_numpy
from tsu_tpu_torch.models import ml
from tsu_tpu_torch.samplers.loop import Draws


def _scan_draws(key, n_steps, n_mc, sizes):
    """``_train_scan``'s draws: a key per step, split into n_mc."""
    keys = jax.vmap(lambda k: jax.random.split(k, n_mc))(jax.random.split(key, n_steps))
    return draws_of(keys.reshape(-1), sizes).reshape(n_steps, n_mc, -1)


@pytest.mark.parametrize("sizes", [(1, 8, 1), (1, 16, 16, 1)])
def test_train_scan_equals_jax(sizes):
    net = _jax_net(sizes)
    pnet = _carry(net)
    x, y = _data(2, 40)
    key = jax.random.key(4)
    opt = optax.adam(0.01)
    trainable = net._trainable()
    params, _, losses, kls = jml._train_scan(
        trainable, opt.init(trainable), key, jnp.asarray(x), jnp.asarray(y), 0.1, 1.0, 1.0,
        n_steps=20, n_mc=3, activation="relu", optimizer_update=opt.update)
    eps = _scan_draws(key, 20, 3, sizes)
    out, plosses, pkls, route = ml.run_fit(
        Draws(given={"eps": torch.tensor(eps)}), _port_trainable(pnet), torch.tensor(x),
        torch.tensor(y), n_steps=20, learning_rate=0.01, kl_weight=0.1, temperature=1.0,
        prior_std=1.0, n_mc=3, activation="relu")
    assert route == "eager"
    np.testing.assert_allclose(plosses.numpy(), _np(losses), rtol=RTOL)
    np.testing.assert_allclose(pkls.numpy(), _np(kls), rtol=RTOL)
    for a, b in zip(ml._flat(out), _jax_flat(params)):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=ATOL)


def test_anchored_train_equals_jax():
    ref = jml.AnchoredEnsembleRegressor(1, [8, 8], n_members=4, seed=0)
    reg = ensemble_from_numpy(jax.tree.map(_np, ref.anchors), jax.tree.map(_np, ref.trainable),
                              device=CPU)
    x, y = _data(5, 30)
    opt = optax.adam(0.01)
    trainable, _, losses = jml._anchored_train(
        ref.trainable, ref.anchors, opt.init(ref.trainable), jnp.asarray(x), jnp.asarray(y), 1.0,
        n_steps=50, activation="relu", optimizer_update=opt.update)
    out, plosses, route = ml.run_anchored(reg.trainable, reg.anchors, torch.tensor(x),
                                          torch.tensor(y), n_steps=50, learning_rate=0.01,
                                          prior_std=1.0, activation="relu")
    assert route == "eager"
    np.testing.assert_allclose(plosses.numpy(), _np(losses), rtol=ATOL)
    for l, r in zip(out["layers"], trainable["layers"]):
        for k in ("w", "b"):
            np.testing.assert_allclose(l[k].numpy(), _np(r[k]), atol=ATOL)
    np.testing.assert_allclose(out["log_noise"].numpy(), _np(trainable["log_noise"]), atol=ATOL)
    # Predictions over members on carried weights.
    ref.trainable = trainable
    reg.trainable = out
    xt = np.linspace(-2, 2, 9)[:, None].astype(np.float32)
    np.testing.assert_allclose(reg.predict(xt).samples, ref.predict(xt).samples, atol=ATOL)


def _split_steps(key, n, C, per_chain):
    return jax.vmap(lambda k: jax.vmap(per_chain)(jax.random.split(k, C)))(
        jax.random.split(key, n))


def test_predict_mcmc_on_the_reference_draws_equals_jax():
    """The body of ``predict_mcmc``: MALA from the posterior means + 0.05 N
    over the BNN posterior, then every draw's forward pass on x_test."""
    sizes = (1, 6, 1)
    net = _jax_net(sizes)
    pnet = _carry(net)
    x, y = _data(6, 25)
    x_test = np.linspace(-1, 1, 5)[:, None].astype(np.float32)
    C, nb, ns = 4, 40, 6
    post, theta0 = net.posterior_energy(x, y)
    ppost, ptheta0 = pnet.posterior_energy(x, y)
    assert ppost.noise_std == pytest.approx(post.noise_std, rel=1e-6)
    np.testing.assert_array_equal(ptheta0.numpy(), _np(theta0))
    key = jax.random.key(8)
    x0 = _np(theta0[None, :] + 0.05 * jax.random.normal(jax.random.fold_in(key, 0),
                                                        (C, theta0.shape[0])))
    thetas, _ = jax_sample_mala(jax.random.fold_in(key, 1), x0, energy_fn=post, n_samples=ns,
                                step_size=1e-3, n_burnin=nb)
    ref = _np(jax.vmap(lambda t: post.forward(t, jnp.asarray(x_test)))(
        thetas.reshape(-1, theta0.shape[0])))

    D = theta0.shape[0]

    def chain(k):
        k_n, k_a = jax.random.split(k)
        return jax.random.normal(k_n, (D,)), jax.random.uniform(k_a)

    k_burn, k_main = jax.random.split(jax.random.fold_in(key, 1))
    noise, u = (np.concatenate([_np(a), _np(b)]) for a, b in zip(
        _split_steps(k_burn, nb, C, chain), _split_steps(k_main, ns, C, chain)))
    preds, info = ml.mcmc_predictive(
        Draws(given={"noise": torch.tensor(noise), "u": torch.tensor(u)}), ppost,
        torch.tensor(x0), torch.tensor(x_test), ns, nb)
    assert info["route"] == "eager"
    np.testing.assert_allclose(preds.numpy(), ref, atol=ATOL)
