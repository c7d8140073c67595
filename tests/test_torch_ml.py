"""The port's BNN core (``tsu_tpu_torch/models/ml.py``) against the JAX
package's on carried weights and the reference's own draws: forward passes,
the KL, the ELBO in both forms, one minibatch step, and a fit whose
minibatches are split over a mesh against the one-device fit.

The draws are rebuilt from the reference's key schedule with
``jax.random``: a forward pass folds the layer index into its key and splits
it into a weight key and a bias key; ``elbo_loss`` splits its key into n_mc;
``_train_scan`` splits one key per step (``torch_ml_reference.py``). They
are handed to the port in its flat layout (per layer the weights row-major,
then the biases). Values agree within 1e-5 (single passes and losses,
relative). Everything runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_ml_reference import (
    CPU,
    RTOL,
    _carry,
    _data,
    _jax_flat,
    _jax_net,
    _np,
    _port_trainable,
    draw_of,
    draws_of,
)
from tsu_tpu.models import ml as jml
from tsu_tpu_torch import BayesianRegressor, ConfigurationError
from tsu_tpu_torch.interop import bnn_from_numpy
from tsu_tpu_torch.models import ml
from tsu_tpu_torch.parallel import make_mesh

SIZES = (1, 8, 8, 1)    # one network shape, so the reference compiles its ops once

@pytest.mark.parametrize("T", [1.0, 0.3])
@pytest.mark.parametrize("activation", ["relu", "tanh", "sigmoid"])
def test_forward_sample_and_predict_mc_equal_jax(activation, T):
    net = _jax_net(SIZES)
    pnet = _carry(net)
    x, _ = _data(0, 30)
    key = jax.random.key(3)
    ref = _np(jml.forward_sample(net.params, jnp.asarray(x), key, T, activation))
    out = ml.forward_sample(pnet.params, torch.tensor(x), torch.tensor(draw_of(key, SIZES)), T,
                            activation)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=RTOL, atol=1e-6)
    ref = _np(jml.predict_mc(net.params, jnp.asarray(x), key, T, n_samples=6,
                             activation=activation))
    eps = draws_of(jax.random.split(key, 6), SIZES)
    out = ml.predict_mc(pnet.params, torch.tensor(x), torch.tensor(eps), T, activation)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=RTOL, atol=1e-6)


def test_kl_to_prior_equals_jax():
    net = _jax_net(SIZES)
    pnet = _carry(net)
    for prior in (1.0, 0.4):
        ref = float(jml.kl_to_prior(net.params, prior))
        with torch.no_grad():
            assert float(ml.kl_to_prior(pnet.params, prior)) == pytest.approx(ref, rel=RTOL)


@pytest.mark.parametrize("n_total", [None, 500.0])
@pytest.mark.parametrize("learn_noise", [False, True])
def test_elbo_loss_equals_jax(learn_noise, n_total):
    net = _jax_net(SIZES, learn_noise)
    pnet = _carry(net)
    x, y = _data(1, 30)
    key = jax.random.key(9)
    kw = dict(kl_weight=0.1, temperature=0.7, activation="relu", prior_std=1.3, n_total=n_total)
    ref, (ref_d, ref_kl) = jml.elbo_loss(net._trainable(), key, jnp.asarray(x), jnp.asarray(y),
                                         n_mc=4, **kw)
    eps = torch.tensor(draws_of(jax.random.split(key, 4), SIZES))
    out, (d, kl) = ml.elbo_loss(_port_trainable(pnet), eps, torch.tensor(x), torch.tensor(y),
                                **kw)
    for a, b in ((out, ref), (d, ref_d), (kl, ref_kl)):
        assert float(a.detach()) == pytest.approx(float(b), rel=RTOL)


def test_train_step_with_n_total_equals_jax():
    net = _jax_net(SIZES)
    pnet = _carry(net)
    x, y = _data(3, 30)
    key = jax.random.key(5)
    opt = optax.adam(0.02)
    trainable = net._trainable()
    params, _, loss, _, kl = jml._train_step(
        trainable, opt.init(trainable), key, jnp.asarray(x), jnp.asarray(y), 0.05, 1.0, 1.0,
        n_mc=2, activation="tanh", optimizer_update=opt.update, n_total=200.0)
    ts = [t.detach().clone() for t in ml._flat(_port_trainable(pnet))]
    popt, _ = ml._adam(ts, torch.tensor(0.02), torch.device(CPU))
    ploss, pkl = ml.train_step(
        ts, popt, torch.tensor(draws_of(jax.random.split(key, 2), SIZES)), torch.tensor(x),
        torch.tensor(y), n_layers=3, learn_noise=True, activation="tanh", kl_weight=0.05,
        temperature=1.0, prior_std=1.0, n_total=200.0)
    assert float(ploss) == pytest.approx(float(loss), rel=RTOL)
    assert float(pkl) == pytest.approx(float(kl), rel=RTOL)
    for a, b in zip(ts, _jax_flat(params)):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-6)


def test_mesh_fit_equals_one_device_fit():
    """Minibatches split over 4 shards (make_mesh(chains=4) on the CPU) give
    the one-device fit within float-sum order."""
    x, y = _data(4, 64)
    kw = dict(n_epochs=5, batch_size=16, learning_rate=0.02, kl_weight=0.01)
    one = BayesianRegressor(1, [8], seed=3, device=CPU)
    h1 = one.fit(x, y, **kw)
    four = BayesianRegressor(1, [8], seed=3, device=CPU)
    h4 = four.fit(x, y, mesh=make_mesh(chains=4, devices=[CPU] * 4), **kw)
    assert one.last_route == four.last_route == "eager"
    np.testing.assert_allclose(h4["loss_history"], h1["loss_history"], rtol=RTOL)
    for a, b in zip(ml._flat(four._trainable()), ml._flat(one._trainable())):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-5)


def test_interop_carries_the_weights():
    net = _jax_net((2, 4, 1), learn_noise=False)
    pnet = _carry(net)
    assert pnet.log_noise is None and pnet.observation_noise_std is None
    for layer, p in zip(pnet.layers, net.params):
        np.testing.assert_array_equal(layer.weight_mu, _np(p["w_mu"]))
        np.testing.assert_allclose(layer.weight_sigma, _np(jax.nn.softplus(p["w_rho"])),
                                   rtol=1e-6)
    with pytest.raises(ConfigurationError):
        bnn_from_numpy([2, 5, 1], [{k: _np(v) for k, v in p.items()} for p in net.params],
                       device=CPU)
