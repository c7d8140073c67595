"""Shared helpers of the BNN port tests: the reference's draws rebuilt
from its key schedule, and JAX networks carried into the port."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tsu_tpu.models import ml as jml
from tsu_tpu_torch.interop import bnn_from_numpy
from tsu_tpu_torch.models import ml

CPU = "cpu"
RTOL = 1e-5      # a forward pass or a loss
ATOL = 1e-4      # parameters after tens of Adam steps


def _np(a):
    return np.asarray(a)


@functools.lru_cache(maxsize=None)
def _draw_fn(sizes):
    """The normals of one reference forward pass under a key, flat: the
    layer index folded into the key, split into a weight and a bias key;
    vmapped over keys and compiled once per sizes."""
    def one(key):
        parts = []
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            k_w, k_b = jax.random.split(jax.random.fold_in(key, i))
            parts += [jax.random.normal(k_w, (a, b)).ravel(), jax.random.normal(k_b, (b,))]
        return jnp.concatenate(parts)
    return jax.jit(jax.vmap(one))


def draws_of(keys, sizes):
    """(len(keys), P) draws, one per key."""
    return _np(_draw_fn(tuple(sizes))(keys))


def draw_of(key, sizes):
    return draws_of(key[None], sizes)[0]


def _data(seed, n, d_in=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d_in)).astype(np.float32)
    y = (np.sin(3 * x.sum(axis=1, keepdims=True)) + 0.1 * rng.normal(size=(n, 1))).astype(np.float32)
    return x, y


def _jax_net(sizes, learn_noise=True, seed=0):
    net = jml.BayesianNetwork(list(sizes), seed=seed, learn_observation_noise=learn_noise)
    if learn_noise:
        net.log_noise = net.log_noise + 0.1      # away from the start value
    return net


def _carry(net):
    params = [{k: _np(v) for k, v in layer.items()} for layer in net.params]
    log_noise = None if net.log_noise is None else _np(net.log_noise)
    return bnn_from_numpy(net.layer_sizes, params, log_noise, device=CPU)


def _port_trainable(pnet):
    return pnet._trainable()


def _jax_flat(trainable):
    """A JAX trainable's arrays in the port's order (``ml._flat``)."""
    if isinstance(trainable, dict):
        return [l[k] for l in trainable["layers"] for k in ml.KEYS] + [trainable["log_noise"]]
    return [l[k] for l in trainable for k in ml.KEYS]
