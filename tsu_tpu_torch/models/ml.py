"""Bayesian neural networks trained by stochastic variational inference, and
anchored ensembles.

Counterpart of ``tsu_tpu/models/ml.py``. A layer's Gaussian posterior is
four tensors, ``w_mu``, ``w_rho``, ``b_mu`` and ``b_rho`` (sigma =
softplus(rho)); :class:`StochasticLayer` holds them as ``nn.Parameter``s and
:class:`BayesianNetwork` its layers in an ``nn.ModuleList``. The functional
core works on a list of such dicts (``params``) and takes its normals as a
tensor, so a test can hand in the reference's own draws: a weight draw is
one flat vector of P = sum (d_in + 1) d_out normals, per layer the weights
row-major, then the biases (``BNNPosterior``'s layout); a batch of draws
(S, P) gives S forward passes at once, one batched product per layer.

**Loops on the card.** The full-batch fit (the reference's one
``lax.scan``), the ensemble's training and ``predict`` each run as a
:class:`~tsu_tpu_torch.samplers.loop.StepLoop`: a chunk of steps captured
once per length as a CUDA graph and replayed, on tensors the loop owns
(cached by shapes, activation, MC draws and device). Adam is
``torch.optim.Adam`` at optax's defaults with ``capturable=True`` on the
card and its rate a device tensor; gradients come from
``torch.func.grad_and_value`` and are copied into the static ``.grad``
tensors. Each step records its loss (and KL) in the loop's buffers, read
with one host sync per fit. The minibatch fit runs its steps eagerly, sums
each epoch's loss on the device and syncs once per epoch; with ``mesh=``
each full-size minibatch is split over the mesh's ``chains`` devices and
the shards' gradients are averaged on the first device.

Numpy in, numpy out at the class surface, as the reference; every class
takes ``device`` (default the card; ``device="cpu"`` runs the plain path).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import grad_and_value, vmap

from tsu_tpu_torch.config import ConfigurationError, resolve_device
from tsu_tpu_torch.energy import ACTIVATIONS, BNNPosterior
from tsu_tpu_torch.rng import as_generator, device_generator
from tsu_tpu_torch.samplers.loop import Draws, StepLoop, cached_loop, canonical, chunks, scalar
from tsu_tpu_torch.samplers.mala import run_mala
from tsu_tpu_torch.samplers.vi import softplus

CHUNK = 64          # optimizer steps per CUDA graph
KEYS = ("w_mu", "w_rho", "b_mu", "b_rho")
LOG_NOISE0 = float(np.log(0.3))


@dataclass
class PosteriorSample:
    """One draw from the weight posterior."""

    weights: List[np.ndarray]
    bias: List[np.ndarray]
    energy: float
    temperature: float


@dataclass
class PredictionResult:
    """Prediction with uncertainty."""

    mean: np.ndarray
    std: np.ndarray
    samples: np.ndarray
    confidence: np.ndarray = field(init=False)

    def __post_init__(self):
        conf = 1.0 / (self.std + 1e-8)
        self.confidence = conf / (np.max(conf) + 1e-8)


def _prediction(samples: np.ndarray) -> PredictionResult:
    return PredictionResult(mean=samples.mean(axis=0), std=samples.std(axis=0), samples=samples)


# -- functional core ---------------------------------------------------------


def n_weights(sizes: Sequence[int]) -> int:
    """P, the normals of one weight draw (and BNNPosterior's dim)."""
    return sum((a + 1) * b for a, b in zip(sizes[:-1], sizes[1:]))


def sizes_of(layers) -> tuple:
    """(d_in, hidden..., d_out) of a list of layer dicts (any leading batch
    dimension of the weights ignored)."""
    ws = [layer["w_mu"] if "w_mu" in layer else layer["w"] for layer in layers]
    return tuple([ws[0].shape[-2]] + [w.shape[-1] for w in ws])


def split_draw(eps: torch.Tensor, sizes: Sequence[int]):
    """(eps_w (..., a, b), eps_b (..., b)) per layer of draws (..., P)."""
    out, off = [], 0
    for a, b in zip(sizes[:-1], sizes[1:]):
        out.append((eps[..., off:off + a * b].reshape(*eps.shape[:-1], a, b),
                    eps[..., off + a * b:off + a * b + b]))
        off += (a + 1) * b
    return out


def init_layer(gen: torch.Generator, n_in: int, n_out: int, init_sigma: float = 0.1) -> dict:
    """One layer's posterior on the CPU: w_mu ~ N(0, 1/n_in) drawn from
    ``gen``, b_mu = 0, and rho at softplus^-1(init_sigma)."""
    rho0 = float(np.log(np.expm1(init_sigma)))
    scale = 1.0 / np.sqrt(max(n_in, 1))
    return {"w_mu": scale * torch.randn((n_in, n_out), generator=gen),
            "w_rho": torch.full((n_in, n_out), rho0),
            "b_mu": torch.zeros(n_out),
            "b_rho": torch.full((n_out,), rho0)}


def _zeros_layers(sizes: Sequence[int], device) -> list:
    """Layer dicts of zeros of the shapes ``sizes`` gives."""
    return [{"w_mu": torch.zeros((a, b), device=device), "w_rho": torch.zeros((a, b), device=device),
             "b_mu": torch.zeros(b, device=device), "b_rho": torch.zeros(b, device=device)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def forward_sample(params, x: torch.Tensor, eps: torch.Tensor, temperature,
                   activation: str) -> torch.Tensor:
    """Forward passes with weights w = mu + sqrt(T) sigma eps.

    x (N, d_in); eps (P,) gives (N, d_out), eps (S, P) gives S passes
    (S, N, d_out), each with its own weights."""
    act = ACTIVATIONS[activation]
    sqrt_t = temperature ** 0.5
    h = x
    n_layers = len(params)
    for i, (layer, (e_w, e_b)) in enumerate(zip(params, split_draw(eps, sizes_of(params)))):
        w = layer["w_mu"] + sqrt_t * softplus(layer["w_rho"]) * e_w
        b = layer["b_mu"] + sqrt_t * softplus(layer["b_rho"]) * e_b
        h = h @ w + b[..., None, :]
        if i < n_layers - 1:
            h = act(h)
    return h


def kl_to_prior(params, prior_std) -> torch.Tensor:
    """Closed-form KL(q || N(0, prior_std^2)) summed over all parameters."""
    total = 0.0
    p_var = prior_std ** 2
    for layer in params:
        for mu_k, rho_k in (("w_mu", "w_rho"), ("b_mu", "b_rho")):
            mu = layer[mu_k]
            sig2 = softplus(layer[rho_k]) ** 2
            total = total + 0.5 * torch.sum(sig2 / p_var + mu ** 2 / p_var - 1.0
                                            - torch.log(sig2 / p_var))
    return total


def elbo_loss(params, eps: torch.Tensor, x: torch.Tensor, y: torch.Tensor, *, kl_weight,
              temperature, activation: str, prior_std, n_total=None):
    """MC estimate of the negative ELBO on the draws ``eps`` (n_mc, P).

    ``params`` is a list of layer dicts (data term: the MSE) or
    ``{"layers": [...], "log_noise": (d_out,)}`` (data term: the per-datum
    Gaussian NLL with the learned noise scale). Returns (loss, (data term,
    KL)); the KL enters as kl_weight * KL / n_total (default the batch)."""
    if isinstance(params, dict):
        layers, log_noise = params["layers"], params["log_noise"]
    else:
        layers, log_noise = params, None
    pred = forward_sample(layers, x, eps, temperature, activation)
    if log_noise is None:
        per = torch.mean((pred - y) ** 2, dim=(-2, -1))
    else:
        var = torch.exp(2.0 * log_noise)
        per = torch.mean(0.5 * ((pred - y) ** 2 / var + torch.log(2.0 * math.pi * var)),
                         dim=(-2, -1))
    data_term = torch.mean(per)
    kl = kl_to_prior(layers, prior_std)
    n_total = x.shape[0] if n_total is None else n_total
    return data_term + kl_weight * kl / n_total, (data_term, kl)


def predict_mc(params, x: torch.Tensor, eps: torch.Tensor, temperature,
               activation: str) -> torch.Tensor:
    """MC predictive on the draws ``eps`` (n_samples, P): (n_samples, N,
    d_out), one batched pass."""
    return forward_sample(params, x, eps, temperature, activation)


def _flat(trainable) -> list:
    """The tensors of a trainable (a list of layer dicts, or the dict form
    with log_noise), in a fixed order."""
    if isinstance(trainable, dict):
        return [l[k] for l in trainable["layers"] for k in KEYS] + [trainable["log_noise"]]
    return [l[k] for l in trainable for k in KEYS]


def _unflat(ts, n_layers: int, learn_noise: bool):
    layers = [dict(zip(KEYS, ts[4 * i:4 * i + 4])) for i in range(n_layers)]
    return {"layers": layers, "log_noise": ts[-1]} if learn_noise else layers


def _adam(ts: list, lr: torch.Tensor, device: torch.device):
    """Adam at optax's defaults over ``ts`` (their ``.grad`` static zeros),
    its state created and zeroed; returns (optimizer, its state tensors).
    Capturable on the card; one update a tensor (``foreach=False``), as
    ``samplers/vi.py``."""
    for t in ts:
        t.grad = torch.zeros_like(t)
    opt = torch.optim.Adam(ts, lr=lr, betas=(0.9, 0.999), eps=1e-8, foreach=False,
                           capturable=device.type == "cuda")
    opt.step()          # zero gradients: creates the moments, moves nothing
    state = []
    for t in ts:
        for s in opt.state[t].values():
            s.zero_()
            state.append(s)
    return opt, state


def elbo_grads(ts: list, eps, x, y, *, n_layers: int, learn_noise: bool, activation: str,
               kl_weight, temperature, prior_std, n_total=None):
    """(gradients of the negative ELBO w.r.t. ``ts``, loss, KL)."""
    def loss(ts_, e):
        total, (_, kl) = elbo_loss(_unflat(ts_, n_layers, learn_noise), e, x, y,
                                   kl_weight=kl_weight, temperature=temperature,
                                   activation=activation, prior_std=prior_std, n_total=n_total)
        return total, kl

    grads, (total, kl) = grad_and_value(loss, has_aux=True)(tuple(ts), eps)
    return grads, total, kl


def fit_loop(sizes: Sequence[int], activation: str, n_mc: int, n_points: int,
             learn_noise: bool, device, *, graph: bool = True) -> StepLoop:
    """The (cached) full-batch ELBO loop: state the trainable tensors (their
    ``.grad`` set in place), Adam's moments and steps, x, y, lr, T,
    kl_weight and prior_std. Takes "eps" (n_mc, P) normals a step; records
    each step's loss and KL."""
    device = canonical(device)
    sizes = tuple(sizes)

    def build():
        layers = _zeros_layers(sizes, device)
        trainable = ({"layers": layers, "log_noise": torch.zeros(sizes[-1], device=device)}
                     if learn_noise else layers)
        ts = _flat(trainable)
        st = {"x": torch.zeros((n_points, sizes[0]), device=device),
              "y": torch.zeros((n_points, sizes[-1]), device=device),
              "lr": scalar(0.0, device), "T": scalar(1.0, device),
              "kl_weight": scalar(0.0, device), "prior_std": scalar(1.0, device)}
        opt, adam = _adam(ts, st["lr"], device)
        st.update({f"p{i}": t for i, t in enumerate(ts)})
        st.update({f"g{i}": t.grad for i, t in enumerate(ts)})
        st.update({f"adam{i}": t for i, t in enumerate(adam)})

        def step(bufs, k):
            grads, loss, kl = elbo_grads(
                ts, bufs["eps"][k], st["x"], st["y"], n_layers=len(layers),
                learn_noise=learn_noise, activation=activation, kl_weight=st["kl_weight"],
                temperature=st["T"], prior_std=st["prior_std"])
            for t, g in zip(ts, grads):
                t.grad.copy_(g)
            opt.step()
            bufs["loss"][k].copy_(loss)
            bufs["kl"][k].copy_(kl)

        loop = StepLoop("bnn fit", device, step, st,
                        {"eps": ("normal", (n_mc, n_weights(sizes)), torch.float32)},
                        {"loss": ((), torch.float32), "kl": ((), torch.float32)}, graph=graph)
        loop.params = ts
        return loop

    return cached_loop(("bnn fit", sizes, activation, n_mc, n_points, learn_noise, device, graph),
                       build)


def run_fit(draws: Draws, trainable, x: torch.Tensor, y: torch.Tensor, *, n_steps: int,
            learning_rate: float, kl_weight: float, temperature: float, prior_std: float,
            n_mc: int, activation: str, graph: bool = True):
    """``n_steps`` full-batch ELBO steps from ``trainable`` (a list of layer
    dicts or the dict form) on ``draws`` ("eps", (n_mc, P) a step), on x's
    device, Adam starting afresh. Returns (the trained tensors in
    ``trainable``'s form, losses (n_steps,), KLs (n_steps,), route)."""
    learn_noise = isinstance(trainable, dict)
    layers = trainable["layers"] if learn_noise else trainable
    sizes = sizes_of(layers)
    loop = fit_loop(sizes, activation, n_mc, x.shape[0], learn_noise, x.device, graph=graph)
    st = loop.state
    with torch.no_grad():
        for t, src in zip(loop.params, _flat(trainable)):
            t.copy_(src)
        for name, t in st.items():
            if name.startswith("adam"):
                t.zero_()
        st["x"].copy_(x)
        st["y"].copy_(y)
        for name, v in (("lr", learning_rate), ("T", temperature), ("kl_weight", kl_weight),
                        ("prior_std", prior_std)):
            st[name].fill_(v)
    losses = torch.empty(n_steps, dtype=torch.float32, device=x.device)
    kls = torch.empty(n_steps, dtype=torch.float32, device=x.device)
    i = 0
    for L in chunks(n_steps, CHUNK):
        bufs = loop.run(draws, L)
        losses[i:i + L].copy_(bufs["loss"])
        kls[i:i + L].copy_(bufs["kl"])
        i += L
    out = _unflat([t.clone() for t in loop.params], len(layers), learn_noise)
    return out, losses, kls, loop.route


def predict_loop(sizes: Sequence[int], activation: str, n_samples: int, n_points: int,
                 device, *, graph: bool = True) -> StepLoop:
    """The (cached) MC predictive as a one-step loop: state the layers' four
    tensors, x and T; takes "eps" (n_samples, P); records "pred"
    (n_samples, N, d_out)."""
    device = canonical(device)
    sizes = tuple(sizes)

    def build():
        layers = _zeros_layers(sizes, device)
        st = {"x": torch.zeros((n_points, sizes[0]), device=device), "T": scalar(1.0, device)}
        st.update({f"{k}{i}": layer[k] for i, layer in enumerate(layers) for k in KEYS})

        def step(bufs, k):
            bufs["pred"][k].copy_(predict_mc(layers, st["x"], bufs["eps"][k], st["T"],
                                             activation))

        loop = StepLoop("bnn predict", device, step, st,
                        {"eps": ("normal", (n_samples, n_weights(sizes)), torch.float32)},
                        {"pred": ((n_samples, n_points, sizes[-1]), torch.float32)}, graph=graph)
        loop.layers = layers
        return loop

    return cached_loop(("bnn predict", sizes, activation, n_samples, n_points, device, graph),
                       build)


def run_predict(draws: Draws, params, x: torch.Tensor, temperature: float, activation: str,
                n_samples: int, graph: bool = True):
    """:func:`predict_mc` through :func:`predict_loop` on x's device:
    ((n_samples, N, d_out) tensor, route)."""
    loop = predict_loop(sizes_of(params), activation, n_samples, x.shape[0], x.device,
                        graph=graph)
    with torch.no_grad():
        for dst, src in zip(loop.layers, params):
            for k in KEYS:
                dst[k].copy_(src[k])
        loop.state["x"].copy_(x)
        loop.state["T"].fill_(temperature)
    return loop.run(draws, 1)["pred"][0].clone(), loop.route


def train_step(ts: list, opt, eps, x, y, *, n_layers: int, learn_noise: bool, activation: str,
               kl_weight: float, temperature: float, prior_std: float, n_total=None,
               devices: Optional[list] = None):
    """One eager ELBO step on a minibatch; returns (loss, KL) as device
    tensors. ``devices``: split the batch over these devices (a mesh's
    ``chains`` axis), each shard's gradient on its device, averaged on the
    first device. The KL enters over ``n_total``, default the whole batch
    (not a shard)."""
    n_total = x.shape[0] if n_total is None else n_total
    kw = dict(n_layers=n_layers, learn_noise=learn_noise, activation=activation,
              kl_weight=kl_weight, temperature=temperature, prior_std=prior_std, n_total=n_total)
    if not devices or len(devices) == 1:
        grads, loss, kl = elbo_grads(ts, eps, x, y, **kw)
    else:
        home = ts[0].device
        parts = []
        for d, xs, ys in zip(devices, x.chunk(len(devices)), y.chunk(len(devices))):
            parts.append(elbo_grads([t.to(d) for t in ts], eps.to(d), xs.to(d), ys.to(d), **kw))
        grads = [torch.stack([p[0][i].to(home) for p in parts]).mean(0) for i in range(len(ts))]
        loss = torch.stack([p[1].to(home) for p in parts]).mean()
        kl = parts[0][2].to(home)
    with torch.no_grad():
        for t, g in zip(ts, grads):
            t.grad.copy_(g)
        opt.step()
    return loss, kl


def mcmc_predictive(draws: Draws, post: BNNPosterior, x0: torch.Tensor, x_test: torch.Tensor,
                    n_per_chain: int, n_burnin: int, step_size: float = 1e-3):
    """MALA over ``post`` from x0 (chains, dim) on ``draws``, then one
    batched forward of every retained draw on x_test: ((chains *
    n_per_chain, N, d_out) tensor, MALA's info)."""
    thetas, info = run_mala(draws, x0, energy_fn=post, n_samples=n_per_chain,
                            step_size=step_size, n_burnin=n_burnin)
    thetas = thetas.reshape(-1, x0.shape[1])
    return vmap(lambda t: post.forward(t, x_test))(thetas), info


# -- class API ----------------------------------------------------------------


def _inputs(x, device) -> torch.Tensor:
    return torch.atleast_2d(torch.as_tensor(np.asarray(x, np.float32))).to(device)


def _targets(y, n: int, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(y, np.float32)).reshape(n, -1).to(device)


class StochasticLayer(nn.Module):
    """Gaussian-posterior linear layer: ``w_mu``, ``w_rho``, ``b_mu`` and
    ``b_rho`` as Parameters. ``seed``: an int or a CPU ``torch.Generator``
    (the initial means and the layer's draws come from it)."""

    def __init__(self, input_dim: int, output_dim: int, prior_std: float = 1.0,
                 seed=None, device=None):
        super().__init__()
        if input_dim <= 0 or output_dim <= 0:
            raise ConfigurationError("layer dimensions must be positive")
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.prior_std = prior_std
        self.device = resolve_device(device)
        gen = as_generator(seed)
        for k, v in init_layer(gen, input_dim, output_dim).items():
            setattr(self, k, nn.Parameter(v.to(self.device)))
        self._dgen = device_generator(gen, self.device)

    @property
    def params(self) -> dict:
        return {k: getattr(self, k) for k in KEYS}

    @property
    def weight_mu(self) -> np.ndarray:
        return self.w_mu.detach().cpu().numpy()

    @property
    def weight_sigma(self) -> np.ndarray:
        return softplus(self.w_rho.detach()).cpu().numpy()

    @torch.no_grad()
    def _sample(self, temperature):
        eps = torch.randn(n_weights((self.input_dim, self.output_dim)), generator=self._dgen,
                          device=self.device)
        (e_w, e_b), = split_draw(eps, (self.input_dim, self.output_dim))
        sqrt_t = temperature ** 0.5
        return (self.w_mu + sqrt_t * softplus(self.w_rho) * e_w,
                self.b_mu + sqrt_t * softplus(self.b_rho) * e_b)

    def sample_weights(self, temperature: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
        """Draw (w, b) by reparameterization."""
        w, b = self._sample(temperature)
        return w.cpu().numpy(), b.cpu().numpy()

    @torch.no_grad()
    def compute_kl_divergence(self) -> float:
        """KL(q || prior) for this layer."""
        return float(kl_to_prior([self.params], self.prior_std))

    @torch.no_grad()
    def forward(self, x, temperature: float = 1.0) -> np.ndarray:
        w, b = self._sample(temperature)
        return (_inputs(x, self.device) @ w + b).cpu().numpy()


class BayesianLinear(StochasticLayer):
    """Linear layer with a Gaussian weight posterior."""


class BayesianNetwork(nn.Module):
    """MLP with weight uncertainty, trained by SVI. ``seed``: an int or a CPU
    ``torch.Generator``; ``device``: where it trains and predicts (default
    the card). ``last_route`` is the route of the last fit or predict
    ("graph", or "eager": the CPU, a minibatch fit, a capture that
    failed)."""

    def __init__(self, layer_sizes: List[int], activation: str = "relu", prior_std: float = 1.0,
                 temperature: float = 1.0, seed=None, learn_observation_noise: bool = True,
                 device=None):
        super().__init__()
        if len(layer_sizes) < 2:
            raise ConfigurationError("need at least input and output sizes")
        if activation not in ACTIVATIONS:
            raise ConfigurationError(f"unknown activation: {activation!r}")
        self.layer_sizes = list(layer_sizes)
        self.activation = activation
        self.prior_std = prior_std
        self.temperature = temperature
        self.device = resolve_device(device)
        self._gen = as_generator(seed)
        self.layers = nn.ModuleList(
            BayesianLinear(a, b, prior_std, seed=self._gen, device=self.device)
            for a, b in zip(layer_sizes[:-1], layer_sizes[1:]))
        # Learned homoscedastic observation-noise scale per output dim
        # (sigma_n = exp(log_noise)), trained jointly by fit().
        self.log_noise = (nn.Parameter(torch.full((layer_sizes[-1],), LOG_NOISE0,
                                                  device=self.device))
                          if learn_observation_noise else None)
        self._dgen = device_generator(self._gen, self.device)
        self.loss_history: List[float] = []
        self.kl_history: List[float] = []
        self.last_route: Optional[str] = None

    @property
    def params(self) -> List[dict]:
        """The layers' tensors: a list of {"w_mu", "w_rho", "b_mu", "b_rho"}."""
        return [layer.params for layer in self.layers]

    @property
    def observation_noise_std(self) -> Optional[np.ndarray]:
        """Learned aleatoric noise scale sigma_n, or None if not learned."""
        if self.log_noise is None:
            return None
        return torch.exp(self.log_noise.detach()).cpu().numpy()

    def _draws(self, *shape) -> torch.Tensor:
        return torch.randn((*shape, n_weights(self.layer_sizes)), generator=self._dgen,
                           device=self.device)

    def _trainable(self):
        """What fit() optimizes: the layers (and log_noise when learned)."""
        if self.log_noise is None:
            return self.params
        return {"layers": self.params, "log_noise": self.log_noise}

    @torch.no_grad()
    def _set_trainable(self, trainable):
        for dst, src in zip(_flat(self._trainable()), _flat(trainable)):
            dst.copy_(src)

    @torch.no_grad()
    def forward(self, x, temperature: Optional[float] = None) -> np.ndarray:
        """One stochastic forward pass."""
        T = self.temperature if temperature is None else temperature
        return forward_sample(self.params, _inputs(x, self.device), self._draws(), T,
                              self.activation).cpu().numpy()

    def predict(self, x, n_samples: int = 100) -> PredictionResult:
        """MC predictive mean/std over ``n_samples`` weight draws, one batched
        pass (a CUDA graph on the card)."""
        samples, self.last_route = run_predict(
            Draws(self._dgen), [{k: v.detach() for k, v in p.items()} for p in self.params],
            _inputs(x, self.device), self.temperature, self.activation, n_samples)
        return _prediction(samples.cpu().numpy())

    @torch.no_grad()
    def compute_loss(self, x, y, kl_weight: float = 0.01, n_mc: int = 1
                     ) -> Tuple[float, float, float]:
        """(total, data term, kl) on ``n_mc`` MC draws."""
        x = _inputs(x, self.device)
        total, (mse, kl) = elbo_loss(
            self._trainable(), self._draws(n_mc), x, _targets(y, x.shape[0], self.device),
            kl_weight=kl_weight, temperature=self.temperature, activation=self.activation,
            prior_std=self.prior_std)
        return float(total), float(mse), float(kl)

    def fit(self, x, y, n_epochs: int = 100, batch_size: int = 32, learning_rate: float = 0.01,
            kl_weight: float = 0.01, n_samples_per_batch: int = 3, verbose: bool = False,
            mesh=None) -> dict:
        """SVI training: each step is one ELBO gradient over
        ``n_samples_per_batch`` MC weight draws and one Adam update.

        The whole dataset in one batch (and no mesh): all epochs run as one
        loop of graphed steps. Otherwise minibatches, a fresh permutation
        each epoch, a history entry per epoch (the mean over its batches).
        ``mesh`` (a ``tsu_tpu_torch.parallel.Mesh``): each full-size
        minibatch is split over its ``chains`` devices (batch_size should be
        divisible by the axis size)."""
        x = _inputs(x, "cpu")
        y = _targets(y, x.shape[0], "cpu")
        n = x.shape[0]
        batch_size = min(batch_size, n)
        trainable = self._trainable()

        if batch_size >= n and mesh is None:
            trained, losses, kls, self.last_route = run_fit(
                Draws(self._dgen), trainable, x.to(self.device), y.to(self.device),
                n_steps=n_epochs, learning_rate=learning_rate, kl_weight=kl_weight,
                temperature=self.temperature, prior_std=self.prior_std,
                n_mc=n_samples_per_batch, activation=self.activation)
            self.loss_history.extend(losses.cpu().tolist())
            self.kl_history.extend(kls.cpu().tolist())
            self._set_trainable(trained)
            if verbose:
                print(f"final loss={self.loss_history[-1]:.4f}")
            return {"loss_history": self.loss_history, "kl_history": self.kl_history}

        rng = np.random.default_rng(int(torch.randint(0, 2**31 - 1, (), generator=self._gen)))
        devices = None
        if mesh is not None:
            if mesh.ranks.any():
                raise ConfigurationError(
                    "fit(mesh=) splits a minibatch over the devices of one process; a mesh "
                    "that spans processes is for the sharded lattice, tempering and SMC paths")
            devices = [torch.device(d) for d in mesh.devices[0, :, 0, 0]]
        ts = [t.detach().clone() for t in _flat(trainable)]
        opt, _ = _adam(ts, scalar(learning_rate, self.device), self.device)
        kw = dict(n_layers=len(self.layers), learn_noise=self.log_noise is not None,
                  activation=self.activation, kl_weight=kl_weight,
                  temperature=self.temperature, prior_std=self.prior_std, n_total=float(n))
        for epoch in range(n_epochs):
            perm = torch.from_numpy(rng.permutation(n))
            epoch_loss = torch.zeros((), device=self.device)
            epoch_kl = torch.zeros((), device=self.device)
            n_batches = 0
            for start in range(0, n, batch_size):
                idx = perm[start:start + batch_size]
                loss, kl = train_step(
                    ts, opt, self._draws(n_samples_per_batch), x[idx].to(self.device),
                    y[idx].to(self.device), devices=devices if len(idx) == batch_size else None,
                    **kw)
                epoch_loss += loss.detach()
                epoch_kl += kl.detach()
                n_batches += 1
            self.loss_history.append(float(epoch_loss) / n_batches)
            self.kl_history.append(float(epoch_kl) / n_batches)
            if verbose and (epoch % max(1, n_epochs // 10) == 0):
                print(f"epoch {epoch:4d}  loss={self.loss_history[-1]:.4f}")
        self._set_trainable(_unflat(ts, len(self.layers), self.log_noise is not None))
        self.last_route = "eager"
        return {"loss_history": self.loss_history, "kl_history": self.kl_history}

    @torch.no_grad()
    def posterior_energy(self, x, y, noise_std: Optional[float] = None):
        """(BNNPosterior, theta0): the true weight posterior as an energy for
        the continuous samplers, and the posterior means flattened in its
        layout (a tensor on the network's device) as a start."""
        if noise_std is None:
            sn = self.observation_noise_std
            noise_std = float(sn[0]) if sn is not None else 0.1
        x = np.atleast_2d(np.asarray(x, np.float32))
        post = BNNPosterior(x=x, y=np.asarray(y, np.float32).reshape(-1, self.layer_sizes[-1]),
                            sizes=tuple(self.layer_sizes), activation=self.activation,
                            prior_std=self.prior_std, noise_std=noise_std)
        theta0 = torch.cat([torch.cat([p["w_mu"].reshape(-1), p["b_mu"]]) for p in self.params])
        return post, theta0.clone()

    def predict_mcmc(self, x_train, y_train, x_test, n_samples: int = 200, n_chains: int = 8,
                     n_burnin: int = 2000, noise_std: Optional[float] = None
                     ) -> PredictionResult:
        """Full-Bayes predictive: MALA over the flat weight posterior from the
        posterior means (+ 0.05 N(0, 1) per chain), every retained draw a
        predictive sample."""
        post, theta0 = self.posterior_energy(x_train, y_train, noise_std)
        x0 = theta0[None, :] + 0.05 * torch.randn((n_chains, theta0.shape[0]),
                                                  generator=self._gen).to(self.device)
        with torch.no_grad():
            preds, info = mcmc_predictive(Draws(self._dgen), post, x0,
                                          _inputs(x_test, self.device),
                                          max(1, n_samples // n_chains), n_burnin)
        self.last_route = info["route"]
        return _prediction(preds.cpu().numpy())

    @torch.no_grad()
    def sample_posterior(self, n_samples: int = 10) -> List[PosteriorSample]:
        """Draw posterior weight samples; each sample's ``energy`` is the
        posterior's KL to the prior, as in the reference."""
        out = []
        for _ in range(n_samples):
            ws, bs = [], []
            for layer in self.layers:
                w, b = layer.sample_weights(self.temperature)
                ws.append(w)
                bs.append(b)
            out.append(PosteriorSample(weights=ws, bias=bs,
                                       energy=float(kl_to_prior(self.params, self.prior_std)),
                                       temperature=self.temperature))
        return out


class BayesianRegressor(BayesianNetwork):
    """Regression head with intervals and active learning."""

    def __init__(self, input_dim: int, hidden_dims: List[int], prior_std: float = 1.0,
                 temperature: float = 1.0, seed=None, device=None):
        super().__init__([input_dim] + list(hidden_dims) + [1], activation="relu",
                         prior_std=prior_std, temperature=temperature, seed=seed, device=device)

    def predict_with_interval(self, x, n_samples: int = 100, confidence: float = 0.95,
                              include_observation_noise: bool = False):
        """(mean, lower, upper): by default the epistemic credible interval of
        the mean function (MC percentiles over weight draws); with
        ``include_observation_noise`` the learned sigma_n widens it into a
        Gaussian predictive interval for new observations."""
        result = self.predict(x, n_samples=n_samples)
        alpha = (1.0 - confidence) / 2.0
        if include_observation_noise and self.log_noise is not None:
            from scipy import stats

            total = np.sqrt(result.std**2 + self.observation_noise_std**2)
            z = stats.norm.ppf(1.0 - alpha)
            return result.mean, result.mean - z * total, result.mean + z * total
        lower = np.percentile(result.samples, 100 * alpha, axis=0)
        upper = np.percentile(result.samples, 100 * (1 - alpha), axis=0)
        return result.mean, lower, upper

    def select_informative_samples(self, x_pool, n_select: int, n_samples: int = 100
                                   ) -> np.ndarray:
        """Active learning by maximum predictive std."""
        result = self.predict(x_pool, n_samples=n_samples)
        return np.argsort(np.mean(result.std, axis=-1))[-n_select:]


# -- anchored ensembles (randomized-MAP posterior sampling) ------------------


def forward_members(layers, x: torch.Tensor, activation: str) -> torch.Tensor:
    """Deterministic forward of M members at once: layers {"w" (M, a, b),
    "b" (M, b)}, x (N, d_in) -> (M, N, d_out)."""
    act = ACTIVATIONS[activation]
    h = x.expand(layers[0]["w"].shape[0], *x.shape)
    for i, layer in enumerate(layers):
        h = torch.baddbmm(layer["b"][:, None, :], h, layer["w"])
        if i < len(layers) - 1:
            h = act(h)
    return h


def anchored_losses(layers, log_noise, anchors, x, y, prior_std, activation: str):
    """Each member's randomized-MAP objective (M,): mean Gaussian NLL +
    ||theta - anchor||^2 / (2 N prior_std^2)."""
    pred = forward_members(layers, x, activation)
    var = torch.exp(2.0 * log_noise)[:, None, None]
    nll = torch.mean(0.5 * ((pred - y) ** 2 / var + torch.log(2.0 * math.pi * var)), dim=(1, 2))
    reg = sum(torch.sum((l["w"] - a["w"]) ** 2, dim=(1, 2)) + torch.sum((l["b"] - a["b"]) ** 2, dim=1)
              for l, a in zip(layers, anchors)) / (2.0 * prior_std ** 2)
    return nll + reg / x.shape[0]


def ensemble_loop(sizes: Sequence[int], n_members: int, activation: str, n_points: int, device,
                  *, graph: bool = True) -> StepLoop:
    """The (cached) ensemble training loop: state every member's layers and
    log_noise (their ``.grad`` set in place), the anchors, Adam's state, x,
    y, lr and prior_std; one batched loss and one gradient a step over all
    members; records the members' mean loss."""
    device = canonical(device)
    sizes = tuple(sizes)

    def build():
        M = n_members
        shapes = [((M, a, b), (M, b)) for a, b in zip(sizes[:-1], sizes[1:])]
        layers = [{"w": torch.zeros(sw, device=device), "b": torch.zeros(sb, device=device)}
                  for sw, sb in shapes]
        anchors = [{"w": torch.zeros(sw, device=device), "b": torch.zeros(sb, device=device)}
                   for sw, sb in shapes]
        ts = [l[k] for l in layers for k in ("w", "b")] + [torch.zeros(M, device=device)]
        st = {"x": torch.zeros((n_points, sizes[0]), device=device),
              "y": torch.zeros((n_points, sizes[-1]), device=device),
              "lr": scalar(0.0, device), "prior_std": scalar(1.0, device)}
        opt, adam = _adam(ts, st["lr"], device)
        st.update({f"p{i}": t for i, t in enumerate(ts)})
        st.update({f"g{i}": t.grad for i, t in enumerate(ts)})
        st.update({f"a{i}": a[k] for i, a in enumerate(anchors) for k in ("w", "b")})
        st.update({f"adam{i}": t for i, t in enumerate(adam)})
        n_layers = len(layers)

        def loss(ts_):
            ls = [{"w": ts_[2 * i], "b": ts_[2 * i + 1]} for i in range(n_layers)]
            per = anchored_losses(ls, ts_[-1], anchors, st["x"], st["y"], st["prior_std"],
                                  activation)
            return per.sum(), per.mean()

        value_grad = grad_and_value(loss, has_aux=True)

        def step(bufs, k):
            grads, (_, mean) = value_grad(tuple(ts))
            for t, g in zip(ts, grads):
                t.grad.copy_(g)
            opt.step()
            bufs["loss"][k].copy_(mean)

        loop = StepLoop("anchored ensemble", device, step, st, {},
                        {"loss": ((), torch.float32)}, graph=graph)
        loop.params, loop.anchors = ts, anchors
        return loop

    return cached_loop(("anchored ensemble", sizes, n_members, activation, n_points, device,
                        graph), build)


def run_anchored(trainable: dict, anchors, x: torch.Tensor, y: torch.Tensor, *, n_steps: int,
                 learning_rate: float, prior_std: float, activation: str, graph: bool = True):
    """``n_steps`` Adam steps of every member from ``trainable`` ({"layers":
    [{"w", "b"}], "log_noise": (M,)}) toward its anchors, on x's device.
    Returns (the trained ``trainable``, mean losses (n_steps,), route)."""
    layers = trainable["layers"]
    M = layers[0]["w"].shape[0]
    loop = ensemble_loop(sizes_of(layers), M, activation, x.shape[0], x.device, graph=graph)
    st = loop.state
    with torch.no_grad():
        src = [l[k] for l in layers for k in ("w", "b")] + [trainable["log_noise"]]
        for t, s in zip(loop.params, src):
            t.copy_(s)
        for dst, a in zip(loop.anchors, anchors):
            for k in ("w", "b"):
                dst[k].copy_(a[k])
        for name, t in st.items():
            if name.startswith("adam"):
                t.zero_()
        st["x"].copy_(x)
        st["y"].copy_(y)
        st["lr"].fill_(learning_rate)
        st["prior_std"].fill_(prior_std)
    losses = torch.empty(n_steps, dtype=torch.float32, device=x.device)
    i = 0
    for L in chunks(n_steps, CHUNK):
        losses[i:i + L].copy_(loop.run(Draws(given={}), L)["loss"])
        i += L
    ts = [t.clone() for t in loop.params]
    out = {"layers": [{"w": ts[2 * i], "b": ts[2 * i + 1]} for i in range(len(layers))],
           "log_noise": ts[-1]}
    return out, losses, loop.route


class AnchoredEnsembleRegressor:
    """Randomized-MAP ("anchored") deep-ensemble regressor.

    Each of ``n_members`` networks is trained to a MAP objective regularized
    toward its own draw from the N(0, prior_std^2) prior, so weight
    directions the data does not constrain stay at prior spread and the
    out-of-distribution predictive reverts to the prior predictive. Members
    are a leading batch dimension: the ensemble trains as one batched loss
    and one gradient a step, and predicts in one batched pass. API as
    :class:`BayesianRegressor`. ``seed``: an int or a CPU
    ``torch.Generator`` (anchors first, then the initial weights)."""

    def __init__(self, input_dim: int, hidden_dims: List[int], n_members: int = 8,
                 activation: str = "relu", prior_std: float = 1.0, seed=None, device=None):
        if n_members < 2:
            raise ConfigurationError("need at least 2 ensemble members")
        if activation not in ACTIVATIONS:
            raise ConfigurationError(f"unknown activation: {activation!r}")
        self.layer_sizes = [input_dim] + list(hidden_dims) + [1]
        self.n_members = n_members
        self.activation = activation
        self.prior_std = prior_std
        self.device = resolve_device(device)
        gen = as_generator(seed)

        def draw():
            return [{"w": prior_std * torch.randn((n_members, a, b), generator=gen),
                     "b": prior_std * torch.randn((n_members, b), generator=gen)}
                    for a, b in zip(self.layer_sizes[:-1], self.layer_sizes[1:])]

        self.anchors = [{k: v.to(self.device) for k, v in l.items()} for l in draw()]
        self.trainable = {
            "layers": [{k: v.to(self.device) for k, v in l.items()} for l in draw()],
            "log_noise": torch.full((n_members,), LOG_NOISE0, device=self.device),
        }
        self.loss_history: List[float] = []
        self.last_route: Optional[str] = None

    @property
    def observation_noise_std(self) -> np.ndarray:
        """Learned aleatoric noise scale (ensemble mean), shape (1,)."""
        return torch.exp(self.trainable["log_noise"]).mean().cpu().numpy().reshape(1)

    def fit(self, x, y, n_epochs: int = 2000, learning_rate: float = 0.01, **_ignored) -> dict:
        """Train all members together (one loop of graphed steps)."""
        x = _inputs(x, self.device)
        y = _targets(y, x.shape[0], self.device)
        self.trainable, losses, self.last_route = run_anchored(
            self.trainable, self.anchors, x, y, n_steps=n_epochs, learning_rate=learning_rate,
            prior_std=self.prior_std, activation=self.activation)
        self.loss_history.extend(losses.cpu().tolist())
        return {"loss_history": self.loss_history}

    @torch.no_grad()
    def predict(self, x, n_samples: int = 100) -> PredictionResult:
        """Predictive over members: the samples axis is the ensemble
        (``n_samples`` accepted for API parity; the ensemble size is fixed)."""
        preds = forward_members(self.trainable["layers"], _inputs(x, self.device),
                                self.activation)
        return _prediction(preds.cpu().numpy())

    def predict_with_interval(self, x, n_samples: int = 100, confidence: float = 0.95,
                              include_observation_noise: bool = True):
        """(mean, lower, upper) Gaussian predictive interval."""
        from scipy import stats

        res = self.predict(x, n_samples)
        std = res.std
        if include_observation_noise:
            std = np.sqrt(std**2 + float(self.observation_noise_std[0]) ** 2)
        z = stats.norm.ppf(0.5 + confidence / 2.0)
        return res.mean, res.mean - z * std, res.mean + z * std

    def select_informative_samples(self, x_pool, n_select: int, n_samples: int = 100
                                   ) -> np.ndarray:
        """Active learning by maximum ensemble disagreement."""
        res = self.predict(x_pool, n_samples)
        return np.argsort(np.mean(res.std, axis=-1))[-n_select:]
