"""The API's probabilistic-layer half of the port (``tsu_tpu_torch/api.py``)
against ``tsu_tpu/api.py``'s on carried weights and given noise, and the
top-level namespace: the port exports every name of ``tsu_tpu.__all__``,
the eight plot functions included. On the CPU.
"""

import jax
import numpy as np
import pytest
import torch

import tsu_tpu
import tsu_tpu_torch
from tsu_tpu.api import BernoulliActivation as JaxBernoulli
from tsu_tpu.api import StochasticLinear as JaxLinear
from tsu_tpu_torch import (
    BernoulliActivation,
    ConfigurationError,
    ProbabilisticLayer,
    ProbabilisticModel,
    StochasticLinear,
)
from tsu_tpu_torch.api import perturbed_linear
from tsu_tpu_torch.interop import stochastic_linear_from_numpy

CPU = "cpu"
PLOTS = {
    "plot_predictions_with_uncertainty",
    "plot_uncertainty_vs_error",
    "plot_energy_landscape_2d",
    "plot_ising_state",
    "plot_phase_transition",
    "plot_sampling_diagnostics",
    "plot_active_learning_curve",
    "plot_interactive_energy_landscape",
}


def test_namespace_lacks_exactly_the_plot_functions():
    # The name is the slice-6 one; since slice 7 the namespace lacks nothing.
    assert set(tsu_tpu.__all__) - set(tsu_tpu_torch.__all__) == set()
    assert PLOTS <= set(tsu_tpu_torch.__all__)
    for name in tsu_tpu_torch.__all__:
        assert hasattr(tsu_tpu_torch, name), name
    assert tsu_tpu_torch.TSU is tsu_tpu_torch.ThermalSamplingUnit
    assert tsu_tpu_torch.TPUHardwareSpec is tsu_tpu_torch.GPUHardwareSpec


def test_quick_demo_on_the_cpu(capsys):
    tsu_tpu_torch.quick_demo(device=CPU)
    assert "Demo complete." in capsys.readouterr().out


@pytest.mark.parametrize("n_samples", [None, 3, 0])
def test_stochastic_linear_equals_jax_on_its_noise(n_samples):
    """The reference's forward draws normal(k, shape) with its next key;
    the same noise through the port's layer math on carried weights."""
    ref = JaxLinear(4, 3, weight_noise=0.2, seed=1)
    layer = stochastic_linear_from_numpy(ref.weights, ref.bias + 0.5, 0.2, device=CPU)
    ref.bias = ref.bias + 0.5
    x = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
    _, k = jax.random.split(ref._key)
    shape = ((n_samples,) if n_samples is not None else ()) + ref.weights.shape
    noise = np.asarray(jax.random.normal(k, shape))
    expected = ref.forward(x, n_samples)
    out = perturbed_linear(torch.tensor(x), torch.tensor(layer.weights), torch.tensor(layer.bias),
                           torch.tensor(noise), layer.weight_noise).numpy()
    np.testing.assert_allclose(out, expected, rtol=1e-5, atol=1e-6)
    assert layer.forward(x, n_samples).shape == expected.shape


def test_stochastic_linear_stacking_rule():
    layer = StochasticLinear(4, 3, seed=0, device=CPU)
    x = np.ones((2, 4), np.float32)
    assert layer.forward(x).shape == (2, 3)
    assert layer.forward(x, n_samples=1).shape == (1, 2, 3)
    assert layer.forward(x, n_samples=0).shape == (0, 2, 3)
    assert isinstance(layer, ProbabilisticLayer)
    a, b = layer.forward(x), layer.forward(x)
    assert not np.array_equal(a, b)


def test_bernoulli_activation_rates_and_shapes():
    x = np.array([[-2.0, 0.0, 1.0, 3.0]], np.float32)
    layer = BernoulliActivation(seed=0, device=CPU)
    assert layer.forward(x).shape == (1, 4)
    assert layer.forward(x, n_samples=0).shape == (0, 1, 4)
    out = layer.forward(x, n_samples=40_000)
    assert set(np.unique(out)) <= {0.0, 1.0}
    p = 1.0 / (1.0 + np.exp(-x[0]))
    np.testing.assert_array_less(np.abs(out.mean(axis=(0, 1)) - p), 5 * np.sqrt(p * (1 - p) / 4e4))
    ref = JaxBernoulli(seed=0).forward(x, n_samples=3)
    assert ref.shape == (3, 1, 4)


def test_probabilistic_model():
    model = ProbabilisticModel()
    model.add(StochasticLinear(3, 5, seed=0, device=CPU)).add(BernoulliActivation(seed=1,
                                                                                  device=CPU))
    with pytest.raises(ConfigurationError):
        model.add(object())
    x = np.ones((2, 3), np.float32)
    assert model.forward(x).shape == (2, 5)
    assert model.sample(x, n_samples=7).shape == (7, 2, 5)
    p = model.predict_proba(x, n_samples=50)
    assert p.shape == (2, 5) and np.all((0 <= p) & (p <= 1))


def test_layers_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigurationError):
        StochasticLinear(2, 2)
    with pytest.raises(ConfigurationError):
        BernoulliActivation()
