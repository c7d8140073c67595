"""The port's demos (``tsu_tpu_torch/demos.py``) against the JAX package's
(``tsu_tpu/demos.py``), on the CPU.

The benchmark target's modes are bit-identical to the reference's; mode
coverage, the energy statistics and the analysis report equal the
reference's on the same samples (1e-5), and so does the host MH baseline's
chain on the same numpy generator. Then ``tests/test_aux.py``'s three demo
checks at their sizes, and the plotly dashboards (which raise
``ImportError`` without plotly).
"""

import importlib.util

import numpy as np
import pytest
import torch

import tsu_tpu.demos as jdemos
from tsu_tpu_torch import demos
from tsu_tpu_torch.config import ConfigurationError

CPU = "cpu"


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_modes_are_the_reference_arrays(seed):
    ours, ref = demos.MultimodalDistribution(seed=seed), jdemos.MultimodalDistribution(seed=seed)
    assert ours.modes.dtype == ref.modes.dtype
    np.testing.assert_array_equal(ours.modes, ref.modes)


def _samples(seed, n, dist):
    rng = np.random.default_rng(seed)
    centers = dist.modes[rng.integers(0, dist.n_modes, n)]
    return (centers + 0.8 * rng.normal(size=centers.shape)).astype(np.float32)


def test_coverage_and_energy_stats_equal_the_reference():
    ours, ref = demos.MultimodalDistribution(seed=0), jdemos.MultimodalDistribution(seed=0)
    x = _samples(1, 400, ours)
    a, b = ours.mode_coverage(x), ref.mode_coverage(x)
    np.testing.assert_array_equal(a["fractions"], b["fractions"])
    assert a["n_modes_covered"] == b["n_modes_covered"]
    a, b = demos._energy_stats(ours.energy, x, device=CPU), jdemos._energy_stats(ref.energy, x)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-5), k


def test_analyze_results_equals_the_reference(capsys):
    ours, ref = demos.MultimodalDistribution(seed=0), jdemos.MultimodalDistribution(seed=0)
    tsu, mh = _samples(2, 300, ours), 1.3 * _samples(3, 200, ours)
    results = {"tsu": {"samples": tsu, "time_s": 0.7, "coverage": ours.mode_coverage(tsu)},
               "mcmc": {"samples": mh, "time_s": 0.2, "coverage": ours.mode_coverage(mh)}}
    a = demos.analyze_results(results, ours, hardware_time_s=1e-4, device=CPU)
    out_a = capsys.readouterr().out
    b = jdemos.analyze_results(results, ref, hardware_time_s=1e-4)
    out_b = capsys.readouterr().out
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            for q in a[k]:
                assert a[k][q] == pytest.approx(b[k][q], rel=1e-5, abs=1e-5), (k, q)
        else:
            assert a[k] == pytest.approx(b[k], rel=1e-5), k
    assert [ln.split()[0] for ln in out_a.splitlines() if ln.strip()] == \
        [ln.split()[0] for ln in out_b.splitlines() if ln.strip()]


def test_metropolis_hastings_equals_the_reference_chain():
    ours, ref = demos.MultimodalDistribution(seed=0), jdemos.MultimodalDistribution(seed=0)
    a, acc_a = demos.metropolis_hastings(np.random.default_rng(5), ours.energy,
                                         np.zeros(ours.dim), 300, n_burnin=100)
    b, acc_b = jdemos.metropolis_hastings(np.random.default_rng(5), ref.energy,
                                          np.zeros(ref.dim), 300, n_burnin=100)
    assert acc_a == acc_b
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_bayesian_inference_demo():
    out = demos.demo_bayesian_inference(seed=0, device=CPU)
    assert np.all(np.abs(out["posterior_mean"] - out["theta_true"]) < 0.3)


def test_multimodal_demo_covers_modes():
    out = demos.demo_continuous_sampling(n_samples=500, seed=0, device=CPU)
    assert out["tsu"]["coverage"]["n_modes_covered"] == 3
    assert out["tsu"]["samples"].shape == (500, 10)
    assert out["mcmc"]["samples"].shape == (500, 10)


def test_analyze_results_report():
    dist = demos.MultimodalDistribution(seed=0)
    res = demos.demo_continuous_sampling(n_samples=300, seed=0, device=CPU)
    out = demos.analyze_results(res, dist, hardware_time_s=1e-4, device=CPU)
    assert 0.0 <= out["mode_coverage_tsu"] <= 1.0
    assert out["metric_wins"] in (0, 1, 2, 3)
    assert out["time_ratio"] > 0
    assert out["hardware_speedup"] > 0
    assert np.isfinite(out["tsu_quality"]["mean_energy"])


def test_phase_transition_demo_follows_onsager():
    out = demos.demo_phase_transition(size=16, n_temps=6, device=CPU)
    cold = out["temperatures"] <= 2.0
    assert np.all(np.abs(out["magnetization"][cold] - out["onsager"][cold]) < 0.1)
    assert out["magnetization"][-1] < 0.3


@pytest.mark.parametrize("which", ["modes", "energy"])
def test_plotly_dashboards(which):
    dist = demos.MultimodalDistribution(seed=0)
    rng = np.random.default_rng(0)

    def draw():
        if which == "modes":
            return demos.create_plotly_mode_visualization(
                rng.normal(size=(50, dist.dim)), rng.normal(size=(50, dist.dim)), dist)
        q = {"mean_energy": 1.0, "std_energy": 0.5, "min_energy": 0.1, "n_modes_covered": 3}
        return demos.create_plotly_energy_comparison(q, q)

    if importlib.util.find_spec("plotly") is None:
        with pytest.raises(ImportError, match="plotly"):
            draw()
    else:
        fig = draw()
        assert len(fig.data) == (2 + dist.n_modes if which == "modes" else 4)


@pytest.mark.parametrize("demo", ["demo_continuous_sampling", "demo_phase_transition",
                                  "demo_bayesian_inference", "run_all_demos"])
def test_demos_refuse_the_cpu_without_cuda(demo, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigurationError):
        getattr(demos, demo)()
