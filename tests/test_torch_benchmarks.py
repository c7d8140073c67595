"""The port's benchmark suites (``tsu_tpu_torch/benchmarks/``), hardware
models and profiling hooks against the JAX package's, on the CPU.

Each suite runs its rows at tiny sizes on both packages; the rows' names
and ``summary()`` keys must be the same, and each port row's route is
recorded. The scaling rows run on meshes of the CPU repeated, where the
data-parallel BNN split over 4 shards must give the one-device loss. The
hardware models' parity follows ``tests/test_aux.py``; ``profiling.trace``
must write a Chrome trace on the CPU.
"""

import json
import os

import numpy as np
import pytest

from tsu_tpu.benchmarks import comparison as jcomparison
from tsu_tpu.benchmarks import ml as jml_bench
from tsu_tpu.benchmarks import optimization as joptimization
from tsu_tpu.benchmarks import sampling as jsampling
from tsu_tpu_torch import hardware, profiling
from tsu_tpu_torch.benchmarks import (
    BenchmarkRunner,
    ComparisonBenchmark,
    MLBenchmark,
    OptimizationBenchmark,
    SamplingBenchmark,
)
from tsu_tpu_torch.benchmarks import scaling
from tsu_tpu_torch.benchmarks.ml import expected_calibration_error, gaussian_nll

CPU = "cpu"


def _same_rows(ours, ref):
    a, b = [r.summary() for r in ours], [r.summary() for r in ref]
    assert [r["name"] for r in a] == [r["name"] for r in b]
    for x, y in zip(a, b):
        assert x.keys() == y.keys(), (x["name"], set(x) ^ set(y))
    return a


def _sampling(bench):
    bench.benchmark_uniform_binary(200)
    bench.benchmark_boltzmann_chain(4, 200)
    bench.benchmark_ferromagnet_bimodal(4, 400)
    return bench.results


def test_sampling_suite_rows_equal_jax():
    port = SamplingBenchmark(seed=0, n_chains=8, device=CPU)
    rows = _same_rows(_sampling(port), _sampling(jsampling.SamplingBenchmark(seed=0, n_chains=8)))
    assert set(port.routes) == {r["name"] for r in rows}
    assert all(r["kl_divergence"] >= 0 for r in rows)


def _optimization(bench):
    bench.benchmark_maxcut(8, n_steps=20)
    bench.benchmark_graph_coloring(4, 3, n_steps=20)
    bench.benchmark_number_partitioning(6, n_steps=20)
    bench.benchmark_maxcut_sparse(300, 900, n_steps=10)
    return bench.results


def test_optimization_suite_rows_equal_jax():
    port = OptimizationBenchmark(seed=0, n_chains=4, device=CPU)
    rows = _same_rows(_optimization(port),
                      _optimization(joptimization.OptimizationBenchmark(seed=0, n_chains=4)))
    assert port.routes == {"maxcut": "native_cpp", "graph_coloring": "native_cpp",
                           "number_partitioning": "native_cpp", "maxcut_sparse": "device"}
    assert rows[0]["objective"] <= rows[0]["reference_bound"] + 1e-9 or rows[0]["gap_vs_bound"] <= 0


def test_spin_glass_row():
    """The EA row's keys (the reference's row at this size compiles for
    minutes on the CPU; its keys are those of
    tsu_tpu/benchmarks/optimization.py:351-370)."""
    port = OptimizationBenchmark(seed=0, device=CPU)
    row = port.benchmark_spin_glass(8, n_iters=4, quick=True).summary()
    assert set(row) == {"name", "n_variables", "objective", "reference_bound", "gap_vs_bound",
                        "time_ms", "energy_per_site", "bound_type", "method", "n_rungs",
                        "n_copies", "n_iters", "swap_acceptance", "min_pair_acceptance",
                        "ladder_build_time_s", "warmup_time_s", "discrete_table_path"}
    assert row["discrete_table_path"] is True and port.routes["spin_glass_ea"] == "device"


def _ml(bench):
    bench.benchmark_sinusoid(n_train=20, n_epochs=5)
    bench.benchmark_heteroscedastic(n_train=20, n_epochs=5)
    bench.benchmark_extrapolation(n_train=20, n_epochs=5)
    return bench.results


def test_ml_suite_rows_equal_jax():
    port = MLBenchmark(seed=0, device=CPU)
    rows = _same_rows(_ml(port), _ml(jml_bench.MLBenchmark(seed=0)))
    assert port.routes == {"sinusoid": "eager", "heteroscedastic": "eager",
                           "extrapolation": "eager"}
    assert all(0.0 <= r["coverage_95"] <= 1.0 for r in rows)


def test_ml_metrics_equal_jax():
    rng = np.random.default_rng(0)
    y, mean, std = rng.normal(size=50), rng.normal(size=50), rng.uniform(0.1, 2, 50)
    assert expected_calibration_error(y, mean, std) == jml_bench.expected_calibration_error(
        y, mean, std)
    assert gaussian_nll(y, mean, std) == jml_bench.gaussian_nll(y, mean, std)


def _comparison(bench):
    bench.compare_sampling_methods(n_bits=4, n_samples=100)
    bench.compare_optimization_methods(n_nodes=6, time_budget_s=0.01)
    trials = bench.run_trials(n_trials=2, n_bits=4, n_samples=100)
    return bench.results, trials


def test_comparison_suite_rows_equal_jax():
    port = ComparisonBenchmark(seed=0, device=CPU)
    rows, trials = _comparison(port)
    ref_rows, ref_trials = _comparison(jcomparison.ComparisonBenchmark(seed=0))
    assert [(r.name, r.method) for r in rows] == [(r.name, r.method) for r in ref_rows]
    for a, b in zip(rows, ref_rows):
        assert a.summary().keys() == b.summary().keys()
    assert trials.keys() == ref_trials.keys()
    assert port.routes["multi_trial/gibbs"] == "device"


def test_runner_writes_the_reference_layout(tmp_path, monkeypatch):
    """The runner end to end with each suite cut to one tiny row: the JSON
    keeps the reference's layout, and the routes are kept per suite."""
    monkeypatch.setattr(SamplingBenchmark, "run_all_benchmarks",
                        lambda self, quick: [self.benchmark_uniform_binary(100)])
    monkeypatch.setattr(OptimizationBenchmark, "run_all_benchmarks",
                        lambda self, quick: [self.benchmark_maxcut(6, n_steps=10)])
    monkeypatch.setattr(MLBenchmark, "run_all_benchmarks",
                        lambda self, quick: [self.benchmark_sinusoid(n_train=10, n_epochs=3)])
    monkeypatch.setattr(ComparisonBenchmark, "run_all_comparisons",
                        lambda self, quick: self.compare_sampling_methods(3, 50))
    runner = BenchmarkRunner(seed=0, output_dir=str(tmp_path), device=CPU)
    out = runner.run_all(quick=True)
    assert set(out) == {"topology", "seed", "quick", "total_time_s", "resumed_run", "suites"}
    assert list(out["suites"]) == ["sampling", "optimization", "ml", "comparison"]
    assert {"backend", "n_devices", "device_kind", "torch", "cuda"} <= set(out["topology"])
    with open(os.path.join(tmp_path, "benchmark_results.json")) as f:
        assert json.load(f)["suites"] == out["suites"]
    assert os.path.exists(os.path.join(tmp_path, "benchmark_report.txt"))
    assert not os.path.exists(os.path.join(tmp_path, "benchmark_partial.json"))
    assert runner.routes["ml"] == {"sinusoid": "eager"}


def test_scaling_rows():
    devs = [CPU] * 2
    out = scaling.measure_chains_scaling(dim=2, chains_per_device=8, n_samples=3, n_steps=2,
                                         devices=devs)
    assert out["1_device"]["samples_per_s"] > 0 and out["all_devices"]["n_devices"] == 2
    assert out["efficiency"] is None
    out = scaling.measure_lattice_scaling(rows_per_device=8, cols=16, n_sweeps=2, devices=devs)
    assert out["1_device"]["flips_per_s"] > 0 and out["kernel"] == "plain"
    out = scaling.measure_lattice_matched(size=32, n_sweeps=4, n_iters=1, device=CPU)
    assert out["size"] == 32 and out["n_sweeps"] == 4 and out["flips_per_s"] > 0


def test_bnn_dp_split_equals_one_device():
    out = scaling.measure_bnn_dp_scaling(points_per_device=64, dim=2, hidden=8, n_epochs=3,
                                         devices=[CPU] * 4)
    assert set(out["all_devices"]) == {"n_devices", "points_per_s", "loss_final", "n_points",
                                       "time_s"}
    assert out["all_devices"]["n_points"] == 256
    one = scaling.bnn_dp_row([CPU], 256, dim=2, hidden=8, n_epochs=3)
    assert out["all_devices"]["loss_final"] == pytest.approx(one["loss_final"], rel=1e-5)


# -- hardware and profiling (tests/test_aux.py) --------------------------------


def test_roofline():
    r = hardware.checkerboard_roofline(hardware.GPUHardwareSpec(), 4096, 4096)
    assert r["bound"] in ("memory", "compute") and r["flips_per_s_ceiling"] > 1e10
    assert r["bytes_per_sweep"] == 3 * 2 * 4096 * 2048


def test_estimator_parity():
    from tsu_tpu.hardware import HardwarePerformanceEstimator as JaxEstimator

    est = hardware.HardwarePerformanceEstimator()
    out = est.estimate_sampling_time(10_000, 10, emulator_time=1.0)
    assert out == JaxEstimator().estimate_sampling_time(10_000, 10, emulator_time=1.0)
    assert out["hardware_parallel_s"] < out["hardware_sequential_s"]
    out_c = hardware.ConservativeEstimator().estimate_sampling_time(10_000, 10, emulator_time=1.0)
    assert out_c["realistic_speedup"] < out["realistic_speedup"]


def test_emulator_sample_parallel():
    emu = hardware.HardwareEmulator(n_bits=4, parallel_chains=8, device=CPU)
    samples, timing = emu.sample_parallel(np.zeros((4, 4), np.float32), n_samples=50, seed=0)
    assert samples.shape == (50, 4) and timing["total_time_ns"] > 0


def test_gpu_spec_needs_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(hardware.ConfigurationError):
        hardware.GPUHardwareSpec.from_device()


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("bnn-region"):
            torch.ones(64).cumsum(0)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "bnn-region" for e in events)
    assert any(e.key == "bnn-region" for e in prof.key_averages())
    with profiling.Timer() as t:
        torch.ones(8).sum()
    assert t.elapsed >= 0.0


def test_seed_spread_tool_on_the_cpu(capsys, monkeypatch):
    from tsu_tpu_torch.tools import ml_seed_spread

    ml_seed_spread.main(["--seeds", "2", "--epochs", "3", "--device", CPU])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["seed"] for r in out["rows"]] == [0, 1] and 0 <= out["in_band"] <= 2
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(hardware.ConfigurationError):
        ml_seed_spread.main(["--seeds", "1"])
