"""Benchmark suites of the port: sampling quality, optimization, ML
calibration and method comparisons, with the runner that drives them
(counterpart of ``tsu_tpu/benchmarks/``); ``scaling`` measures the
workloads over a device mesh."""

from tsu_tpu_torch.benchmarks.comparison import ComparisonBenchmark
from tsu_tpu_torch.benchmarks.ml import MLBenchmark
from tsu_tpu_torch.benchmarks.optimization import OptimizationBenchmark
from tsu_tpu_torch.benchmarks.runner import BenchmarkRunner
from tsu_tpu_torch.benchmarks.sampling import SamplingBenchmark

__all__ = [
    "SamplingBenchmark",
    "OptimizationBenchmark",
    "MLBenchmark",
    "ComparisonBenchmark",
    "BenchmarkRunner",
]
