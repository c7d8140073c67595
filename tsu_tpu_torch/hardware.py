"""Hardware performance models: the card's roofline and the reference's
projections of a thermodynamic chip.

Counterpart of ``tsu_tpu/hardware.py``.

* ``GPUHardwareSpec`` / ``checkerboard_roofline``: the speed-of-light bound
  of the fused sweep (K1, ``csrc/checkerboard_fused.cu``) on the card. In
  place of the reference's TPU spec, which stays as the alias
  ``TPUHardwareSpec`` (as ``Backend.TPU`` aliases ``CUDA``). The defaults
  are an H100 SXM's; :meth:`GPUHardwareSpec.from_device` reads the card.
* ``TSUHardwareSpec`` / ``HardwarePerformanceEstimator`` /
  ``ConservativeEstimator`` / ``HardwareEmulator``: the reference's
  projection models, unchanged; ``HardwareEmulator.sample_parallel`` runs
  its chains in parallel on the port's ``GibbsSampler``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from tsu_tpu_torch.config import ConfigurationError

# Device memory rate in GB/s by the card's name (NVIDIA's data sheets).
HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,     # H100 SXM
    "NVIDIA H100 PCIe": 2000.0,
    "NVIDIA H100 NVL": 3900.0,
}
INT32_LANES_PER_SM = 64               # Hopper: int32 issue per SM per clock


@dataclass(frozen=True)
class GPUHardwareSpec:
    """One card's figures for speed-of-light estimates; the defaults are an
    H100 SXM's (132 SMs, 80 GB at 3.35 TB/s, 50 MB of L2, a 1.98 GHz boost
    clock: int32 issue 132 x 64 lanes x 1.98 GHz)."""

    name: str = "NVIDIA H100 80GB HBM3"
    hbm_bandwidth_gbps: float = 3350.0
    sm_count: int = 132
    memory_bytes: int = 80 * 2**30
    l2_bytes: int = 50 * 2**20
    clock_ghz: float = 1.98

    @property
    def int32_gops(self) -> float:
        """int32 instructions per second, in G/s."""
        return self.sm_count * INT32_LANES_PER_SM * self.clock_ghz

    @classmethod
    def from_device(cls, device=None) -> "GPUHardwareSpec":
        """The spec of a CUDA device (default the current card): name, SM
        count, memory and L2 from ``torch.cuda.get_device_properties``, the
        memory rate from ``HBM_GBPS`` by name (``ConfigurationError`` for a
        card the table lacks)."""
        if not torch.cuda.is_available():
            raise ConfigurationError("GPUHardwareSpec.from_device needs CUDA")
        props = torch.cuda.get_device_properties(device if device is not None else 0)
        if props.name not in HBM_GBPS:
            raise ConfigurationError(f"no memory rate known for {props.name!r}; add it to "
                                     "tsu_tpu_torch.hardware.HBM_GBPS")
        return cls(name=props.name, hbm_bandwidth_gbps=HBM_GBPS[props.name],
                   sm_count=props.multi_processor_count, memory_bytes=props.total_memory,
                   l2_bytes=props.L2_cache_size)


TPUHardwareSpec = GPUHardwareSpec


def checkerboard_roofline(spec: GPUHardwareSpec, rows: int, cols: int, dtype_bytes: int = 2,
                          ops_per_site: float = 10.0) -> dict:
    """Speed-of-light spin-flips/s of the fused sweep (K1) on one card.

    Bytes: a sweep reads the black plane and writes the red and the black,
    3 x dtype_bytes per compact site (rows x cols / 2 of them), the byte
    count ``chip_smoke.py`` bounds K1 by. Operations: ``ops_per_site`` int32
    instructions per lattice site per sweep, by default Philox4x32-10's
    alone (40 a call, one call per four compact sites a colour) over the
    card's int32 issue rate."""
    n_sites = rows * cols
    bytes_per_sweep = 3 * dtype_bytes * n_sites // 2
    t_mem = bytes_per_sweep / (spec.hbm_bandwidth_gbps * 1e9)
    t_compute = n_sites * ops_per_site / (spec.int32_gops * 1e9)
    t_sweep = max(t_mem, t_compute)
    return {
        "sites": n_sites,
        "bytes_per_sweep": bytes_per_sweep,
        "t_mem_s": t_mem,
        "t_compute_s": t_compute,
        "bound": "memory" if t_mem >= t_compute else "compute",
        "flips_per_s_ceiling": n_sites / t_sweep,
        "sweeps_per_s_ceiling": 1.0 / t_sweep,
    }


# -- the reference's projections of a thermodynamic chip ----------------------


@dataclass
class TSUHardwareSpec:
    """Projected thermodynamic-chip specs."""

    thermal_relaxation_time: float = 1e-9
    circuit_response_time: float = 1e-10
    parallel_units: int = 1000
    dimensions_per_unit: int = 1
    equilibration_steps: int = 100
    samples_per_equilibration: int = 10
    energy_per_sample: float = 1e-15


class HardwarePerformanceEstimator:
    """Physics-based timing projections."""

    def __init__(self, spec: Optional[TSUHardwareSpec] = None):
        self.spec = spec or TSUHardwareSpec()

    def estimate_sampling_time(self, n_samples: int, dimension: int,
                               emulator_time: float) -> dict:
        s = self.spec
        time_per_sample = s.equilibration_steps * s.thermal_relaxation_time + s.circuit_response_time
        sequential_time = n_samples * time_per_sample
        effective_parallel = min(s.parallel_units, max(n_samples, 1))
        parallel_batches = int(np.ceil(n_samples / effective_parallel))
        parallel_time = parallel_batches * time_per_sample
        return {
            "emulator_time_s": emulator_time,
            "hardware_sequential_s": sequential_time,
            "hardware_parallel_s": parallel_time,
            "naive_speedup": emulator_time / sequential_time if sequential_time else 0.0,
            "realistic_speedup": emulator_time / parallel_time if parallel_time else 0.0,
            "parallel_units_used": effective_parallel,
            "energy_joules": n_samples * s.energy_per_sample,
            "energy_comparison": self._compare_energy_to_gpu(n_samples, dimension),
        }

    def _compare_energy_to_gpu(self, n_samples: int, dimension: int) -> dict:
        # ~300 W accelerator drawing for the emulator-equivalent run time.
        gpu_power_w = 300.0
        gpu_time_estimate = n_samples * dimension * 1e-7
        gpu_energy = gpu_power_w * gpu_time_estimate
        tsu_energy = n_samples * self.spec.energy_per_sample
        return {
            "gpu_energy_joules": gpu_energy,
            "tsu_energy_joules": tsu_energy,
            "energy_advantage": gpu_energy / tsu_energy if tsu_energy else float("inf"),
        }


class ConservativeEstimator(HardwarePerformanceEstimator):
    """10x-derated projection."""

    def __init__(self):
        super().__init__(TSUHardwareSpec(thermal_relaxation_time=1e-8, parallel_units=100,
                                         equilibration_steps=1000, energy_per_sample=1e-13))


class HardwareEmulator:
    """Chip-level emulator interface; ``sample_parallel`` runs its chains as
    one batch on ``device`` (default the card)."""

    def __init__(self, n_bits: int = 100, clock_speed_ghz: float = 1.0,
                 parallel_chains: int = 1000, device=None):
        self.n_bits = n_bits
        self.clock_speed_ghz = clock_speed_ghz
        self.parallel_chains = parallel_chains
        self.ns_per_cycle = 1.0 / clock_speed_ghz
        self.device = device

    def estimate_hardware_time(self, n_samples: int, n_sweeps_per_sample: int) -> dict:
        time_per_sweep_ns = self.n_bits * self.ns_per_cycle
        time_per_sample_ns = n_sweeps_per_sample * time_per_sweep_ns
        batches_needed = int(np.ceil(n_samples / self.parallel_chains))
        total_time_ns = batches_needed * time_per_sample_ns
        return {
            "time_per_sweep_ns": time_per_sweep_ns,
            "time_per_sample_ns": time_per_sample_ns,
            "batches_needed": batches_needed,
            "total_time_ns": total_time_ns,
            "total_time_us": total_time_ns / 1e3,
            "total_time_ms": total_time_ns / 1e6,
            "total_time_s": total_time_ns / 1e9,
            "speedup_vs_classical": None,
        }

    def sample_parallel(self, coupling: np.ndarray, n_samples: int, temperature: float = 1.0,
                        seed=None) -> Tuple[np.ndarray, dict]:
        """Sample with chains in parallel; returns (samples, timing).
        ``seed``: an int or a CPU ``torch.Generator``."""
        from tsu_tpu_torch.config import GibbsConfig
        from tsu_tpu_torch.samplers.gibbs import GibbsSampler

        n_chains = min(self.parallel_chains, n_samples, 1024)
        config = GibbsConfig(temperature=temperature, n_chains=n_chains,
                             update_order="checkerboard")
        sampler = GibbsSampler(config, seed=seed, device=self.device)
        samples = sampler.sample_boltzmann(coupling, n_samples=n_samples)
        return samples, self.estimate_hardware_time(n_samples, config.n_sweeps)
