"""Hardware performance analysis: the card's roofline against its measured
rate, and the thermodynamic-chip projections.

Counterpart of ``examples/hardware_projection.py``. The roofline model
bounds the fused sweep (K1) on the card this port runs on, at 1024^2,
4096^2 and 16384^2 bf16; the measured rate is K1's through
``fused_sweeps`` in this same run (``tools.bench``'s headline function,
one call of ``sweeps`` sweeps after a warm-up call, about a second on an
H100), printed beside the card's name and power limit. The projections of
a hypothetical thermodynamic chip are kept for parity with the
reference's what-if studies.

Run: python3 -m tsu_tpu_torch.examples.hardware_projection [--device cpu] [--<size> N ...]
"""

from __future__ import annotations

from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.examples import cli
from tsu_tpu_torch.hardware import (
    ConservativeEstimator,
    GPUHardwareSpec,
    HardwarePerformanceEstimator,
    TSUHardwareSpec,
    checkerboard_roofline,
)
from tsu_tpu_torch.tools.bench import headline_rate
from tsu_tpu_torch.tools.timing import card


def main(size: int = 4096, sweeps: int = 10_000, device=None) -> dict:
    device = resolve_device(device)
    on_card = device.type == "cuda"
    # --- The card: where is the speed of light? ----------------------------
    spec = GPUHardwareSpec.from_device(device) if on_card else GPUHardwareSpec()
    print(f"[1] Roofline for the fused checkerboard sweep on {spec.name}")
    rooflines = {}
    for n in (1024, 4096, 16384):
        r = checkerboard_roofline(spec, n, n, dtype_bytes=2)
        rooflines[n] = r
        print(f"    {n}x{n} bf16: {r['flips_per_s_ceiling']:.2e} "
              f"flips/s ceiling ({r['bound']}-bound)")
    measured = headline_rate(size, sweeps, calls=1, n_trials=1, device=device,
                             log=lambda _msg: None)
    if on_card:
        where = card()
        share = measured / checkerboard_roofline(spec, size, size)["flips_per_s_ceiling"]
        line = f"measured {size}^2 on {where}: {measured:.2e} flips/s = {share:.0%} of the ceiling"
    else:
        # The CPU's rate of the plain version is no share of a card's ceiling.
        where, share = "cpu", None
        line = f"measured {size}^2 on the CPU (the plain version): {measured:.2e} flips/s"
    print(f"    {line}")

    # --- Thermodynamic chip: the reference's projection, kept honest --------
    print("\n[2] TSU-chip projections (reference parity, tsu/hardware.py)")
    est = HardwarePerformanceEstimator(TSUHardwareSpec())
    r = est.estimate_sampling_time(n_samples=10_000, dimension=10, emulator_time=2.4)
    cons = ConservativeEstimator().estimate_sampling_time(n_samples=10_000, dimension=10,
                                                          emulator_time=2.4)
    t, t_c = r["hardware_parallel_s"], cons["hardware_parallel_s"]
    print(f"    optimistic: 10k 10-D samples in {t * 1e3:.3f} ms "
          f"({r['realistic_speedup']:.1e}x vs emulator, {r['energy_joules']:.1e} J)")
    print(f"    conservative: {t_c * 1e3:.3f} ms ({t_c / t:.0f}x slower than the optimistic "
          "model)")
    print("    (projections describe a hypothetical chip; the measured rate above is this "
          "run's)")
    return {"rooflines": rooflines, "measured_flips_per_s": measured, "card": where,
            "share_of_ceiling": share, "optimistic_s": t, "conservative_s": t_c, "line": line}


if __name__ == "__main__":
    cli(main, __doc__)
