"""Entry driver: one ``IsingGrid(...).sample_observables(...)`` a call.

A call builds the configuration's uniform-coupling grid from the call's
seed with an explicit ``IsingConfig`` (the configuration's burn-in and
thinning) and asks for the mix's samples at the configuration's temperature: a fresh chain
from a random start, its magnetization per spin and energy after each block
of sweeps. The reference replays the same chain from the same seed.
"""

from __future__ import annotations

import torch

from perfbench.reference import ising as reference


class Driver:
    def __init__(self, config: dict, mix: dict, device: torch.device):
        self.shape = tuple(config["shape"])
        self.config, self.mix, self.device = config, mix, device

    def _params(self, warmup: bool = False) -> dict:
        """The call's settings: the configuration's, then the mix's, then,
        for the warm-up call, the mix's warm-up ones."""
        return {**self.config, **self.mix.get("call", {}),
                **(self.mix.get("warmup", {}) if warmup else {})}

    def inputs(self, seed: int, warmup: bool = False) -> dict:
        return {"seed": seed, **self._params(warmup)}

    def work(self) -> dict:
        p = self._params()
        sites = self.shape[0] * self.shape[1]
        return {"sweeps": p["n_burnin"] + p["n_samples"] * p["n_sweeps"], "lattices": 1,
                "sites": sites}

    def call(self, inputs: dict) -> dict:
        from tsu_tpu_torch import IsingConfig, IsingGrid

        c = self.config
        grid = IsingGrid(self.shape, coupling_strength=c["J"], periodic=c["periodic"],
                         seed=inputs["seed"], device=self.device,
                         config=IsingConfig(temperature=c["temperature"],
                                            coupling_strength=c["J"],
                                            n_burnin=inputs["n_burnin"],
                                            n_sweeps=inputs["n_sweeps"]))
        return grid.sample_observables(n_samples=inputs["n_samples"],
                                       temperature=c["temperature"])

    def reference(self, inputs: dict, bits: int | None = None) -> dict:
        c = self.config
        return reference.sample_observables(
            inputs["seed"], self.shape, temperature=c["temperature"], J=c["J"],
            n_samples=inputs["n_samples"], n_burnin=inputs["n_burnin"],
            n_sweeps=inputs["n_sweeps"], bits=bits or c["heat_bath_bits"], device=self.device)

    def as_output(self, ref: dict) -> dict:
        """A reference result in the shape of the entry's answer (the
        control stands in the program's place)."""
        return {"magnetization": ref["magnetization"], "energy": ref["energy"]}

    def compare(self, output: dict, ref: dict) -> dict:
        return reference.gaps(output, ref)
