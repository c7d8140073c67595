"""Entry driver: one ``pt_ground_state_search`` a call, on a fresh ±J bond
realization.

A call's bonds are drawn on its device from the call's seed (each bond +1
or -1 with probability 1/2), and the search runs the configuration's
ladder (geomspace(T_min, T_max, rungs)), copies, Houdayer cadence,
iterations and quench, seeded by the call's seed, without a checkpoint
path. The reference replays the search from the same seed and bonds.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import pt_search as reference


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
        gen = torch.Generator(device=self.device).manual_seed(seed)
        bonds = torch.randint(0, 2, (2, *self.shape), generator=gen, device=self.device)
        Jh, Jv = (2.0 * bonds - 1.0).to(torch.float32)
        p = self._params(warmup)
        return {"seed": seed, "Jh": Jh, "Jv": Jv, "params": {
            "temperatures": np.geomspace(*p["ladder"]), "n_iters": p["n_iters"],
            "n_sweeps": p["n_sweeps"], "n_copies": p["n_copies"],
            "houdayer_every": p["houdayer_every"], "quench_sweeps": p["quench_sweeps"]}}

    def work(self) -> dict:
        p = self._params()
        return {"sweeps": p["n_iters"] * p["n_sweeps"] + p["quench_sweeps"],
                "lattices": p["ladder"][2] * p["n_copies"],
                "sites": self.shape[0] * self.shape[1]}

    def call(self, inputs: dict) -> dict:
        from tsu_tpu_torch.samplers import pt_ground_state_search

        return pt_ground_state_search(inputs["seed"], inputs["Jh"], inputs["Jv"],
                                      device=self.device, **inputs["params"])

    def reference(self, inputs: dict, bits: int | None = None) -> dict:
        return reference.pt_search(inputs["seed"], inputs["Jh"], inputs["Jv"],
                                   bits=bits or self.config["heat_bath_bits"],
                                   device=self.device, **inputs["params"])

    def as_output(self, ref: dict) -> dict:
        """A reference result in the shape of the entry's answer (the
        control stands in the program's place)."""
        return {"best_state": ref["best_state"], "best_energy": ref["best_energy"],
                "pair_attempts": ref["pair_attempts"],
                "pair_acceptance": ref["pair_accepts"] / np.maximum(ref["pair_attempts"], 1)}

    def compare(self, output: dict, ref: dict) -> dict:
        return reference.gaps(output, ref)
