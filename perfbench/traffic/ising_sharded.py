"""Entry driver: one ``IsingGrid(...).sample_observables(..., mesh=...,
initial="mesh")`` a call on a lattice sharded by rows over the mesh.

A call builds the configuration's uniform-coupling grid from the call's
seed and asks for the mix's samples at the configuration's temperature on a
mesh of ``mesh_rows`` row shards, one a card (on the CPU, as the tests run
it, several shards of the CPU): a fresh chain from a start drawn on the
cards, its magnetization per spin and energy after each block of sweeps,
and the final state's rows that the check reads (``strip_rows`` rows across
each shard boundary and inside the first shard), copied to the host as
int8. Before it lets the final shards go, the call sums them again with
the reference's plain ``lattice_sums``, on the cards, for the check of the
last sample's magnetization and energy: that sum is part of every timed
call. The call waits for every card of the mesh before it returns: the
harness waits for the first card only. The reference replays those rows'
light cones from the same seed (``reference/ising_sharded.py``); the
samples' magnetization and energy are held to what a lattice of N spins
can give, and the last sample's to the plain sums, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import ising_sharded as reference


class Driver:
    def __init__(self, config: dict, mix: dict, device: torch.device):
        self.shape = tuple(config["shape"])
        self.config, self.mix, self.device = config, mix, device
        n = config["mesh_rows"]
        self.devices = ([torch.device("cuda", i) for i in range(n)] if device.type == "cuda"
                        else [device] * n)
        L, band, k = self.shape[0], self.shape[0] // n, config["strip_rows"]
        # strip_rows rows across each shard boundary (row 0 across the wrap),
        # and strip_rows rows in the middle of the first shard.
        self.first_rows = [(i * band - k // 2) % L for i in range(n)] + [band // 2]
        self.rows = [(f + i) % L for f in self.first_rows for i in range(k)]

    def _params(self, warmup: bool = False) -> dict:
        """The call's settings: the configuration's, then the mix's, then,
        for the warm-up call, the mix's warm-up ones."""
        return {**self.config, **self.mix.get("call", {}),
                **(self.mix.get("warmup", {}) if warmup else {})}

    def inputs(self, seed: int, warmup: bool = False) -> dict:
        return {"seed": seed, **self._params(warmup)}

    def work(self) -> dict:
        p = self._params()
        return {"sweeps": p["n_burnin"] + p["n_samples"] * p["n_sweeps"], "lattices": 1,
                "sites": self.shape[0] * self.shape[1]}

    def call(self, inputs: dict) -> dict:
        from tsu_tpu_torch import IsingConfig, IsingGrid
        from tsu_tpu_torch.parallel import make_mesh

        c = self.config
        grid = IsingGrid(self.shape, coupling_strength=c["J"], periodic=c["periodic"],
                         seed=inputs["seed"], device=self.devices[0],
                         config=IsingConfig(temperature=c["temperature"],
                                            coupling_strength=c["J"],
                                            n_burnin=inputs["n_burnin"],
                                            n_sweeps=inputs["n_sweeps"]))
        out = grid.sample_observables(
            n_samples=inputs["n_samples"], temperature=c["temperature"],
            mesh=make_mesh(rows=c["mesh_rows"], devices=self.devices), initial="mesh",
            final_rows=self.rows, final_shards=True)
        shards = out.pop("final_shards")
        sums = reference.lattice_sums([shards[i, 0] for i in range(c["mesh_rows"])])
        del shards
        if self.device.type == "cuda":
            for d in self.devices:
                torch.cuda.synchronize(d)
        red, black = out["final_rows"]
        return {"magnetization": out["magnetization"], "energy": out["energy"],
                "final_rows": (red.astype(np.int8), black.astype(np.int8)),
                "final_sums": sums}

    def reference(self, inputs: dict, bits: int | None = None) -> dict:
        c = self.config
        return reference.final_rows(
            inputs["seed"], self.shape, self.first_rows, n_rows=c["strip_rows"],
            temperature=c["temperature"], J=c["J"],
            n_sweeps=inputs["n_burnin"] + inputs["n_samples"] * inputs["n_sweeps"],
            bits=bits or c["heat_bath_bits"], device=self.device)

    def as_output(self, ref: dict) -> dict:
        """A reference result in the shape of the entry's answer (the
        control stands in the program's place). The strips hold no
        sample's magnetization or energy, nor the final planes' sums, so
        the control gives none."""
        return {"final_rows": (ref["red"].numpy(), ref["black"].numpy())}

    def compare(self, output: dict, ref: dict) -> dict:
        p = self._params()
        return reference.gaps(output, ref, self.shape[0] * self.shape[1], p["n_samples"],
                              self.config["J"], self.config["field"])
