"""Annealed SMC with the particle population sharded over the chains axis.

Counterpart of ``tsu_tpu/parallel/smc_sharded.py``, on the port's
single-controller :class:`~tsu_tpu_torch.parallel.mesh.Mesh`: one process
drives every shard. Each shard reweights and moves its own particles on its
mesh device; the log-weights are gathered on the first shard's device to
decide the ESS test, the log-Z increment and the systematic resampling
indices over all P particles, and the resampled rows go back to their
shards. A particle's move draws are keyed by its global index (one (n_moves,
P, dim) block per step, each shard taking its rows), so a sharded run equals
:func:`~tsu_tpu_torch.samplers.smc.annealed_smc` at one seed bit for bit;
the reference folds the shard index into the move key and agrees only
within Monte-Carlo error. The step is ``samplers/smc.py``'s, which runs as
a CUDA graph when every shard is on one card.
"""

from __future__ import annotations

import numpy as np

from tsu_tpu_torch.energy import EnergyFn
from tsu_tpu_torch.rng import device_generator
from tsu_tpu_torch.samplers.loop import Draws, as_states
from tsu_tpu_torch.samplers.smc import run_smc


def annealed_smc_sharded(mesh, seed, particles, *, energy_fn: EnergyFn, n_steps: int = 50,
                         n_moves: int = 5, dt: float = 0.05, friction: float = 1.0,
                         temperature: float = 1.0, base_sigma: float = 3.0,
                         ess_threshold: float = 0.5, axis: str = "chains") -> dict:
    """Sharded annealed SMC; mirrors :func:`tsu_tpu_torch.samplers.smc.annealed_smc`.

    Args:
        mesh: a Mesh whose ``axis`` holds the particle shards (the other
            axes of size 1).
        seed: an int or a CPU ``torch.Generator``; the run's generator lives
            on the first shard's device.
        particles: (P, dim) initial particles ~ N(0, base_sigma^2); P must
            be divisible by the axis size.
        friction: accepted for the reference's signature; unused.
    Returns:
        dict with (host-resident) particles, log_weights, log_Z (a float),
        ess_history and route.
    """
    if axis != "chains" or mesh.size != mesh.shape["chains"]:
        raise ValueError(f"annealed_smc_sharded shards particles over the chains axis alone, "
                         f"got axis {axis!r} on {mesh}")
    devices = list(mesh.devices.reshape(-1))
    particles = as_states(particles, "cpu")
    P = particles.shape[0]
    if P % len(devices):
        raise ValueError(f"P={P} particles do not divide over {len(devices)} shards")
    rows = P // len(devices)
    shards = [particles[s * rows:(s + 1) * rows].to(d) for s, d in enumerate(devices)]
    out = run_smc(Draws(device_generator(seed, devices[0])), shards, energy_fn=energy_fn,
                  n_steps=n_steps, n_moves=n_moves, dt=dt, temperature=temperature,
                  base_sigma=base_sigma, ess_threshold=ess_threshold)
    return {"particles": np.concatenate([x.cpu().numpy() for x in out["particles"]]),
            "log_weights": np.concatenate([w.cpu().numpy() for w in out["log_weights"]]),
            "log_Z": float(out["log_Z"]), "ess_history": out["ess_history"].cpu().numpy(),
            "route": out["route"]}
