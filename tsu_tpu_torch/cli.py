"""Command-line interface of the port: ``python -m tsu_tpu_torch.cli`` or
``tsu-tpu-torch``.

Counterpart of ``tsu_tpu/cli.py``: the same subcommands (``sample``,
``bench``, ``ising-sweep``, ``bnn``, ``anneal``, ``version``), flags,
defaults, output lines and JSON keys. Each subcommand also takes
``--device`` (default the card, ``cuda``; ``--device cpu`` runs the plain
PyTorch versions), the port's counterpart of ``JAX_PLATFORMS``. Without a
card and without ``--device cpu`` every subcommand raises
``ConfigurationError``; nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np
import torch


def _cmd_sample(args, dev):
    from tsu_tpu_torch import ThermalSamplingUnit, TSUConfig

    tsu = ThermalSamplingUnit(
        TSUConfig(n_chains=args.chains, n_burnin=300, n_steps=200, dt=0.1),
        seed=args.seed, device=dev,
    )
    s = tsu.sample_gaussian(args.mu, args.sigma, args.n)
    print(json.dumps({
        "n": args.n, "mu": args.mu, "sigma": args.sigma,
        "sample_mean": float(np.mean(s)), "sample_std": float(np.std(s)),
    }))


def _cmd_bench(args, dev):
    from tsu_tpu_torch.benchmarks.runner import BenchmarkRunner

    BenchmarkRunner(seed=args.seed, output_dir=args.output_dir, device=dev).run_all(
        quick=args.quick, save_results=not args.no_save, resume=args.resume
    )


def _cmd_ising_sweep(args, dev):
    from tsu_tpu_torch.models.ising import demonstrate_phase_transition

    temps = np.linspace(args.t_min, args.t_max, args.n_temps)
    res = demonstrate_phase_transition(
        sizes=[args.size], temperatures=temps, n_samples=args.n_samples,
        seed=args.seed, device=dev,
    )
    for T, m, chi in zip(temps, res[args.size]["magnetization"],
                         res[args.size]["susceptibility"]):
        print(f"T={T:6.3f}  |M|={m:7.4f}  chi={chi:9.4f}")


def _cmd_bnn(args, dev):
    from tsu_tpu_torch import BayesianRegressor

    rng = np.random.default_rng(args.seed)
    x = rng.uniform(-1, 1, (args.n_train, 1)).astype(np.float32)
    y = (np.sin(3 * x) + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
    reg = BayesianRegressor(1, [32, 32], temperature=0.2, seed=args.seed, device=dev)
    reg.fit(x, y, n_epochs=args.epochs, learning_rate=0.01, kl_weight=1e-4)
    x_test = np.linspace(-1, 1, 9)[:, None].astype(np.float32)
    mean, lo, hi = reg.predict_with_interval(x_test)
    for xi, m, l, h in zip(x_test.ravel(), mean.ravel(), lo.ravel(), hi.ravel()):
        print(f"x={xi:+.2f}  pred={m:+.3f}  [{l:+.3f}, {h:+.3f}]")


def _cmd_anneal(args, dev):
    if args.spin_glass:
        from tsu_tpu_torch.samplers.annealing import anneal_spin_glass

        # The bonds, then every restart's draws, come from one CPU generator
        # seeded by --seed (the reference draws the bonds with jax.random).
        gen = torch.Generator().manual_seed(args.seed)
        shape = (args.size, args.size)
        Jh, Jv = (torch.where(torch.rand(shape, generator=gen) < 0.5, 1.0, -1.0)
                  for _ in range(2))
        _, e = anneal_spin_glass(
            gen, Jh, Jv, n_steps=args.steps, n_restarts=args.restarts,
            checkpoint_path=args.checkpoint, resume=args.resume, device=dev,
        )
        model = "ea_pm1_spin_glass"
    else:
        if args.checkpoint or args.resume:
            print("error: --checkpoint/--resume apply to --spin-glass "
                  "anneals (the ferromagnet anneal is a single sub-second "
                  "launch with nothing to resume)", file=sys.stderr)
            return 2
        from tsu_tpu_torch.samplers.annealing import anneal_lattice

        _, e = anneal_lattice(args.seed, (args.size, args.size), n_steps=args.steps,
                              n_chains=args.restarts, device=dev)
        model = "ferromagnet"
    n = args.size * args.size
    print(json.dumps({
        "model": model, "size": args.size, "n_steps": args.steps,
        "best_energy": float(e), "energy_per_site": float(e) / n,
    }))


def _cmd_version(args, dev):
    import tsu_tpu_torch

    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "none"
    print(f"tsu_tpu_torch {tsu_tpu_torch.__version__} "
          f"(torch {torch.__version__}, CUDA {torch.version.cuda}, backend {dev.type}, "
          f"card {card}, {torch.cuda.device_count()} device(s))")


def main(argv: Optional[list] = None) -> int:
    from tsu_tpu_torch.config import resolve_device

    parser = argparse.ArgumentParser(
        prog="tsu-tpu-torch",
        description="probabilistic inference engine, PyTorch and CUDA port",
    )
    device = argparse.ArgumentParser(add_help=False)
    device.add_argument("--device", default=None,
                        help="torch device to run on (default the card, cuda; cpu runs the "
                             "plain PyTorch versions)")
    sub = parser.add_subparsers(dest="command")

    def command(name, help_, fn):
        p = sub.add_parser(name, help=help_, parents=[device])
        p.set_defaults(fn=fn)
        return p

    p = command("sample", "sample a Gaussian via the Langevin engine", _cmd_sample)
    p.add_argument("--n", type=int, default=1000)
    p.add_argument("--mu", type=float, default=0.0)
    p.add_argument("--sigma", type=float, default=1.0)
    p.add_argument("--chains", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)

    p = command("bench", "run the benchmark suite", _cmd_bench)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-dir", default="visual_output")
    p.add_argument("--no-save", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="continue a preempted run at the suite boundary "
                        "(benchmark_partial.json)")

    p = command("ising-sweep", "phase-transition temperature sweep", _cmd_ising_sweep)
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--t-min", type=float, default=0.5)
    p.add_argument("--t-max", type=float, default=4.0)
    p.add_argument("--n-temps", type=int, default=10)
    p.add_argument("--n-samples", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)

    p = command("bnn", "train a small Bayesian regressor", _cmd_bnn)
    p.add_argument("--n-train", type=int, default=100)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)

    p = command("anneal", "lattice ground-state search (ferromagnet or +-J spin glass)",
                _cmd_anneal)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--restarts", type=int, default=2,
                   help="independent chains/restarts (best energy kept)")
    p.add_argument("--checkpoint", default=None,
                   help="snapshot path: save search state after every "
                        "restart (spin-glass mode)")
    p.add_argument("--resume", action="store_true",
                   help="continue from --checkpoint, skipping finished "
                        "restarts (bit-identical to the uninterrupted run)")
    p.add_argument("--spin-glass", action="store_true",
                   help="random +-J Edwards-Anderson bonds instead of uniform J")
    p.add_argument("--seed", type=int, default=0)

    command("version", "show version and device info", _cmd_version)

    args = parser.parse_args(argv)
    if not getattr(args, "fn", None):
        parser.print_help()
        return 1
    rc = args.fn(args, resolve_device(args.device))
    return 0 if rc is None else rc


if __name__ == "__main__":
    sys.exit(main())
