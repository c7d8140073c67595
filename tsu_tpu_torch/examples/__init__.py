"""The repository's examples on the port, one module per script of
``examples/``:

    python3 -m tsu_tpu_torch.examples.<name> [--device cuda|cpu]

Each runs on the card by default and raises without CUDA; ``--device cpu``
runs the plain PyTorch versions. Each module's ``main`` takes its sizes and
``device`` as keyword arguments (the defaults are the script's sizes),
prints what the script prints and returns its numbers, ``"line"`` being
its result line, so that the tests run it small on the CPU and
``chip_smoke.py`` at its defaults on the card. Seeds are ints or CPU
``torch.Generator``s where the scripts pass JAX keys.
"""

from __future__ import annotations

import argparse
import inspect

NAMES = ("checkpoint_resume", "spin_glass_ground_state", "large_scale_maxcut", "quickstart",
         "api_tour", "bayesian_nn_demo", "hardware_projection")


def cli(main, doc: str, argv=None) -> dict:
    """Parse ``--device`` and one flag per other keyword of ``main`` (its
    default the keyword's), then call ``main`` with them."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    for name, p in inspect.signature(main).parameters.items():
        if name != "device":
            ap.add_argument(f"--{name.replace('_', '-')}", type=type(p.default),
                            default=p.default)
    return main(**vars(ap.parse_args(argv)))
