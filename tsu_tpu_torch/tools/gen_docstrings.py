"""Write the port's public-API docstring reference to a new Markdown file.

Counterpart of ``scripts/gen_docstrings.py``, on the port: every name of
``tsu_tpu_torch.__all__``, then the extended surfaces (the samplers'
lattice entry points, the sharded paths and the runtime, the kernels'
sweep wrappers, checkpoints), each with its signature and the first
paragraph of its docstring, and a class's public methods. It imports the
package and touches no card.

    python -m tsu_tpu_torch.tools.gen_docstrings OUT.md

``OUT.md`` must be a new file: the tool refuses to overwrite one, so it
never writes the JAX package's ``docs/DOCSTRINGS.md``.
"""

from __future__ import annotations

import argparse
import importlib
import inspect

EXTRA_SURFACES = [
    ("tsu_tpu_torch.models.lattice_sampler", ["sample_grid", "sample_grid_ensemble"]),
    ("tsu_tpu_torch.samplers.annealing",
     ["anneal_lattice", "anneal_spin_glass", "simulated_annealing_dense"]),
    ("tsu_tpu_torch.parallel",
     ["make_mesh", "mesh_info", "multihost_initialize", "sharded_checkerboard_sweeps",
      "sharded_lattice_sample", "annealed_smc_sharded"]),
    ("tsu_tpu_torch.parallel.distributed", ["initialize", "backend_for", "exchange"]),
    ("tsu_tpu_torch.samplers.tempering",
     ["parallel_tempering_lattice", "parallel_tempering_bonds"]),
    ("tsu_tpu_torch.parallel.tempering_sharded", ["parallel_tempering_replica_sharded"]),
    ("tsu_tpu_torch.ops.checkerboard_fused", ["fused_sweeps", "fused_sweeps_batched"]),
    ("tsu_tpu_torch.ops.checkerboard_bonds_kernel", ["checkerboard_sweeps_bonds_kernel"]),
    ("tsu_tpu_torch.checkpoint", ["save_state", "restore_state"]),
]


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def _first_para(doc) -> str:
    if not doc:
        return "(no docstring)"
    return inspect.cleandoc(doc).split("\n\n")[0]


def _entry(name: str, obj) -> str:
    lines = [f"### `{name}{_sig(obj) if callable(obj) else ''}`", "",
             _first_para(getattr(obj, "__doc__", None))]
    if inspect.isclass(obj):
        for n, m in inspect.getmembers(obj, inspect.isfunction):
            if not n.startswith("_") and m.__qualname__.startswith(obj.__name__):
                lines += ["", f"- **`.{n}{_sig(m)}`** — {_first_para(m.__doc__).splitlines()[0]}"]
    return "\n".join(lines)


def render() -> str:
    """The reference as Markdown."""
    import tsu_tpu_torch

    out = ["# Public API docstrings of tsu_tpu_torch", "",
           "Generated by `python -m tsu_tpu_torch.tools.gen_docstrings`; do not edit by hand.",
           "The flat namespace (`tsu_tpu_torch.__all__`) first, then the extended surfaces.",
           "", "## Flat namespace (`import tsu_tpu_torch as tsu`)", ""]
    for name in tsu_tpu_torch.__all__:
        out += [_entry(name, getattr(tsu_tpu_torch, name)), ""]
    out += ["## Extended surfaces", ""]
    for mod_name, names in EXTRA_SURFACES:
        mod = importlib.import_module(mod_name)
        out += [f"### module `{mod_name}`", ""]
        for name in names:
            out += [_entry(f"{mod_name.split('.')[-1]}.{name}", getattr(mod, name)), ""]
    return "\n".join(out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="the port's docstring reference")
    parser.add_argument("out", help="a new Markdown file")
    args = parser.parse_args(argv)
    import tsu_tpu_torch

    text = render()
    with open(args.out, "x") as f:
        f.write(text)
    n = len(tsu_tpu_torch.__all__) + sum(len(names) for _, names in EXTRA_SURFACES)
    print(f"wrote {args.out} ({n} symbols)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
