"""The port covers the JAX package: every public function and class defined
in a module of ``tsu_tpu`` has a same-named counterpart in the matching
module of ``tsu_tpu_torch`` that accepts its parameters, or stands in
EXCLUDED or NOT_TAKEN below with its reason.

One case per module of ``tsu_tpu`` (found by walking its ``.py`` files, so a
new module is a new case). A module's public names are the functions and
classes its source defines whose names do not start with ``_``; a class's
are its constructor and its public methods; each name of a module's
``__all__`` must be importable from the counterpart too. A parameter is
accepted when the counterpart takes it by that name, or takes ``**kwargs``.
Both lists are exact: an entry that no longer names a gap fails too.
"""

import ast
import importlib
import inspect
from pathlib import Path

import pytest

pytest.importorskip("jax")

REFERENCE = Path(__file__).resolve().parents[1] / "tsu_tpu"

_JAX_KEYS = "JAX PRNG keys; the port seeds with ints and torch.Generators"
_TPU_SPEC = "a TPU figure; the port's TPUHardwareSpec is an alias of GPUHardwareSpec"

# Parts of the JAX package with no counterpart: a module path, or
# "module:name" for one function or class, with the reason.
EXCLUDED = {
    "ops.checkerboard_pallas": "Pallas TPU kernels: their CUDA counterparts are wrapped in "
                               "ops/checkerboard_kernel.py (K3)",
    "ops.checkerboard_bonds_pallas": "Pallas TPU kernels: their CUDA counterparts are wrapped "
                                     "in ops/checkerboard_bonds_kernel.py (K4, K5)",
    "ops.checkerboard_fused:fused_sweep_pallas": "the Pallas entry of the fused sweep: the "
                                                 "port's is fused_sweep (K1)",
    "ops.checkerboard_resident:resident_fits": "guards a TPU (Mosaic) miscompile that the CUDA "
                                               "kernel does not have",
    "profiling:enable_compilation_cache": "XLA's compilation cache; the port's kernels are "
                                          "built once into build/ by a hash of their source",
    "rng:as_key": _JAX_KEYS,
    "rng:chain_keys": _JAX_KEYS,
    "rng:fold": _JAX_KEYS,
    "oracle": "a package in the JAX package and one module in the port, which exports all "
              "of its names: oracle.numpy_ref's and oracle.wolff's are checked in "
              "tsu_tpu_torch.oracle",
    "native.libgraph_tools": "a shared object built from graph_tools.cpp, not a module; the "
                             "port builds its own under build/",
}

# Parameters every counterpart may leave out.
NOT_TAKEN_ANYWHERE = {
    "key": _JAX_KEYS,
    "use_pallas": "no XLA route to choose against: a tensor on the card runs the kernel, one "
                  "on the CPU its plain version",
}

# Further parameters that one counterpart does not take ("module:name" or
# "module:Class.method"), with the reason.
NOT_TAKEN = {
    "ops.checkerboard_fused:fused_sweeps": {
        "band_rows": "the TPU kernel's VMEM band; the CUDA kernel picks its own tiles",
        "interpret": "Pallas interpret mode; a CPU tensor runs the plain version"},
    "ops.checkerboard_fused:fused_sweeps_batched": {
        "band_rows": "the TPU kernel's VMEM band; the CUDA kernel picks its own tiles",
        "interpret": "Pallas interpret mode; a CPU tensor runs the plain version"},
    "ops.checkerboard_fused:fused_sweep_batched": {
        name: "the port's fused_sweep_batched is K2's launch wrapper on (blacks, tables, "
              "keys); one batched sweep from seeds and temperatures is "
              "fused_sweeps_batched(..., n_sweeps=1)"
        for name in ("seeds", "reds", "temperatures", "J", "field", "band_rows", "interpret")},
    "models.ml:elbo_loss": {
        "n_mc": "the port takes the draws eps in place of key; their leading axis is n_mc"},
    "models.ml:predict_mc": {
        "n_samples": "the port takes the draws eps in place of key; their leading axis is "
                     "n_samples"},
    "hardware:TPUHardwareSpec": {name: _TPU_SPEC for name in (
        "mxu_bf16_tflops", "vpu_gops", "vmem_bytes", "ici_bandwidth_gbps")},
    "profiling:Timer": {
        "sync_array": "the port synchronises the card on entry and on exit, so there is no "
                      "array to fetch"},
}


def _module_paths():
    """Dotted paths of the JAX package's modules, relative to it ("" is the
    package itself)."""
    out = []
    for path in sorted(REFERENCE.rglob("*.py")):
        parts = path.relative_to(REFERENCE).with_suffix("").parts
        out.append(".".join(p for p in parts if p != "__init__"))
    return out


MODULES = _module_paths()
ORACLE = "oracle"   # the package whose modules the port merges into one (EXCLUDED says why)


def _port_module_name(mod):
    if mod.split(".")[0] == ORACLE:
        return f"tsu_tpu_torch.{ORACLE}"
    return ".".join(filter(None, ("tsu_tpu_torch", mod)))


def _defined_names(mod):
    """Public functions and classes that the module's source defines."""
    path = REFERENCE / (mod.replace(".", "/") if mod else "")
    source = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    tree = ast.parse(source.read_text())
    return [node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not node.name.startswith("_")]


def _callables(ref, port, name):
    """(label, reference callable, port callable or None): the function, or
    a class's constructor and each public method it defines."""
    if not inspect.isclass(ref):
        return [(name, ref, port)]
    out = [(name, ref, port)]
    for attr, value in vars(ref).items():
        if not attr.startswith("_") and callable(value):
            out.append((f"{name}.{attr}", getattr(ref, attr), getattr(port, attr, None)))
    return out


def _missing_parameters(ref, port):
    try:
        ref_params = inspect.signature(ref).parameters
        port_params = inspect.signature(port).parameters
    except (TypeError, ValueError):   # a builtin without a signature
        return []
    if any(p.kind is p.VAR_KEYWORD for p in port_params.values()):
        return []
    return [name for name, p in ref_params.items()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD) and name not in port_params]


def _gaps(mod):
    """(names with no counterpart, {label: parameters not taken}) of one
    module, before the lists are applied."""
    ref = importlib.import_module(".".join(filter(None, ("tsu_tpu", mod))))
    port = importlib.import_module(_port_module_name(mod))
    missing = [n for n in getattr(ref, "__all__", ()) if not hasattr(port, n)]
    params = {}
    for name in _defined_names(mod):
        if not hasattr(port, name):
            missing.append(name)
            continue
        for label, r, p in _callables(getattr(ref, name), getattr(port, name), name):
            if p is None:
                missing.append(label)
                continue
            gap = [n for n in _missing_parameters(r, p) if n not in NOT_TAKEN_ANYWHERE]
            if gap:
                params[label] = gap
    return sorted(set(missing)), params


@pytest.mark.parametrize("mod", MODULES, ids=lambda m: m or "tsu_tpu")
def test_every_public_name_has_a_counterpart(mod):
    if mod in EXCLUDED and mod != ORACLE:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(_port_module_name(mod))
        return
    missing, params = _gaps(mod)
    excluded = sorted(k.split(":")[1] for k in EXCLUDED if k.startswith(f"{mod}:"))
    assert missing == excluded, (
        f"tsu_tpu.{mod}: no counterpart in {_port_module_name(mod)} for {missing}; the "
        f"exclusion list names {excluded}")
    allowed = {k.split(":")[1]: sorted(v) for k, v in NOT_TAKEN.items()
               if k.startswith(f"{mod}:")}
    assert {k: sorted(v) for k, v in params.items()} == allowed, (
        f"tsu_tpu.{mod}: parameters not taken {params}; the list names {allowed}")


def test_every_exclusion_names_a_part_of_the_reference():
    """A module entry is a module, a package or another file of the JAX
    package; a name entry is defined in a module walked above."""
    for entry in EXCLUDED:
        mod, _, name = entry.partition(":")
        if name:
            assert mod in MODULES and mod not in EXCLUDED, entry
            assert name in _defined_names(mod), entry
        else:
            base = REFERENCE.joinpath(*mod.split("."))
            assert base.is_dir() or any(base.parent.glob(base.name + ".*")), entry
    for entry in NOT_TAKEN:
        mod, _, name = entry.partition(":")
        assert mod in MODULES and name.split(".")[0] in _defined_names(mod), entry


def test_the_walk_covers_every_module_the_package_imports():
    """The walk is over ``.py`` files; every other module that Python finds
    in the package (the native shared object) is excluded by name."""
    import pkgutil

    import tsu_tpu

    found = {name.removeprefix("tsu_tpu.")
             for _, name, _ in pkgutil.walk_packages(tsu_tpu.__path__, "tsu_tpu.")}
    assert found - set(MODULES) <= set(EXCLUDED)
