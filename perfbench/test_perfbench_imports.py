"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program. Top-level module names are compared
whole: ``tsu_tpu_torch`` begins with ``tsu_tpu``."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "tsu_tpu"}
FILES = sorted(p for p in run.HERE.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path: Path) -> set:
    """Every module name the file imports, as written."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(run.HERE)))
def test_no_jax_in_sources(path):
    assert not {n.split(".")[0] for n in imported(path)} & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in FILES if p.parent.name == "reference"],
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {n.split(".")[0] for n in imported(path)}
    assert "tsu_tpu_torch" not in tops
    assert all(n.startswith("perfbench.reference") for n in imported(path)
               if n.split(".")[0] == "perfbench")


RUN_DRIVERS = """
import sys
from perfbench import run
from perfbench.conftest import toy
for name in ("ferro4096-observables", "ea256-pt-houdayer"):
    assert run.measure(toy(name), 7, 0.1, False, "cpu", require_card=False)["correct"]
print(",".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_jax_loaded_by_the_drivers():
    """A toy run of each driver, the reference's check included, in a fresh
    process; then ``sys.modules``."""
    env = {**os.environ, "PYTHONPATH": str(run.ROOT)}
    proc = subprocess.run([sys.executable, "-c", RUN_DRIVERS], cwd=run.ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(proc.stdout.strip().splitlines()[-1].split(","))
    assert "tsu_tpu_torch" in loaded and not loaded & FORBIDDEN
