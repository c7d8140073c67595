"""The harness finds a cell, a configuration, a traffic mix and a metric by
name, with no edit to a file it has; its last line holds the contract's
keys; and it refuses to measure without a card."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import run

REPO = run.ROOT
TOY_METRIC = '''"""toy_calls_done: the calls a window completed (a test's metric)."""


def read(run):
    return run.calls
'''
TOY_SILENT = '''"""toy_nothing: a metric that finds nothing to read (a test's)."""


def read(run):
    return None
'''
DRIVE = """
import json, sys
from perfbench import run
cell = run.find_cell(run.ROOT, sys.argv[2])
result = run.measure(cell, 2**31 + 3, 0.2, bool(int(sys.argv[1])), "cpu", require_card=False)
print(json.dumps(result))
print(json.dumps(run.forbidden_modules()))
"""


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def copy_with_toy(tmp_path_factory) -> Path:
    """The benchmark copied, with a toy configuration, mix, two cells and
    two metrics added as files and as entries of BENCHMARK.json; the cells
    are added to the rate's list, as a later cell would be. The cell
    ``toy-silent`` lists a metric that reads nothing."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    before = digest(root / "perfbench")
    here = root / "perfbench"
    config = json.loads((here / "configs" / "ising2d-ferro-L4096.json").read_text())
    (here / "configs" / "toy-ferro-L16.json").write_text(json.dumps(
        {**config, "name": "toy-ferro-L16", "shape": [16, 16]}))
    (here / "traffic" / "observables-8.json").write_text(json.dumps(
        {"driver": "ising_observables", "call": {"n_samples": 8}, "trace_calls": 2,
         "check_calls": 2}))
    (here / "workloads" / "toy-ferro.json").write_text(json.dumps(
        {"name": "toy-ferro", "who": "a test", "limits": {"m_gap_spins": 0, "e_gap": 0}}))
    (here / "workloads" / "toy-silent.json").write_text(json.dumps(
        {"name": "toy-silent", "who": "a test", "limits": {"m_gap_spins": 0, "e_gap": 0}}))
    (here / "metrics" / "toy_calls_done.py").write_text(TOY_METRIC)
    (here / "metrics" / "toy_nothing.py").write_text(TOY_SILENT)
    bench["configs"].append({"name": "toy-ferro-L16", "source": "a test",
                             "file": "perfbench/configs/toy-ferro-L16.json", "reduced": ["shape"],
                             "why": "a test"})
    for name in ("toy-ferro", "toy-silent"):
        bench["workloads"].append({"name": name, "config": "toy-ferro-L16",
                                   "traffic": "observables-8", "chips": 1, "why": "a test"})
    rate = next(m for m in bench["end_to_end"] if m["name"] == "site_updates_per_s")
    rate["workloads"] += ["toy-ferro", "toy-silent"]
    bench["per_layer"].append({"name": "toy_calls_done", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "model",
                               "moves": "site_updates_per_s",
                               "workloads": ["toy-ferro", "toy-silent"]})
    bench["per_layer"].append({"name": "toy_nothing", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "model",
                               "moves": "site_updates_per_s", "workloads": ["toy-silent"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digest(here)
    assert {k: v for k, v in after.items() if k in before} == before
    return root


def drive(root: Path, trace: int, cell: str = "toy-ferro", ok: bool = True):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(root), str(REPO)])}
    proc = subprocess.run([sys.executable, "-c", DRIVE, str(trace), cell], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    if not ok:
        return proc
    assert proc.returncode == 0, proc.stderr[-3000:]
    *_, result, loaded = proc.stdout.strip().splitlines()
    return json.loads(result, object_pairs_hook=list), json.loads(loaded)


@pytest.mark.parametrize("trace", [0, 1])
def test_toy_cell_runs_from_added_files(copy_with_toy, trace):
    pairs, loaded = drive(copy_with_toy, trace)
    keys = [k for k, _ in pairs]
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert keys == want + (["breakdown"] if trace else []) + ["compared"]
    result = dict(pairs)
    assert result["correct"] is True and result["failed"] == 0
    metrics = dict(result["metrics"])
    if trace:
        # The toy metric is found by its name; the device's metrics have
        # nothing to read on the CPU and are left out.
        assert [k for k, _ in result["metrics"]] == ["toy_calls_done"]
        assert dict(metrics["toy_calls_done"])["value"] == result["attempted"] == 2
        assert {"busy_s", "window_s"} <= set(dict(result["device"]))
    else:
        assert set(metrics) == {"site_updates_per_s", "setup_s"}
    assert loaded == []


def test_a_listed_metric_that_reads_nothing_fails_the_run(copy_with_toy):
    """A per-layer metric whose entry names the cell has to read something:
    a renamed kernel or a lost counter fails the run, with no result."""
    proc = drive(copy_with_toy, 1, "toy-silent", ok=False)
    assert proc.returncode != 0
    assert "toy_nothing read nothing in toy-silent" in proc.stderr
    assert "{" not in proc.stdout


def test_refuses_without_a_card():
    """On a machine without CUDA the entry exits non-zero and prints no
    result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                           "ferro4096-observables", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
