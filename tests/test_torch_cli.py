"""The port's command line (``tsu_tpu_torch/cli.py``) against the JAX
package's (``tsu_tpu/cli.py``), on the CPU.

Every test of ``tests/test_cli.py`` runs on the port with ``--device cpu``
and the same bounds. On the same flags both CLIs must print the same JSON
keys and the same line formats (numbers masked). Without ``--device`` and
without CUDA every subcommand raises ``ConfigurationError``.
"""

import json
import os
import re

import pytest
import torch

from tsu_tpu.cli import main as jax_main
from tsu_tpu_torch.cli import main
from tsu_tpu_torch.config import ConfigurationError

CPU = ["--device", "cpu"]


def test_version(capsys):
    assert main(["version"] + CPU) == 0
    out = capsys.readouterr().out
    assert "tsu_tpu_torch" in out and "backend" in out and "torch" in out


def test_sample_moments(capsys):
    assert main(["sample", "--n", "2000", "--mu", "1.0", "--sigma", "2.0",
                 "--seed", "0"] + CPU) == 0
    res = json.loads(capsys.readouterr().out)
    assert abs(res["sample_mean"] - 1.0) < 0.3
    assert abs(res["sample_std"] - 2.0) < 0.5


def test_ising_sweep_orders_below_tc(capsys):
    assert main(["ising-sweep", "--size", "8", "--t-min", "1.0",
                 "--t-max", "4.0", "--n-temps", "3",
                 "--n-samples", "20"] + CPU) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "T=" in ln]
    assert len(lines) == 3
    m_cold = float(lines[0].split("|M|=")[1].split()[0])
    assert m_cold > 0.9


def test_bnn_trains(capsys):
    assert main(["bnn", "--n-train", "40", "--epochs", "30"] + CPU) == 0
    out = capsys.readouterr().out
    assert out.count("pred=") == 9


def test_anneal_ferromagnet_exact(capsys):
    assert main(["anneal", "--size", "8", "--steps", "200",
                 "--restarts", "1"] + CPU) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["energy_per_site"] == -2.0  # periodic ferromagnet ground state


def test_anneal_spin_glass(capsys):
    assert main(["anneal", "--size", "8", "--steps", "200",
                 "--spin-glass"] + CPU) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["model"] == "ea_pm1_spin_glass"
    assert res["energy_per_site"] < -1.2


def test_no_command_prints_help(capsys):
    assert main([]) == 1
    assert "usage" in capsys.readouterr().out.lower()


def test_anneal_spin_glass_checkpoint_resume(capsys, tmp_path):
    """A search resumed from its snapshot prints what the uninterrupted one
    prints, bit for bit."""
    ck = str(tmp_path / "ck")
    args = ["anneal", "--spin-glass", "--size", "12", "--steps", "40",
            "--restarts", "3", "--seed", "3"] + CPU
    assert main(args) == 0
    full = capsys.readouterr().out.strip().splitlines()[-1]
    # Partial run: 1 restart, checkpointed.
    assert main(args[:6] + ["--restarts", "1", "--seed", "3", "--checkpoint", ck] + CPU) == 0
    capsys.readouterr()
    # Resume to 3 restarts: must reproduce the uninterrupted result.
    assert main(args + ["--checkpoint", ck, "--resume"]) == 0
    resumed = capsys.readouterr().out.strip().splitlines()[-1]
    assert resumed == full


def test_anneal_ferromagnet_rejects_checkpoint(capsys, tmp_path):
    rc = main(["anneal", "--size", "8", "--steps", "10",
               "--checkpoint", str(tmp_path / "nope")] + CPU)
    assert rc == 2
    assert "spin-glass" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "nope")


def test_runner_resume_skips_completed_suites(tmp_path, capsys):
    from tsu_tpu_torch.benchmarks.runner import BenchmarkRunner

    fake = {"seed": 0, "quick": True,
            "suites": {"sampling": [{"name": "fake_row"}],
                       "optimization": [], "ml": [], "comparison": []}}
    with open(tmp_path / "benchmark_partial.json", "w") as f:
        json.dump(fake, f)
    runner = BenchmarkRunner(seed=0, output_dir=str(tmp_path), device="cpu")
    out = runner.run_all(quick=True, save_results=True, resume=True)
    # Every suite came from the partial file; nothing re-ran.
    assert out["suites"]["sampling"] == [{"name": "fake_row"}]
    assert not os.path.exists(tmp_path / "benchmark_partial.json")
    assert os.path.exists(tmp_path / "benchmark_results.json")


def test_bench_resume_through_the_cli(tmp_path, capsys):
    fake = {"seed": 0, "quick": True,
            "suites": {"sampling": [{"name": "fake_row"}],
                       "optimization": [], "ml": [], "comparison": []}}
    with open(tmp_path / "benchmark_partial.json", "w") as f:
        json.dump(fake, f)
    assert main(["bench", "--quick", "--resume", "--output-dir", str(tmp_path)] + CPU) == 0
    with open(tmp_path / "benchmark_results.json") as f:
        assert json.load(f)["suites"]["sampling"] == [{"name": "fake_row"}]


NUMBER = re.compile(r"[-+]?\d+(\.\d+)?(e[-+]?\d+)?")


def _skeleton(text: str) -> list:
    """Each output line: a JSON line's keys and value types, another line
    with its numbers masked."""
    out = []
    for line in text.strip().splitlines():
        if line.startswith("{"):
            obj = json.loads(line)
            out.append({k: type(v).__name__ for k, v in obj.items()})
        else:
            out.append(NUMBER.sub("#", line))
    return out


@pytest.mark.parametrize("argv", [
    ["sample", "--n", "200", "--chains", "4", "--seed", "1"],
    ["ising-sweep", "--size", "8", "--n-temps", "3", "--n-samples", "10"],
    ["bnn", "--n-train", "20", "--epochs", "5"],
    ["anneal", "--size", "8", "--steps", "50", "--restarts", "1"],
    ["anneal", "--size", "8", "--steps", "50", "--spin-glass", "--restarts", "1"],
], ids=["sample", "ising-sweep", "bnn", "anneal", "anneal-spin-glass"])
def test_output_formats_equal_the_jax_cli(argv, capsys):
    assert jax_main(argv) == 0
    ref = _skeleton(capsys.readouterr().out)
    assert main(argv + CPU) == 0
    ours = _skeleton(capsys.readouterr().out)
    assert ours == ref


def test_anneal_refusal_equals_the_jax_cli(capsys, tmp_path):
    argv = ["anneal", "--size", "8", "--steps", "10", "--checkpoint", str(tmp_path / "x")]
    assert jax_main(argv) == 2
    ref = capsys.readouterr().err
    assert main(argv + CPU) == 2
    assert capsys.readouterr().err == ref


@pytest.mark.parametrize("argv", [
    ["version"], ["sample"], ["bench", "--quick", "--no-save"], ["ising-sweep"], ["bnn"],
    ["anneal"], ["anneal", "--spin-glass"],
], ids=lambda a: "-".join(a))
def test_without_cuda_every_subcommand_refuses_the_cpu(argv, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigurationError, match="CUDA is not available"):
        main(argv)
    assert capsys.readouterr().out == ""
