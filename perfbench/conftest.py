"""Fixtures of the benchmark's own tests (``python -m pytest perfbench``)."""

from __future__ import annotations

import copy

import pytest
import torch

from perfbench import run


@pytest.fixture
def card() -> torch.device:
    """The card, for tests marked ``gpu``; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


TOY = {
    "ferro4096-observables": ({"shape": [16, 16]}, {"call": {"n_samples": 12}}),
    "ea256-pt-houdayer": ({"shape": [16, 16], "ladder": [0.4, 2.0, 8], "n_iters": 40,
                           "quench_sweeps": 8}, {"warmup": {"n_iters": 10}}),
}


def toy(name: str) -> run.Cell:
    """The cell ``name`` of BENCHMARK.json at a size the CPU runs in
    seconds: its lattice, ladder and calls cut, all else as committed."""
    cell = copy.deepcopy(run.find_cell(run.ROOT, name))
    config, mix = TOY[name]
    cell.config.update(config)
    cell.mix.update(mix)
    return cell


@pytest.fixture(params=sorted(TOY))
def toy_cell(request) -> run.Cell:
    return toy(request.param)
