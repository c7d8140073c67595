"""The port's checkpoint module: round trips of a flat state in both
formats, the step subdirectory, the atomic write, and a resumed sweep loop
(mirrors tests/test_aux.py's checkpoint tests)."""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from tsu_tpu_torch.checkpoint import (  # noqa: E402
    checkpoint_exists,
    checkpoint_file,
    restore_state,
    save_state,
)
from tsu_tpu_torch.ops.checkerboard import checkerboard_sweeps  # noqa: E402


def _state():
    gen = torch.Generator().manual_seed(3)
    torch.rand(5, generator=gen)
    return {
        "lattice": torch.ones((8, 8)),
        "key": np.array([1, 2], dtype=np.uint32),
        "step": 7,
        "ladder": torch.linspace(0.5, 4.0, 5, dtype=torch.float64),
        "energy": -12.5,
        "generator": gen.get_state(),
    }


def _example():
    return {"lattice": torch.zeros((8, 8)), "key": np.zeros(2, np.uint32), "step": 0,
            "ladder": torch.zeros(5, dtype=torch.float64), "energy": 0.0,
            "generator": torch.Generator().get_state()}


@pytest.mark.parametrize("name", ["ckpt", "ckpt.npz"])
def test_roundtrip_flat_state(tmp_path, name):
    state = _state()
    p = save_state(str(tmp_path / name), state)
    assert p == str(tmp_path / name) and os.path.isfile(p)
    restored = restore_state(p, _example())
    assert torch.equal(restored["lattice"], state["lattice"])
    assert restored["key"].dtype == np.uint32 and np.array_equal(restored["key"], state["key"])
    assert restored["step"] == 7 and isinstance(restored["step"], int)
    assert restored["energy"] == -12.5
    assert torch.equal(restored["ladder"], state["ladder"])
    gen = torch.Generator()
    gen.set_state(restored["generator"])
    ref = torch.Generator().manual_seed(3)
    torch.rand(5, generator=ref)
    assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=ref))


@pytest.mark.parametrize("name,want", [("run", "run/12"), ("run.npz", "run/12.npz")])
def test_step_subdirectory(tmp_path, name, want):
    p = save_state(str(tmp_path / name), {"step": 12}, step=12)
    assert p == str(tmp_path / want) == checkpoint_file(str(tmp_path / name), 12)
    assert checkpoint_exists(str(tmp_path / name), 12)
    assert not checkpoint_exists(str(tmp_path / name))
    assert restore_state(str(tmp_path / name), {"step": 0}, step=12)["step"] == 12


def test_a_failed_write_leaves_the_old_checkpoint(tmp_path):
    p = str(tmp_path / "ck")
    save_state(p, {"step": 1})
    with pytest.raises(TypeError):
        save_state(p, {"step": 2, "bad": object()})
    assert restore_state(p, {"step": 0})["step"] == 1
    assert sorted(os.listdir(tmp_path)) == ["ck"]


def test_missing_key_raises(tmp_path):
    p = save_state(str(tmp_path / "ck"), {"a": 1})
    with pytest.raises(KeyError):
        restore_state(p, {"a": 0, "b": 0})


def test_resume_continues_sampling(tmp_path):
    """Save mid-run, restore, continue: the canonical resume flow, equal to
    the uninterrupted run."""
    lat = torch.ones((8, 8))
    mid = checkerboard_sweeps(torch.Generator().manual_seed(0), lat, 2.0, 5)
    p = save_state(str(tmp_path / "mid"), {"lattice": mid, "sweep": 5})
    restored = restore_state(p, {"lattice": torch.zeros((8, 8)), "sweep": 0})
    assert restored["sweep"] == 5
    lat2 = checkerboard_sweeps(torch.Generator().manual_seed(1), restored["lattice"], 2.0, 5)
    assert torch.equal(lat2, checkerboard_sweeps(torch.Generator().manual_seed(1), mid, 2.0, 5))
    assert set(torch.unique(lat2).tolist()) <= {-1.0, 1.0}
