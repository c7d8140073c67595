"""The CUDA fused-sweep kernel against its plain PyTorch version, on the card.

Marked ``gpu``: without CUDA every test skips. On a machine with an NVIDIA
Hopper card and nvcc, run ``python -m pytest -m gpu tests/test_torch_gpu.py``;
the first test builds the kernel into build/tsu_tpu_torch/.
"""

import numpy as np
import pytest
import torch

from tsu_tpu_torch import IsingConfig, IsingGrid
from tsu_tpu_torch.ops.checkerboard import split_checkerboard
from tsu_tpu_torch.ops.checkerboard_fused import (
    fused_sweep,
    fused_sweep_reference,
    sigmoid_table16,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _black(seed, R, C, dtype, device):
    rng = np.random.default_rng(seed)
    lat = torch.as_tensor(np.where(rng.random((R, C)) < 0.5, 1.0, -1.0), dtype=dtype)
    return split_checkerboard(lat)[1].contiguous().to(device)


def _sweeps_both_ways(black, temps, periodic, injected, seed=0):
    """Run the kernel and the plain version side by side, sweep by sweep,
    from the same input; returns the max number of differing sites."""
    rng = np.random.default_rng(seed)
    R, C2 = black.shape
    b_k = b_r = black
    worst = 0
    for k, T in enumerate(temps):
        table = sigmoid_table16(1.0, 0.1, T).to(black.device)
        U = None
        if injected:
            U = torch.as_tensor(rng.integers(0, 1 << 16, (2, R, C2)),
                                dtype=torch.int32, device=black.device)
        r_k, b_k = fused_sweep(b_k, table, seed=seed, sweep=k, periodic=periodic, uniforms=U)
        r_r, b_r = fused_sweep_reference(b_r, table, seed=seed, sweep=k,
                                         periodic=periodic, uniforms=U)
        worst = max(worst, int((r_k != r_r).sum()), int((b_k != b_r).sum()))
    torch.cuda.synchronize()
    return worst


@pytest.mark.parametrize("shape,dtype,periodic", [
    ((64, 64), torch.bfloat16, True),
    ((18, 20), torch.float32, False),     # R % 8 != 0
    ((34, 522), torch.bfloat16, False),   # C/2 odd and wider than one tile
])
@pytest.mark.parametrize("injected", [True, False])
def test_kernel_matches_plain_version(cuda, shape, dtype, periodic, injected):
    black = _black(1, *shape, dtype, cuda)
    assert _sweeps_both_ways(black, [2.269, 4.0, 0.5], periodic, injected) == 0


def test_launch_counter_counts_kernel_launches(cuda):
    black = _black(2, 16, 16, torch.float32, cuda)
    table = sigmoid_table16(1.0, 0.0, 2.0).to(cuda)
    before = fused_sweep.launches
    fused_sweep(black, table)
    fused_sweep(black, table, sweep=1)
    assert fused_sweep.launches == before + 2


def test_kernel_rejects_mismatched_devices(cuda):
    black = _black(3, 16, 16, torch.float32, cuda)
    with pytest.raises(ValueError):
        fused_sweep(black, sigmoid_table16(1.0, 0.0, 2.0))   # table on the CPU


def test_grid_on_cuda_equals_grid_on_cpu(cuda):
    """Kernel and plain version agree bit for bit, and host randomness comes
    from a CPU generator, so a seed gives the same samples on both devices."""
    cfg = IsingConfig(n_burnin=20, n_sweeps=2)
    a = IsingGrid((32, 24), periodic=True, seed=5, config=cfg, device=cuda).sample(
        n_samples=3, temperature=2.269)
    b = IsingGrid((32, 24), periodic=True, seed=5, config=cfg, device="cpu").sample(
        n_samples=3, temperature=2.269)
    np.testing.assert_array_equal(a, b)
