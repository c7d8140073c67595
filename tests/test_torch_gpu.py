"""The CUDA kernels (the fused sweep of one lattice and of a batch of
lattices, the bond half-sweep of one lattice and of a batch of replicas)
against their plain PyTorch versions, and the batched and spin-glass paths
on the card against the same paths on the CPU.

Marked ``gpu``: without CUDA every test skips. On a machine with an NVIDIA
Hopper card and nvcc, run ``python -m pytest -m gpu tests/test_torch_gpu.py``;
the first test builds the kernel into build/tsu_tpu_torch/.
"""

import numpy as np
import pytest
import torch

from tsu_tpu_torch import IsingConfig, IsingGrid
from tsu_tpu_torch.models.lattice_sampler import sample_grid_ensemble
from tsu_tpu_torch.ops.checkerboard import split_checkerboard
from tsu_tpu_torch.ops.checkerboard_fused import (
    fused_sweep,
    fused_sweep_batched,
    fused_sweep_batched_reference,
    fused_sweep_reference,
    sigmoid_table16,
)
from tsu_tpu_torch.ops.checkerboard_bonds import color_bond_weights, pack_bond_codes
from tsu_tpu_torch.ops.checkerboard_bonds_kernel import (
    bond_halfsweep,
    bond_halfsweep_batched,
    bond_halfsweep_batched_reference,
    bond_halfsweep_reference,
    bond_sweep_keys,
    continuous_band,
)
from tsu_tpu_torch.ops.checkerboard_fused import sigmoid_table
from tsu_tpu_torch.rng import sweep_keys
from tsu_tpu_torch.samplers import (
    anneal_lattice,
    anneal_spin_glass,
    parallel_tempering_bonds,
    parallel_tempering_lattice,
    pt_ground_state_search,
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


def _blacks(seed, B, R, C, dtype, device):
    rng = np.random.default_rng(seed)
    lat = torch.as_tensor(np.where(rng.random((B, R, C)) < 0.5, 1.0, -1.0), dtype=dtype)
    return split_checkerboard(lat)[1].contiguous().to(device)


@pytest.mark.parametrize("shape,dtype,periodic", [
    ((3, 64, 64), torch.bfloat16, True),
    ((2, 18, 20), torch.float32, False),     # R % 8 != 0
    ((2, 34, 522), torch.bfloat16, False),   # C/2 odd and wider than one tile
])
@pytest.mark.parametrize("injected", [True, False])
def test_batched_kernel_matches_plain_version(cuda, shape, dtype, periodic, injected):
    B, R, C = shape
    rng = np.random.default_rng(4)
    b_k = b_r = _blacks(5, *shape, dtype, cuda)
    temps = torch.as_tensor(np.linspace(0.5, 4.0, B), dtype=torch.float32)
    tables = sigmoid_table16(1.0, 0.1, temps).to(cuda)
    for k in range(3):
        keys = sweep_keys(np.arange(B) + 10, k).to(cuda)
        U = None
        if injected:
            U = torch.as_tensor(rng.integers(0, 1 << 16, (B, 2, R, C // 2)),
                                dtype=torch.int32, device=cuda)
        r_k, b_k = fused_sweep_batched(b_k, tables, keys, periodic=periodic, uniforms=U)
        r_r, b_r = fused_sweep_batched_reference(b_r, tables, keys, periodic=periodic,
                                                 uniforms=U)
        assert torch.equal(r_k, r_r) and torch.equal(b_k, b_r), k
    torch.cuda.synchronize()


def test_batched_kernel_element_equals_single_lattice_kernel(cuda):
    B, seeds, sweep = 4, [3, 5, 7, 9], 2
    blacks = _blacks(6, B, 32, 40, torch.bfloat16, cuda)
    tables = sigmoid_table16(1.0, 0.0, torch.tensor([1.5, 2.0, 2.5, 3.0])).to(cuda)
    before = fused_sweep_batched.launches
    reds, news = fused_sweep_batched(blacks, tables, sweep_keys(seeds, sweep).to(cuda))
    assert fused_sweep_batched.launches == before + 1
    for b in range(B):
        r1, b1 = fused_sweep(blacks[b], tables[b], seed=seeds[b], sweep=sweep)
        assert torch.equal(r1, reds[b]) and torch.equal(b1, news[b]), b


def test_batched_kernel_rejects_operands_off_the_device(cuda):
    blacks = _blacks(7, 2, 16, 16, torch.float32, cuda)
    tables = sigmoid_table16(1.0, 0.0, torch.tensor([2.0, 3.0]))
    with pytest.raises(ValueError):
        fused_sweep_batched(blacks, tables, sweep_keys([1, 2], 0).to(cuda))   # tables on the CPU


def test_batched_paths_on_cuda_equal_those_on_cpu(cuda):
    """Kernel and plain version agree bit for bit and host randomness comes
    from a CPU generator, so each batched path gives the same output on both
    devices for one seed."""
    def ensemble(device):
        out = sample_grid_ensemble(torch.Generator().manual_seed(1),
                                   torch.ones((3, 16, 16), device=device), [1.5, 2.5, 3.5],
                                   n_samples=5, n_burnin=10)
        return [out["magnetization"].cpu(), out["energy"].cpu()]

    def anneal(device):
        state, e = anneal_lattice(2, (16, 16), n_steps=60, n_chains=2, device=device)
        return [state.cpu(), torch.tensor(e)]

    def tempering(device):
        cold, info = parallel_tempering_lattice(3, (16, 16), temperatures=[2.0, 2.4, 2.8],
                                                n_samples=6, swap_interval=2, n_burnin=4,
                                                device=device)
        return [cold.cpu(), torch.from_numpy(info["energies"]),
                torch.from_numpy(info["final_states"]), torch.from_numpy(info["pair_attempts"])]

    for path in (ensemble, anneal, tempering):
        for a, b in zip(path(cuda), path(torch.device("cpu"))):
            assert torch.equal(a, b), path.__name__


def _bond_weights(seed, R, C, mode, periodic, device):
    """Colour weights for a mode: "codes" (±1 bonds with zeros, packed),
    "f32" or "bf16" (Gaussian bonds and field)."""
    rng = np.random.default_rng(seed)
    if mode == "codes":
        Jh, Jv = rng.choice([-1.0, 0.0, 1.0], (2, R, C))
        w = color_bond_weights(torch.as_tensor(Jh, dtype=torch.float32, device=device),
                               torch.as_tensor(Jv, dtype=torch.float32, device=device),
                               0.0, periodic)
        return pack_bond_codes(w)
    Jh, Jv, f = rng.normal(size=(3, R, C))
    w = color_bond_weights(*(torch.as_tensor(x, dtype=torch.float32, device=device)
                             for x in (Jh, Jv, 0.3 * f)), periodic)
    dt = torch.float32 if mode == "f32" else torch.bfloat16
    return {c: tuple(x.to(dt) for x in ws) for c, ws in w.items()}


def _assert_bond_equal(got, want, band):
    """Bit for bit, except (continuous mode) inside the stated band."""
    differ = got != want
    if band is not None:
        differ &= ~band
    assert not bool(differ.any()), int(differ.sum())


@pytest.mark.parametrize("shape,dtype,periodic,mode", [
    ((64, 64), torch.bfloat16, True, "codes"),
    ((18, 20), torch.float32, False, "codes"),     # R % 8 != 0
    ((34, 522), torch.bfloat16, False, "f32"),     # C/2 odd and wider than one block
    ((64, 64), torch.float32, True, "bf16"),
])
@pytest.mark.parametrize("injected", [True, False])
def test_bond_kernel_matches_plain_version(cuda, shape, dtype, periodic, mode, injected):
    """K4 half-sweep by half-sweep from one shared input, both colours, three
    temperatures: discrete bit for bit, continuous outside CONTINUOUS_BAND."""
    R, C = shape
    w = _bond_weights(1, R, C, mode, periodic, cuda)
    other = _black(2, R, C, dtype, cuda)
    rng = np.random.default_rng(3)
    for k, T in enumerate([0.7, 1.5, 3.0]):
        for color in (0, 1):
            U = None
            if injected:
                U = torch.as_tensor(rng.integers(0, 1 << 24, (R, C // 2)), dtype=torch.int32,
                                    device=cuda)
            kw = dict(update_red=color == 0, key=(11 + color, k), periodic=periodic, uniforms=U)
            if mode == "codes":
                kw["table"] = sigmoid_table(1.0, 0.0, T).to(cuda)
            else:
                kw["temperature"] = T
            wc = w["red" if color == 0 else "black"]
            got = bond_halfsweep(other, wc, **kw)
            want = bond_halfsweep_reference(other, wc, **kw)
            band = None
            if mode != "codes":
                band = continuous_band(other, wc, update_red=color == 0, temperature=T,
                                       key=kw["key"], periodic=periodic, uniforms=U)
            _assert_bond_equal(got, want, band)
            other = got
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape,dtype,periodic,mode", [
    ((3, 64, 64), torch.bfloat16, True, "codes"),
    ((2, 18, 20), torch.float32, False, "f32"),
    ((2, 34, 522), torch.bfloat16, False, "codes"),
])
@pytest.mark.parametrize("injected", [True, False])
def test_batched_bond_kernel_matches_plain_version(cuda, shape, dtype, periodic, mode, injected):
    B, R, C = shape
    w = _bond_weights(4, R, C, mode, periodic, cuda)
    others = _blacks(5, B, R, C, dtype, cuda)
    temps = torch.linspace(0.5, 3.0, B, device=cuda)
    mode_kw = ({"tables": sigmoid_table(1.0, 0.0, temps.cpu()).to(cuda)} if mode == "codes"
               else {"temperatures": temps})
    keys = bond_sweep_keys(np.arange(B) + 7, 2).to(cuda)
    rng = np.random.default_rng(6)
    for k in range(2):
        for color in (0, 1):
            U = None
            if injected:
                U = torch.as_tensor(rng.integers(0, 1 << 24, (B, R, C // 2)),
                                    dtype=torch.int32, device=cuda)
            wc = w["red" if color == 0 else "black"]
            kw = dict(update_red=color == 0, periodic=periodic, uniforms=U, **mode_kw)
            got = bond_halfsweep_batched(others, wc, keys[k, color], **kw)
            want = bond_halfsweep_batched_reference(others, wc, keys[k, color], **kw)
            band = None
            if mode != "codes":
                band = continuous_band(others, wc, update_red=color == 0, temperature=temps,
                                       key=keys[k, color], periodic=periodic, uniforms=U)
            _assert_bond_equal(got, want, band)
            others = got
    torch.cuda.synchronize()


def test_batched_bond_kernel_element_equals_single_lattice_kernel(cuda):
    B = 4
    w = _bond_weights(8, 32, 40, "codes", True, cuda)["red"]
    others = _blacks(9, B, 32, 40, torch.bfloat16, cuda)
    tables = sigmoid_table(1.0, 0.0, torch.tensor([0.5, 1.0, 1.5, 2.0])).to(cuda)
    keys = bond_sweep_keys([3, 5, 7, 9], 3)[2, 0].to(cuda)
    before = bond_halfsweep_batched.launches, bond_halfsweep.launches
    outs = bond_halfsweep_batched(others, w, keys, update_red=True, tables=tables)
    for b in range(B):
        key = tuple(int(x) & 0xFFFFFFFF for x in keys[b])
        one = bond_halfsweep(others[b], w, update_red=True, key=key, table=tables[b])
        assert torch.equal(one, outs[b]), b
    assert (bond_halfsweep_batched.launches, bond_halfsweep.launches) == (
        before[0] + 1, before[1] + B)


def test_bond_kernel_rejects_operands_off_the_device(cuda):
    w = _bond_weights(10, 16, 16, "codes", True, cuda)["red"]
    other = _black(11, 16, 16, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        bond_halfsweep(other, w, update_red=True, table=sigmoid_table(1.0, 0.0, 2.0))


def test_spin_glass_paths_on_cuda_equal_those_on_cpu(cuda):
    """The discrete spin-glass paths give the same output on both devices
    for one seed (kernel == plain version bit for bit, host randomness from a
    CPU generator)."""
    rng = np.random.default_rng(12)
    Jh, Jv = rng.choice([-1.0, 1.0], (2, 16, 16)).astype(np.float32)

    def anneal(device):
        state, e = anneal_spin_glass(1, Jh, Jv, n_steps=60, n_restarts=2, device=device)
        return [torch.from_numpy(state), torch.tensor(e)]

    def tempering(device):
        cold, info = parallel_tempering_bonds(2, Jh, Jv, temperatures=[0.8, 1.2, 1.8],
                                              n_samples=6, swap_interval=2, n_burnin=4,
                                              device=device)
        return [cold.cpu(), torch.from_numpy(info["energies"]),
                torch.from_numpy(info["final_states"])]

    def search(device):
        out = pt_ground_state_search(3, Jh, Jv, temperatures=[0.5, 0.9, 1.5], n_iters=20,
                                     n_copies=2, houdayer_every=5, quench_sweeps=4,
                                     device=device)
        return [torch.from_numpy(out["best_state"]), torch.tensor(out["best_energy"]),
                torch.from_numpy(out["pair_attempts"])]

    for path in (anneal, tempering, search):
        for a, b in zip(path(cuda), path(torch.device("cpu"))):
            assert torch.equal(a, b), path.__name__
