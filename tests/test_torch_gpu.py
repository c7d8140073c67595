"""The CUDA kernels (the fused sweep of one lattice, of a batch of lattices
and of a shard, the bond half-sweep of one lattice and of a batch of
replicas, the resident multi-sweep kernel at one table and over a schedule,
the fused sweep's decomposition variants, the exact-sigmoid half-sweep,
the Houdayer cluster move, the dense colour sweep, the observables of a
lattice's planes) against their plain PyTorch versions, and the batched,
spin-glass, sharded and observables paths on the card against the same paths
on the CPU.

Marked ``gpu``: without CUDA every test skips. On a machine with an NVIDIA
Hopper card and nvcc, run ``python -m pytest -m gpu tests/test_torch_gpu.py``;
the first test builds the kernel into build/tsu_tpu_torch/.
"""

import numpy as np
import pytest
import torch

from tsu_tpu_torch import IsingConfig, IsingGrid, profiling
from tsu_tpu_torch.config import ConfigurationError
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
from tsu_tpu_torch.ops.checkerboard_kernel import (
    halfsweep,
    halfsweep_band,
    halfsweep_reference,
    halfsweep_thresholds,
)
from tsu_tpu_torch.ops.checkerboard_resident import (
    resident_anneal_tables,
    resident_anneal_tables_reference,
    resident_grid,
    resident_sweeps_table,
    resident_sweeps_table_reference,
)
from tsu_tpu_torch.ops.houdayer_kernel import (
    GROWTH_CHECK,
    _smem_limit,
    growth_steps,
    houdayer_cluster_kernel,
    houdayer_cluster_reference,
)
from tsu_tpu_torch.ops.kernel_decomposition import (
    MODES,
    decomposition_sweep,
    decomposition_sweep_reference,
)
from tsu_tpu_torch.parallel import (
    make_mesh,
    parallel_tempering_replica_sharded,
    sharded_checkerboard_sweeps,
)
from tsu_tpu_torch.rng import sweep_keys
from tsu_tpu_torch.samplers import (
    anneal_lattice,
    anneal_spin_glass,
    parallel_tempering_bonds,
    parallel_tempering_lattice,
    pt_ground_state_search,
)
from tsu_tpu_torch.tools import bodies

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


# Lattice shapes of the Houdayer kernel's tests: square ones, a narrow ragged
# one (C/2 = 33: a row's last word holds one column) and one whose four bit
# planes (16 R ceil(C/64) bytes, 256 KiB) exceed a block's shared memory.
HOUDAYER_SHAPES = [(16, 16), (64, 64), (256, 256), (10, 66), (1024, 1024)]


def _houdayer_pairs(seed, B, shape, dtype, device):
    """(r1, b1, r2, b2) of B replica pairs: replica 1 random, replica 2 it
    with a site-percolation pattern at 0.62 negated (above the threshold, so
    a cluster spans the lattice); with B > 1, pair 0 agrees everywhere and
    pair 1 nowhere."""
    rng = np.random.default_rng(seed)
    s1 = np.where(rng.random((B, *shape)) < 0.5, 1.0, -1.0)
    q = np.where(rng.random((B, *shape)) < 0.62, -1.0, 1.0)
    if B > 1:
        q[0], q[1] = 1.0, -1.0
    return [x.to(dtype).contiguous().to(device)
            for s in (s1, s1 * q) for x in split_checkerboard(torch.from_numpy(s))]


def _houdayer_both_ways(u, planes, periodic):
    """K9's planes and growth steps == the plain version's, bit for bit, and
    one launch for the move; returns each pair's steps."""
    launches = houdayer_cluster_kernel.launches
    got, steps = houdayer_cluster_kernel(u, *planes, periodic)
    want, want_steps = houdayer_cluster_reference(u, *planes, periodic, check_every=1)
    torch.cuda.synchronize()
    assert houdayer_cluster_kernel.launches == launches + 1
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[planes[0].element_size()]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.view(bits), b.view(bits))
    assert steps.shape == u.shape and int(steps.max()) == want_steps
    return steps


@pytest.mark.parametrize("pairs", [1, 16])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16, torch.float64])
@pytest.mark.parametrize("shape", HOUDAYER_SHAPES)
def test_houdayer_kernel_matches_plain_version(cuda, shape, dtype, periodic, pairs):
    planes = _houdayer_pairs(30, pairs, shape, dtype, cuda)
    u = torch.from_numpy(np.random.default_rng(31).random(pairs, np.float32)).to(cuda)
    if pairs > 2:
        u[2] = 1.0 - 2.0**-24      # the largest uniform: the last q = -1 site
    W = -(-shape[1] // 64)
    assert (16 * shape[0] * W > _smem_limit(cuda.index or 0)) == (shape == (1024, 1024))
    steps = int(_houdayer_both_ways(u, planes, periodic).max())
    # The CPU path's count: the kernel's, rounded up to its fixed-point tests.
    assert houdayer_cluster_reference(u, *planes, periodic)[1] \
        == -(-steps // GROWTH_CHECK) * GROWTH_CHECK


@pytest.mark.parametrize("periodic", [True, False])
def test_houdayer_kernel_takes_float64_uniforms_and_clamps_the_seed(cuda, periodic):
    """u * count rounded up to count in float64 (1 - 2^-53, and 1.0) picks
    the last q = -1 site, as the plain version's clamp does; each pair's own
    step count is the plain version's for that pair alone."""
    planes = _houdayer_pairs(32, 4, (64, 64), torch.bfloat16, cuda)
    u = torch.tensor([0.0, 0.5, 1.0 - 2.0**-53, 1.0], dtype=torch.float64, device=cuda)
    steps = _houdayer_both_ways(u, planes, periodic)
    for i in range(4):
        one = [x[i:i + 1] for x in planes]
        assert int(steps[i]) == houdayer_cluster_reference(u[i:i + 1], *one, periodic,
                                                           check_every=1)[1]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16, torch.float64])
def test_houdayer_kernel_widens_values_as_the_plain_version(cuda, dtype):
    """Values other than +-1: q = -1 where the float32 product is negative,
    so a zero, or a product that underflows float32 (or a float64 value that
    rounds to zero in it), is not q = -1; a flipped zero is -0."""
    rng = np.random.default_rng(34)
    planes = _houdayer_pairs(35, 3, (64, 64), dtype, cuda)
    mags = torch.tensor([1.0, 0.5, 3.0, 1e-30, 1e-50, 0.0], dtype=torch.float64)
    planes = [(x.double() * mags[torch.from_numpy(rng.choice(6, tuple(x.shape),
                                                             p=[0.8, 0.05, 0.05, 0.04, 0.04,
                                                                0.02]))].to(cuda)).to(dtype)
              for x in planes]
    u = torch.tensor([0.1, 0.6, 0.9], device=cuda)
    for periodic in (True, False):
        _houdayer_both_ways(u, planes, periodic)


def test_houdayer_kernel_launches_once_a_move_of_the_search(cuda):
    """The PT search on the card launches K9 once a move, and counts its
    growth steps while tracing (and only then): the CPU's count, rounded up
    to the fixed-point tests, is at most GROWTH_CHECK - 1 more a move."""
    rng = np.random.default_rng(33)
    Jh, Jv = rng.choice([-1.0, 1.0], (2, 32, 32)).astype(np.float32)
    kw = dict(temperatures=[0.5, 0.9, 1.5], n_iters=20, n_copies=2, houdayer_every=5,
              quench_sweeps=4)
    counts = {}
    for device in (cuda, torch.device("cpu")):
        launches = houdayer_cluster_kernel.launches
        profiling.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            pt_ground_state_search(3, Jh, Jv, device=device, **kw)
        counts[device.type] = (houdayer_cluster_kernel.launches - launches, profiling.counters())
    steps = growth_steps(cuda)
    before = int(steps)
    pt_ground_state_search(3, Jh, Jv, device=cuda, **kw)
    assert int(steps) == before
    (launches, card), (none, cpu) = counts["cuda"], counts["cpu"]
    assert launches == 4 and none == 0
    assert card["houdayer.moves"] == cpu["houdayer.moves"] == 4
    assert 0 <= cpu["houdayer.growth_steps"] - card["houdayer.growth_steps"] \
        <= 4 * (GROWTH_CHECK - 1)


def _planes(seed, R, C, dtype, device):
    rng = np.random.default_rng(seed)
    lat = torch.as_tensor(np.where(rng.random((R, C)) < 0.5, 1.0, -1.0), dtype=dtype)
    return tuple(x.contiguous().to(device) for x in split_checkerboard(lat))


@pytest.mark.parametrize("shape,dtype,periodic", [
    ((64, 64), torch.bfloat16, True),
    ((18, 20), torch.float32, False),     # R % 16 != 0
    ((34, 522), torch.bfloat16, False),   # C/2 odd
    ((2, 2), torch.float32, True),        # one compact column
    ((4, 4), torch.bfloat16, True),       # bands of one row; R = 4 wraps onto itself
    ((4, 4), torch.float32, True),
    ((130, 250), torch.float32, False),   # C/2 = 125: a ragged last word, uneven bands
    ((8192, 8192), torch.bfloat16, True), # 64 MB of bf16 planes, 62-63 rows a band
    ((4096, 4096), torch.float32, True),
])
@pytest.mark.parametrize("injected", [True, False])
def test_resident_kernels_match_plain_versions(cuda, shape, dtype, periodic, injected):
    """K6 (one table) and K7 (a schedule) in one launch each, bit for bit
    against their plain versions (4 sweeps, 2 at 8192^2); the inputs stay as
    they were and each call counts one launch."""
    R, C = shape
    S = 2 if R * C > 1 << 24 else 4
    red, black = _planes(13, R, C, dtype, cuda)
    before = red.clone(), black.clone()
    U = None
    if injected:
        U = torch.as_tensor(np.random.default_rng(14).integers(0, 1 << 24, (S, 2, R, C // 2)),
                            dtype=torch.int32, device=cuda)
    table = sigmoid_table(0.7, 0.1, 2.3).to(cuda)
    tables = sigmoid_table(1.0, 0.0, torch.tensor([4.0, 2.0, 1.0, 0.5][:S])).to(cuda)
    counts = resident_sweeps_table.launches, resident_anneal_tables.launches
    got = resident_sweeps_table(21, red, black, table, S, periodic=periodic, uniforms=U)
    want = resident_sweeps_table_reference(21, red, black, table, S, periodic=periodic,
                                           uniforms=U)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = resident_anneal_tables(22, red, black, tables, periodic=periodic, uniforms=U)
    want = resident_anneal_tables_reference(22, red, black, tables, periodic=periodic,
                                            uniforms=U)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(red, before[0]) and torch.equal(black, before[1])
    assert (resident_sweeps_table.launches, resident_anneal_tables.launches) == (
        counts[0] + 1, counts[1] + 1)


@pytest.mark.parametrize("periodic", [True, False])
def test_resident_kernels_take_any_int32_table(cuda, periodic):
    """Tables with entries at or below 0 and at or past 2^24 (sigmoid_table
    makes neither) run the kernel's unshifted compare, sweep by sweep beside
    a 24-bit table: K6 and K7 equal their plain versions bit for bit."""
    red, black = _planes(17, 130, 250, torch.float32, cuda)
    odd = torch.tensor([-5, 0, 1 << 24, (1 << 24) + 7, 1 << 23, 3, (1 << 24) - 1, 2**31 - 1,
                        100], dtype=torch.int32)
    tables = torch.stack([odd, sigmoid_table(1.0, 0.0, 2.0), odd]).to(cuda)
    got = resident_anneal_tables(23, red, black, tables, periodic=periodic)
    want = resident_anneal_tables_reference(23, red, black, tables, periodic=periodic)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = resident_sweeps_table(24, red, black, tables[0], 3, periodic=periodic)
    want = resident_sweeps_table_reference(24, red, black, tables[0], 3, periodic=periodic)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_resident_kernel_raises_above_the_cards_limit_before_launching(cuda):
    """A lattice whose tiles do not fit the shared memory of the resident
    grid raises ConfigurationError, naming the limit, and launches nothing;
    the shapes the reference admits and the chip shapes plan on this card."""
    R = C = 16384                                    # 268 M sites
    red = black = torch.ones((R, C // 2), dtype=torch.bfloat16, device=cuda)
    table = sigmoid_table(1.0, 0.0, 2.0).to(cuda)
    counts = resident_sweeps_table.launches, resident_anneal_tables.launches
    with pytest.raises(ConfigurationError, match="shared memory"):
        resident_sweeps_table(0, red, black, table, 2)
    with pytest.raises(ConfigurationError, match="shared memory"):
        resident_anneal_tables(0, red, black, table.expand(2, 9).contiguous())
    assert (resident_sweeps_table.launches, resident_anneal_tables.launches) == counts
    for shape in ((16, 786432 * 2), (4096, 4096), (8192, 8192), (15360, 15360), (1002, 1000)):
        plan = resident_grid(shape[0], shape[1] // 2, torch.bfloat16, cuda.index or 0)
        assert plan.blocks <= torch.cuda.get_device_properties(cuda).multi_processor_count * 4


def test_resident_kernel_rejects_operands_off_the_device(cuda):
    red, black = _planes(15, 16, 16, torch.float32, cuda)
    with pytest.raises(ValueError):
        resident_sweeps_table(0, red, black, sigmoid_table(1.0, 0.0, 2.0), 2)   # table on the CPU


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("shape,dtype,periodic", [
    ((64, 64), torch.bfloat16, True),
    ((18, 20), torch.float32, False),
    ((34, 522), torch.bfloat16, False),
])
@pytest.mark.parametrize("injected", [True, False])
def test_decomposition_kernels_match_plain_versions(cuda, mode, shape, dtype, periodic,
                                                    injected):
    R, C = shape
    _, black = _planes(16, R, C, dtype, cuda)
    U = None
    if injected:
        U = torch.as_tensor(np.random.default_rng(17).integers(0, 1 << 16, (2, R, C // 2)),
                            dtype=torch.int32, device=cuda)
    before = decomposition_sweep.launches
    got = decomposition_sweep(mode, black, seed=4, sweep=3, periodic=periodic, uniforms=U)
    want = decomposition_sweep_reference(mode, black, seed=4, sweep=3, periodic=periodic,
                                         uniforms=U)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert decomposition_sweep.launches == before + 1


def _halo_spins(rng, shape, dtype, device):
    return torch.as_tensor(np.where(rng.random(shape) < 0.5, 1.0, -1.0), dtype=dtype).to(device)


def _k3_halos(rng, R, C2, dtype, device, col_halo, halos):
    """(up, down, column halos) of a K3 plane: random +-1 rows and columns;
    with ``halos`` "zero" the up row and the left column are zeros (the open
    top and left edges of a shard); "strided" takes the columns in place from
    a wider plane, as the sharded path hands them over."""
    up, down = (_halo_spins(rng, (1, C2), dtype, device) for _ in range(2))
    if halos == "zero":
        up = torch.zeros_like(up)
    if not col_halo:
        return up, down, {}
    if halos == "strided":
        wide = _halo_spins(rng, (R, C2 + 3), dtype, device)
        return up, down, dict(left_col=wide[:, -1:], right_col=wide[:, 1:2])
    left, right = (_halo_spins(rng, (R, 1), dtype, device) for _ in range(2))
    if halos == "zero":
        left = torch.zeros_like(left)
    return up, down, dict(left_col=left, right_col=right)


@pytest.mark.parametrize("shape,dtype,periodic,col_halo,row0,col0,halos", [
    ((64, 64), torch.float32, True, False, 0, 0, "random"),
    ((18, 20), torch.bfloat16, False, False, 0, 0, "random"),    # R % 8 != 0, open
    ((34, 522), torch.float32, True, True, 34, 259, "random"),   # wider than a block, col0 % 4
    ((16, 14), torch.bfloat16, True, True, 2, 6, "random"),
    ((18, 20), torch.float32, False, False, 0, 0, "zero"),       # the open top of a lattice
    ((34, 522), torch.bfloat16, False, True, 0, 0, "zero"),      # a shard's open corner
    ((34, 522), torch.float32, True, True, 34, 260, "strided"),  # the columns read in place
    ((16, 14), torch.bfloat16, True, True, 2, 7, "strided"),
])
@pytest.mark.parametrize("injected", [True, False])
def test_halfsweep_kernel_matches_plain_version(cuda, shape, dtype, periodic, col_halo, row0,
                                                col0, halos, injected):
    """K3, both colours, three temperatures, random, zero or strided halos:
    equal to its plain version at every site outside CONTINUOUS_BAND."""
    R, C = shape
    other = _black(20, R, C, dtype, cuda)
    rng = np.random.default_rng(21)
    up, down, cols = _k3_halos(rng, R, C // 2, dtype, cuda, col_halo, halos)
    before = halfsweep.launches
    for k, T in enumerate([0.7, 2.269, 4.0]):
        for color in (0, 1):
            U = None
            if injected:
                U = torch.as_tensor(rng.integers(0, 1 << 24, (R, C // 2)), dtype=torch.int32,
                                    device=cuda)
            kw = dict(update_red=color == 0, temperature=T, J=1.0, field=0.1, periodic=periodic,
                      key=(31 + color, k), row0=row0, col0=col0, uniforms=U, **cols)
            got = halfsweep(other, up, down, **kw)
            want = halfsweep_reference(other, up, down, **kw)
            _assert_bond_equal(got, want, halfsweep_band(other, up, down, **kw))
            other = got
    torch.cuda.synchronize()
    assert halfsweep.launches == before + 6


def _halfsweep_both_bodies(rng, R, C2, dtype, periodic, col_halo, injected, device, offset=0,
                           halos="random", row0=0, col0=0, sweeps=2, T=2.269, field=0.1):
    """K3 over ``sweeps`` sweeps, half-sweep by half-sweep from the kernel's
    last output: equal to the first body (checkerboard_halfsweep_scalar.cu)
    at every site, band included, and to the plain version outside the
    band. Returns the sites in the band."""
    old = bodies.scalar_library()
    other = _placed(_halo_spins(rng, (R, C2), dtype, "cpu"), device, offset)
    up, down, cols = _k3_halos(rng, R, C2, dtype, device, col_halo, halos)
    old_cols = {k: v.contiguous() for k, v in cols.items()}
    n_band = 0
    for k in range(sweeps):
        for color in (0, 1):
            U = None
            if injected:
                U = _placed(torch.as_tensor(rng.integers(0, 1 << 24, (R, C2)),
                                            dtype=torch.int32), device, offset)
            kw = dict(update_red=color == 0, temperature=T, J=1.0, field=field,
                      periodic=periodic, key=(41 + color, k), row0=row0, col0=col0, uniforms=U)
            got = halfsweep(other, up, down, **kw, **cols)
            first = bodies.body_halfsweep(old, other, up, down, **kw, **old_cols)
            assert torch.equal(got, first), ("first body", k, color, int((got != first).sum()))
            band = halfsweep_band(other, up, down, **kw, **cols)
            _assert_bond_equal(got, halfsweep_reference(other, up, down, **kw, **cols), band)
            n_band += int(band.sum())
            other = got
    torch.cuda.synchronize()
    return n_band


@pytest.mark.parametrize("C2", [1, 3, 4, 5, 33])
@pytest.mark.parametrize("R", [2, 6, 10])    # the least R, and two rows either side of an 8-row strip
def test_halfsweep_kernel_at_narrow_and_ragged_shapes(cuda, R, C2):
    """The strip body's column edges (a ragged last group, planes narrower
    than a Philox group or a warp, a column offset inside a group) and row
    edges (strips taller than the plane), both dtypes, periodic and open,
    with and without column halos, injected and Philox."""
    rng = np.random.default_rng(200 * R + C2)
    before = halfsweep.launches
    for dtype in (torch.bfloat16, torch.float32):
        for periodic in (True, False):
            for col_halo in (False, True):
                for injected in (True, False):
                    _halfsweep_both_bodies(rng, R, C2, dtype, periodic, col_halo, injected, cuda,
                                           halos="zero" if not periodic else "random",
                                           row0=2 * C2, col0=C2 + injected)
    assert halfsweep.launches == before + 16 * 4


@pytest.mark.parametrize("shape", [(18, 128), (66, 500)])
@pytest.mark.parametrize("offset", [1, 3])
def test_halfsweep_kernel_on_planes_not_aligned_for_the_vector_path(cuda, shape, offset):
    """C2 % 4 == 0 but the planes start at an odd element: the kernel takes
    its site-by-site path and still equals the first body and the plain
    version."""
    rng = np.random.default_rng(offset)
    for dtype in (torch.bfloat16, torch.float32):
        for periodic in (True, False):
            for injected in (True, False):
                _halfsweep_both_bodies(rng, *shape, dtype, periodic, periodic, injected, cuda,
                                       offset=offset, halos="strided" if periodic else "zero")


@pytest.mark.parametrize("shape,dtype,periodic,col_halo,halos,row0,col0", [
    ((64, 64), torch.float32, True, False, "random", 0, 0),
    ((130, 512), torch.bfloat16, True, True, "strided", 130, 256),   # the vector path
    ((34, 522), torch.float32, False, True, "zero", 0, 259),
    ((34, 1000), torch.bfloat16, False, False, "zero", 0, 0),
])
@pytest.mark.parametrize("injected", [True, False])
def test_halfsweep_kernel_equals_its_first_body_at_every_site(cuda, shape, dtype, periodic,
                                                              col_halo, halos, row0, col0,
                                                              injected):
    """The strip body writes the first body's bits at every site, the
    1e-6 band included, over 2 sweeps; the uniforms sit at the thresholds
    t - 2 .. t + 1 (injected) so that the band is full."""
    R, C2 = shape
    rng = np.random.default_rng(R + C2)
    n_band = _halfsweep_both_bodies(rng, R, C2, dtype, periodic, col_halo, False, cuda,
                                    halos=halos, row0=row0, col0=col0, T=0.7, field=0.25)
    if injected:
        t = halfsweep_thresholds(1.0, 0.25, 0.7)
        gen = np.random.default_rng(7)
        other = _placed(_halo_spins(rng, (R, C2), dtype, "cpu"), cuda)
        up, down, cols = _k3_halos(rng, R, C2, dtype, cuda, col_halo, halos)
        old_cols = {k: v.contiguous() for k, v in cols.items()}
        for color in (0, 1):
            u = t.numpy()[gen.integers(0, 9, (R, C2))] + gen.integers(-2, 2, (R, C2))
            U = torch.as_tensor(np.clip(u, 0, (1 << 24) - 1), dtype=torch.int32, device=cuda)
            kw = dict(update_red=color == 0, temperature=0.7, J=1.0, field=0.25,
                      periodic=periodic, key=(5, color), row0=row0, col0=col0, uniforms=U)
            got = halfsweep(other, up, down, **kw, **cols)
            first = bodies.body_halfsweep(bodies.scalar_library(), other, up, down, **kw,
                                          **old_cols)
            assert torch.equal(got, first), int((got != first).sum())
            n_band += int(halfsweep_band(other, up, down, **kw, **cols).sum())
            other = got
    torch.cuda.synchronize()
    assert n_band > 0 or not injected


def test_halfsweep_kernel_rejects_operands_off_the_device(cuda):
    other = _black(22, 16, 16, torch.float32, cuda)
    with pytest.raises(ValueError):
        halfsweep(other, other[-1:].cpu(), other[:1], update_red=True, temperature=2.0)


@pytest.mark.parametrize("shape,dtype,periodic,row0,R_global", [
    ((64, 64), torch.bfloat16, True, 64, 256),
    ((18, 20), torch.float32, False, 0, 36),        # the lattice's top row, open
    ((34, 522), torch.bfloat16, False, 34, 68),     # the lattice's bottom row, open
    ((16, 30), torch.float32, True, 0, 16),         # one shard: the whole lattice
])
@pytest.mark.parametrize("injected", [True, False])
def test_fused_shard_mode_matches_plain_version(cuda, shape, dtype, periodic, row0, R_global,
                                                injected):
    R, C = shape
    rng = np.random.default_rng(23)
    black = _black(24, R, C, dtype, cuda)
    up2, down2 = (torch.as_tensor(np.where(rng.random((2, C // 2)) < 0.5, 1.0, -1.0),
                                  dtype=dtype).to(cuda) for _ in range(2))
    top, bot = row0 == 0, row0 + R == R_global
    if not periodic:
        up2, down2 = (torch.zeros_like(up2) if top else up2), (torch.zeros_like(down2) if bot
                                                                 else down2)
    table = sigmoid_table16(1.0, 0.1, 2.269).to(cuda)
    U = UH = None
    if injected:
        U = torch.as_tensor(rng.integers(0, 1 << 16, (2, R, C // 2)), dtype=torch.int32,
                            device=cuda)
        UH = tuple(torch.as_tensor(rng.integers(0, 1 << 16, (1, C // 2)), dtype=torch.int32,
                                   device=cuda) for _ in range(2))
    kw = dict(seed=6, sweep=4, periodic=periodic, uniforms=U, up2=up2, down2=down2,
              shard_info=(row0, R_global, top, bot), uniforms_halo=UH)
    before = fused_sweep.launches
    got = fused_sweep(black, table, **kw)
    want = fused_sweep_reference(black, table, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert fused_sweep.launches == before + 1


def _placed(x, device, offset=0):
    """x on the card; with ``offset`` a contiguous view that many elements
    into its buffer, not aligned for the kernels' vector path."""
    x = x.to(device)
    if not offset:
        return x
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


def _spin_plane(rng, shape, dtype, device, offset=0):
    """A ±1 plane on the card; with ``offset`` a contiguous view starting
    that many elements into its buffer, so that it is not aligned to a quad
    and the kernels take their site-by-site path."""
    return _placed(torch.as_tensor(np.where(rng.random(shape) < 0.5, 1.0, -1.0), dtype=dtype),
                   device, offset)


def _fused_three_ways(rng, R, C2, dtype, periodic, injected, device, offset=0):
    """K1, K2 (a batch of 3) and K1's shard mode (the middle and, open, the
    bottom shard of a lattice of 3R rows) on one plane shape, each against
    its plain version bit for bit; returns the launches counted."""
    table = sigmoid_table16(1.0, 0.1, 2.269).to(device)

    def uniforms(*lead):
        if not injected:
            return None
        return torch.as_tensor(rng.integers(0, 1 << 16, (*lead, 2, R, C2)), dtype=torch.int32,
                               device=device)

    black = _spin_plane(rng, (R, C2), dtype, device, offset)
    kw = dict(seed=9, sweep=2, periodic=periodic, uniforms=uniforms())
    got, want = fused_sweep(black, table, **kw), fused_sweep_reference(black, table, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), "K1"

    blacks = _spin_plane(rng, (3, R, C2), dtype, device, offset)
    tables = sigmoid_table16(1.0, 0.1, torch.tensor([0.8, 2.269, 4.0])).to(device)
    keys = sweep_keys([4, 5, 6], 3).to(device)
    U = uniforms(3)
    got = fused_sweep_batched(blacks, tables, keys, periodic=periodic, uniforms=U)
    want = fused_sweep_batched_reference(blacks, tables, keys, periodic=periodic, uniforms=U)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), "K2"

    for row0 in (R, 2 * R):
        top, bot = False, row0 == 2 * R
        up2 = _spin_plane(rng, (2, C2), dtype, device, offset)
        down2 = (torch.zeros((2, C2), dtype=dtype, device=device) if bot and not periodic
                 else _spin_plane(rng, (2, C2), dtype, device, offset))
        UH = None if not injected else tuple(
            torch.as_tensor(rng.integers(0, 1 << 16, (1, C2)), dtype=torch.int32, device=device)
            for _ in range(2))
        kw = dict(seed=7, sweep=1, periodic=periodic, uniforms=uniforms(), up2=up2, down2=down2,
                  shard_info=(row0, 3 * R, top, bot), uniforms_halo=UH)
        got, want = fused_sweep(black, table, **kw), fused_sweep_reference(black, table, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), ("shard", row0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("C2", [1, 3, 4, 5, 33])
@pytest.mark.parametrize("R", [2, 6, 10])    # the least R, and two rows either side of an 8-row strip
def test_fused_kernels_at_narrow_and_ragged_shapes(cuda, R, C2):
    """The strip body's column edges (a ragged last group, planes narrower
    than a Philox group or a warp) and row edges (strips taller than the
    plane, a ragged last strip), both dtypes, periodic and open, injected
    and Philox, for K1, K2 and the shard mode."""
    rng = np.random.default_rng(100 * R + C2)
    before = (fused_sweep.launches, fused_sweep_batched.launches)
    for dtype in (torch.bfloat16, torch.float32):
        for periodic in (True, False):
            for injected in (True, False):
                _fused_three_ways(rng, R, C2, dtype, periodic, injected, cuda)
    assert (fused_sweep.launches, fused_sweep_batched.launches) == (before[0] + 24, before[1] + 8)


@pytest.mark.parametrize("shape", [(18, 128), (66, 500)])
@pytest.mark.parametrize("offset", [1, 3])
def test_fused_kernels_on_planes_not_aligned_for_the_vector_path(cuda, shape, offset):
    """C2 % 4 == 0 but the planes start at an odd element: the kernels take
    their site-by-site path and still equal the plain versions."""
    rng = np.random.default_rng(offset)
    for dtype in (torch.bfloat16, torch.float32):
        for periodic in (True, False):
            for injected in (True, False):
                _fused_three_ways(rng, *shape, dtype, periodic, injected, cuda, offset=offset)


def _bond_kernels_both_ways(rng, R, C2, dtype, periodic, injected, mode, device, offset=0):
    """K4 over two sweeps and K5 (a batch of 3) over one, half-sweep by
    half-sweep from one shared input, both colours, each against its plain
    version: discrete bit for bit, continuous outside CONTINUOUS_BAND. With
    ``offset`` every operand is a view at that element offset."""
    w = _bond_weights(int(rng.integers(1 << 30)), R, 2 * C2, mode, periodic, device)
    w = {c: _placed(v, device, offset) if isinstance(v, torch.Tensor)
         else tuple(_placed(x, device, offset) for x in v) for c, v in w.items()}

    def uniforms(*lead):
        if not injected:
            return None
        return _placed(torch.as_tensor(rng.integers(0, 1 << 24, (*lead, R, C2)),
                                       dtype=torch.int32), device, offset)

    other = _spin_plane(rng, (R, C2), dtype, device, offset)
    for k, T in enumerate([0.7, 3.0]):
        for color in (0, 1):
            U = uniforms()
            kw = dict(update_red=color == 0, key=(11 + color, k), periodic=periodic, uniforms=U)
            kw.update({"table": sigmoid_table(1.0, 0.0, T).to(device)} if mode == "codes"
                      else {"temperature": T})
            wc = w["red" if color == 0 else "black"]
            got = bond_halfsweep(other, wc, **kw)
            band = None if mode == "codes" else continuous_band(
                other, wc, update_red=color == 0, temperature=T, key=kw["key"], periodic=periodic,
                uniforms=U)
            _assert_bond_equal(got, bond_halfsweep_reference(other, wc, **kw), band)
            other = _placed(got, device, offset)

    others = _spin_plane(rng, (3, R, C2), dtype, device, offset)
    temps = torch.tensor([0.5, 1.2, 3.0], device=device)
    mode_kw = ({"tables": sigmoid_table(1.0, 0.0, temps.cpu()).to(device)} if mode == "codes"
               else {"temperatures": temps})
    keys = bond_sweep_keys([7, 8, 9], 1)[0].to(device)
    for color in (0, 1):
        U = uniforms(3)
        wc = w["red" if color == 0 else "black"]
        kw = dict(update_red=color == 0, periodic=periodic, uniforms=U, **mode_kw)
        got = bond_halfsweep_batched(others, wc, keys[color], **kw)
        band = None if mode == "codes" else continuous_band(
            others, wc, update_red=color == 0, temperature=temps, key=keys[color],
            periodic=periodic, uniforms=U)
        _assert_bond_equal(got, bond_halfsweep_batched_reference(others, wc, keys[color], **kw),
                           band)
        others = _placed(got, device, offset)
    torch.cuda.synchronize()


@pytest.mark.parametrize("C2", [1, 3, 4, 5, 33, 128, 129])
@pytest.mark.parametrize("R", [2, 6, 10])    # the least R, and two rows either side of an 8-row strip
def test_bond_kernels_at_narrow_and_ragged_shapes(cuda, R, C2):
    """The bond strip body's column edges (a ragged last group, planes
    narrower than a Philox group or a warp, one warp wide, a warp past the
    plane's edge) and row edges (strips taller than the plane, a ragged last
    strip): K4 and K5, both dtypes, periodic and open, injected and Philox,
    codes with zero bonds and continuous float32 and bfloat16 weights."""
    rng = np.random.default_rng(100 * R + C2)
    before = (bond_halfsweep.launches, bond_halfsweep_batched.launches)
    for dtype in (torch.bfloat16, torch.float32):
        for periodic in (True, False):
            for injected in (True, False):
                for mode in ("codes", "f32", "bf16"):
                    _bond_kernels_both_ways(rng, R, C2, dtype, periodic, injected, mode, cuda)
    assert (bond_halfsweep.launches, bond_halfsweep_batched.launches) == (
        before[0] + 96, before[1] + 48)


@pytest.mark.parametrize("shape", [(18, 128), (66, 500)])
@pytest.mark.parametrize("offset", [1, 3])
def test_bond_kernels_on_planes_not_aligned_for_the_vector_path(cuda, shape, offset):
    """C2 % 4 == 0 but the planes, codes, weights and uniforms start at an odd
    element: K4 and K5 take their site-by-site path and still equal the plain
    versions."""
    rng = np.random.default_rng(offset)
    for dtype in (torch.bfloat16, torch.float32):
        for periodic in (True, False):
            for injected in (True, False):
                for mode in ("codes", "f32", "bf16"):
                    _bond_kernels_both_ways(rng, *shape, dtype, periodic, injected, mode, cuda,
                                            offset=offset)


@pytest.mark.parametrize("mode", ["codes", "f32"])
def test_batched_bond_kernel_element_equals_single_lattice_kernel_one_warp_wide(cuda, mode):
    """At C2 = 128 one warp spans the row and the rotation of its lanes
    carries the horizontal wrap: K5's element b is K4 under b's key and
    temperature or table row."""
    B, R, C = 3, 64, 256
    w = _bond_weights(12, R, C, mode, True, cuda)["black"]
    others = _blacks(13, B, R, C, torch.bfloat16, cuda)
    temps = torch.tensor([0.6, 1.4, 2.2])
    keys = bond_sweep_keys([3, 5, 7], 2)[1, 1].to(cuda)
    if mode == "codes":
        tables = sigmoid_table(1.0, 0.0, temps).to(cuda)
        outs = bond_halfsweep_batched(others, w, keys, update_red=False, tables=tables)
    else:
        outs = bond_halfsweep_batched(others, w, keys, update_red=False,
                                      temperatures=temps.to(cuda))
    for b in range(B):
        key = tuple(int(x) & 0xFFFFFFFF for x in keys[b])
        mode_kw = ({"table": tables[b]} if mode == "codes" else {"temperature": float(temps[b])})
        one = bond_halfsweep(others[b], w, update_red=False, key=key, **mode_kw)
        assert torch.equal(one, outs[b]), b


@pytest.mark.parametrize("kernel,rows,cols", [("K1", 4, 1), ("K3", 2, 2), ("K3", 4, 1)])
@pytest.mark.parametrize("periodic", [True, False])
def test_sharded_runs_equal_one_shard_on_the_card(cuda, kernel, rows, cols, periodic):
    """Four shards on one card: the sharded run equals the one-shard run of
    the same kernel bit for bit, and each shard launched its kernel."""
    lat = torch.as_tensor(np.where(np.random.default_rng(25).random((64, 48)) < 0.5, 1.0, -1.0))
    dtype = torch.bfloat16 if kernel == "K1" else torch.float32
    red, black = (x.to(cuda, dtype).contiguous() for x in split_checkerboard(lat))
    kw = dict(periodic=periodic, fused=kernel == "K1")
    one = sharded_checkerboard_sweeps(make_mesh(devices=[cuda]), 8, red, black, 2.269, 3, **kw)
    counter = fused_sweep if kernel == "K1" else halfsweep
    before = counter.launches
    got = sharded_checkerboard_sweeps(make_mesh(rows=rows, cols=cols, devices=[cuda] * 4), 8,
                                      red, black, 2.269, 3,
                                      col_axis="col" if cols > 1 else None, **kw)
    assert torch.equal(one[0], got[0]) and torch.equal(one[1], got[1])
    assert counter.launches == before + 4 * 3 * (1 if kernel == "K1" else 2)


def test_sharded_paths_on_cuda_equal_those_on_cpu(cuda):
    def grid(device, rows, cols):
        g = IsingGrid((16, 16), periodic=True, seed=4, device=device,
                      config=IsingConfig(n_burnin=10, n_sweeps=2))
        out = g.sample_observables(4, temperature=2.269,
                                   mesh=make_mesh(rows=rows, cols=cols, devices=[device] * 4))
        return [torch.from_numpy(out["magnetization"]), torch.from_numpy(out["energy"])]

    def tempering(device):
        out = parallel_tempering_replica_sharded(make_mesh(replica=4, devices=[device] * 4), 3,
                                                 (16, 16), np.geomspace(1.8, 3.0, 8),
                                                 n_samples=6, swap_interval=2, n_burnin=4)
        return [torch.from_numpy(out[k]) for k in ("magnetization", "energy", "rungs")]

    cpu = torch.device("cpu")
    for name, path in (("rows", lambda d: grid(d, 4, 1)), ("2-D", lambda d: grid(d, 2, 2)),
                       ("tempering", tempering)):
        for a, b in zip(path(cuda), path(cpu)):
            assert torch.equal(a, b), name


# -- slice 4: the dense colour sweep and the sparse anneal on the card ---------

def _sk(n, seed=0):
    rng = np.random.default_rng(seed)
    A = np.triu(rng.choice([-1.0, 1.0], (n, n)), 1) / np.sqrt(n)
    return (A + A.T).astype(np.float32)


def _sk_bit_form(n, seed=0):
    """The bit form (4 J, -2 J 1) of a ±1 SK instance: integer couplings and
    fields, so every sum of a site's field is exact in float32."""
    rng = np.random.default_rng(seed)
    A = np.triu(rng.choice([-1.0, 1.0], (n, n)), 1)
    J = A + A.T
    return (4.0 * J).astype(np.float32), (-2.0 * J.sum(1)).astype(np.float32)


def _torus(rows, cols):
    """The dense couplings of a periodic rows x cols grid, J = 1."""
    J = np.zeros((rows * cols, rows * cols), np.float32)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for j in (((r + 1) % rows) * cols + c, r * cols + (c + 1) % cols):
                J[i, j] = J[j, i] = 1.0
    return J


def _blocks(n, width):
    """The SK bit form with no coupling inside each block of ``width``
    sites, and those blocks as the colours."""
    J, h = _sk_bit_form(n)
    J = J * np.kron(np.eye(n // width) == 0, np.ones((width, width)))
    return J.astype(np.float32), np.zeros(n, np.float32), np.arange(n).reshape(-1, width)


def _maxcut_bits(n, seed=0):
    """MAX-CUT on G(n, 1/2) in the bit form that the annealer samples:
    J = -4 W, h = 2 W 1, integers."""
    rng = np.random.default_rng(seed)
    W = np.triu((rng.random((n, n)) < 0.5).astype(np.float32), 1)
    W = W + W.T
    return -4.0 * W, 2.0 * W.sum(1)


@pytest.mark.parametrize("route,couplings,n,chains,sequential", [
    ("graph", "sk", 512, 8, False),            # narrow colours, the graph forced
    ("graph", "sk", 96, 3, True),
    ("fused", "sk-bits", 512, 8, False),       # K10 on integer couplings
    ("fused", "sk-bits", 96, 3, True),
    ("graph", "torus", 63 * 65, 8, False),     # three wide colours take the graph
    ("fused", "blocks16", 512, 8, False),      # K10 on colours of 16 sites
    ("fused", "maxcut", 512, 64, False),       # K10 on a greedy colouring of G(512, 1/2)
], ids=["graph-sk512", "graph-seq96", "fused-sk512", "fused-seq96", "graph-grid63x65",
        "fused-blocks16", "fused-gnp512"])
def test_dense_sweep_graph_equals_eager_on_the_same_uniforms(cuda, monkeypatch, route, couplings,
                                                             n, chains, sequential):
    """The card's route computes what the eager colour loop computes on the
    same uniforms, bit for bit over 2 sweeps: the captured graph (forced for
    a narrow plan, taken by a wide one) and, on integer couplings whose
    fields are exact, the fused kernel K10 on colours of one site and of
    several, whose launches and ``dense.fused_sweeps`` counter advance."""
    from tsu_tpu_torch.ops.dense_sweep_kernel import dense_colour_sweep
    from tsu_tpu_torch.samplers import gibbs
    from tsu_tpu_torch.samplers.gibbs import ColourPlan, DenseSweeper, colour_sweep

    colors = None
    if couplings == "sk":
        J, h, scale = _sk(n), np.zeros(n), 1.0
        monkeypatch.setattr(gibbs, "dense_route", lambda widest, chains, slots: "graph")
    elif couplings == "sk-bits":
        (J, h), scale = _sk_bit_form(n), 4.0 * np.sqrt(n)
    elif couplings == "blocks16":
        (J, h, colors), scale = _blocks(n, 16), 4.0 * np.sqrt(n)
    elif couplings == "maxcut":
        (J, h), scale = _maxcut_bits(n), 2.0 * np.sqrt(n)
    else:
        J, h, scale = _torus(63, 65), np.zeros(n), 4.0
    plan = ColourPlan(J, h, colors, sequential=sequential, device=cuda)
    sw = DenseSweeper(plan, chains, 0)
    assert sw.route == route
    assert (plan.widest > 1) == (couplings in ("blocks16", "maxcut", "torus"))
    sw.load((torch.rand((chains, n), generator=torch.Generator().manual_seed(1)) < 0.5).float())
    sw.set_temperature(torch.linspace(0.5, 2.0, chains) * scale)
    launched = dense_colour_sweep.launches
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        sw.run(1)                                    # captures the graph on its route
    counts = profiling.counters()
    if route == "graph":
        assert sw._graph is not None and counts["dense.captures"] == 1
        assert dense_colour_sweep.launches == launched
    else:
        assert sw._graph is None and "dense.captures" not in counts
        assert counts["dense.fused_sweeps"] == 1 and dense_colour_sweep.launches == launched + 1
    assert counts["dense.colour_steps"] == plan.n_colors * (1 + (route == "graph"))
    eager = sw.states.clone()
    u = torch.rand((2, chains, n), device=cuda, generator=torch.Generator(cuda).manual_seed(2))
    for k in range(2):
        sw.u.copy_(u[k])
        if route == "graph":
            sw._graph.replay()
        else:
            dense_colour_sweep(plan, sw.states, sw.u, sw.T)
        colour_sweep(plan, eager, u[k], sw.T)
    torch.cuda.synchronize()
    assert int((sw.states != eager).sum()) == 0
    assert 0 < int(sw.states.sum()) < chains * n


def test_dense_fused_blocks_at_once_follow_the_cards_occupancy(cuda):
    """K10's resident blocks, which the route rule divides the chains by:
    at 4,096 sites a block's ~147 KB of shared memory leaves room for one
    an SM; a small plan's blocks fit several an SM; a plan that no block
    holds has none."""
    from tsu_tpu_torch.ops.dense_sweep_kernel import blocks_at_once

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert blocks_at_once(4096, 1, cuda) == sms
    small = blocks_at_once(96, 1, cuda)
    assert small % sms == 0 and small > sms
    assert blocks_at_once(4097, 1, cuda) == 0


def test_dense_fused_sweep_decides_each_site_by_its_own_field(cuda):
    """K10 on the non-integer SK plan (J_ij = ±1/sqrt(n), a colour a site):
    one sweep of 8 chains checked decision by decision. Site k's field is
    taken in float64 from K10's own new bits before k and the old bits
    after it; every decision equals u < sigmoid(field / T) outside the
    1e-6 band, where the order of a float32 sum may round either way."""
    from tsu_tpu_torch.ops.dense_sweep_kernel import dense_colour_sweep
    from tsu_tpu_torch.samplers.gibbs import ColourPlan, DenseSweeper

    n, chains, band = 512, 8, 1e-6
    plan = ColourPlan(_sk(n), np.zeros(n), device=cuda)
    assert plan.n_colors == n
    sw = DenseSweeper(plan, chains, 0)
    assert sw.route == "fused"
    sw.load((torch.rand((chains, n), generator=torch.Generator().manual_seed(3)) < 0.5).float())
    sw.set_temperature(torch.linspace(0.5, 2.0, chains))
    old = sw.states.double()
    u = torch.rand((chains, n), device=cuda, generator=torch.Generator(cuda).manual_seed(4))
    sw.u.copy_(u)
    dense_colour_sweep(plan, sw.states, sw.u, sw.T)
    new = sw.states.double()
    J = plan.J.double()
    field = (new @ torch.tril(J, -1).T + old @ torch.triu(J, 1).T + plan.h.double()
             + (J.diagonal() - plan.diag.double()) * old)
    p = torch.sigmoid(field / sw.T.double())
    outside = (u.double() - p).abs() > band
    assert torch.equal(new[outside], (u.double() < p).double()[outside])
    assert int((~outside).sum()) < 10
    assert 0 < int(new.sum()) < chains * n


def test_dense_routes_on_the_card_match_enumeration(cuda):
    from tsu_tpu_torch import GibbsConfig, GibbsSampler
    from tsu_tpu_torch.samplers.tempering import parallel_tempering_dense

    rng = np.random.default_rng(7)
    J = rng.normal(0, 0.7, (10, 10))
    J = ((J + J.T) / 2).astype(np.float32)
    np.fill_diagonal(J, 0)
    h = rng.normal(0, 0.5, 10).astype(np.float32)
    states = np.array(np.meshgrid(*[[0.0, 1.0]] * 10)).reshape(10, -1).T
    E = -0.5 * np.einsum("ki,ij,kj->k", states, J, states) - states @ h
    w = np.exp(-(E - E.min()))
    mean = (w / w.sum()) @ states
    for order, init in (("checkerboard", None), ("sequential", np.zeros(10))):
        s = GibbsSampler(GibbsConfig(n_burnin=100, n_sweeps=3, n_chains=8, update_order=order),
                         seed=3, device=cuda)
        x = s.sample_boltzmann(J, bias=h, n_samples=4000, initial_state=init)
        assert s.last_route == "device"
        assert np.all(np.abs(x.mean(axis=0) - mean) < 0.06), order
    cold, _ = parallel_tempering_dense(0, J, h, temperatures=[1.0, 1.5, 2.3, 3.4],
                                       n_samples=3000, swap_interval=2, device=cuda)
    assert np.all(np.abs(cold.cpu().numpy().mean(axis=0) - mean) < 0.07)


def _sk_bits(n, seed, device):
    """A fully connected ±1 glass drawn on ``device`` from ``seed``: its spin
    couplings, and its bit form (4 J, -2 J 1) on the host."""
    gen = torch.Generator(device=device).manual_seed(seed)
    J = torch.triu(2.0 * torch.randint(0, 2, (n, n), generator=gen, device=device) - 1.0, 1)
    J = J + J.T
    return J, (4.0 * J).cpu().numpy(), (-2.0 * J.sum(1)).cpu().numpy()


def test_sk4096_replica_exchange_on_the_card_passes_the_reference_check(cuda):
    """The benchmark's 4,096-spin, 64-rung SK configuration through the
    public entry on the card, every rung kept: every sweep of every rung,
    every swap and every energy held to the plain reference, whose
    bfloat16 control fails the same check. The float32 energies that decide
    the swaps are exact at this size (energy_gap 0)."""
    from perfbench.reference import dense_pt as reference
    from tsu_tpu_torch.samplers import parallel_tempering_dense

    n, R, rounds, seed = 4096, 64, 16, 2**40 + 5
    J, Jb, hb = _sk_bits(n, 11, cuda)
    temps = (np.geomspace(0.3, 1.5, R) * np.sqrt(n)).astype(np.float32)
    states, info = parallel_tempering_dense(seed, Jb, hb, temperatures=temps, n_samples=rounds,
                                            swap_interval=1, n_sweeps=1, n_burnin=0,
                                            keep="all", device=cuda)
    assert states.shape == (rounds, R, n) and states.dtype == torch.uint8
    kw = dict(temperatures=temps, n_rounds=rounds, device=cuda)
    ref = reference.dense_pt(seed, J, **kw)
    got = reference.gaps({"states": states, "energies": info["energies"],
                          "pair_acceptance": info["pair_acceptance"],
                          "pair_attempts": info["pair_attempts"]}, ref)
    assert {k: got[k] for k in ("decisions_outside_band", "energy_gap", "swap_accepts_gap")} \
        == {"decisions_outside_band": 0.0, "energy_gap": 0.0, "swap_accepts_gap": 0.0}, got
    assert info["swap_accepts"] > 0
    control = reference.dense_pt(seed, J, prob_bits=8, **kw)["answer"]
    assert reference.gaps(control, ref)["decisions_outside_band"] > 0


def test_sparse_anneal_on_the_card_resumes_bit_for_bit(cuda, tmp_path, monkeypatch):
    from tsu_tpu_torch.ops import sparse_ising

    rng = np.random.default_rng(3)
    edges = rng.integers(0, 2000, (10000, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    idx, w = sparse_ising.ell_from_edges(2000, edges, np.ones(len(edges)))
    sched = np.geomspace(3.0, 0.05, 200).astype(np.float32)
    args = (idx, -w, np.zeros(2000, np.float32), sched)
    full = sparse_ising.sparse_anneal(4, *args, n_steps=200, n_chains=8, device=cuda)
    chunked = sparse_ising.sparse_anneal(4, *args, n_steps=200, n_chains=8, chunk_steps=33,
                                         device=cuda)
    assert full[1] == chunked[1] and torch.equal(full[0], chunked[0])
    real_save = sparse_ising.save_state

    def dying_save(*a, **kw):
        real_save(*a, **kw)
        raise RuntimeError("killed")

    path = str(tmp_path / "ck")
    monkeypatch.setattr(sparse_ising, "save_state", dying_save)
    with pytest.raises(RuntimeError):
        sparse_ising.sparse_anneal(4, *args, n_steps=200, n_chains=8, chunk_steps=50,
                                   checkpoint_path=path, device=cuda)
    monkeypatch.setattr(sparse_ising, "save_state", real_save)
    resumed = sparse_ising.sparse_anneal(4, *args, n_steps=200, n_chains=8, chunk_steps=50,
                                         checkpoint_path=path, resume=True, device=cuda)
    assert full[1] == resumed[1] and torch.equal(full[0], resumed[0])


def test_dense_model_and_max_cut_on_the_card(cuda):
    from tsu_tpu_torch import IsingModel, MaxCutProblem, optimize

    W = np.zeros((300, 300), np.float32)
    W[:3, 3:6] = 1.0
    W = W + W.T
    assert optimize(MaxCutProblem(W), n_steps=200, n_chains=2, seed=5,
                    device=cuda)["best_objective"] == -9.0
    m = IsingModel(300, config=IsingConfig(n_chains=4, n_burnin=5, n_sweeps=1), seed=0,
                   device=cuda)
    m.J = _sk(300)
    s = m.sample(8)
    assert s.shape == (8, 300) and set(np.unique(s)) <= {-1.0, 1.0}
    assert m._plan_of is not None and m._plan_of[2].J.is_cuda


# -- slice 5: the continuous samplers' step loops on the card ---------------

def _continuous_runs():
    """name -> run(draws, x0, graph) -> (tensor, route), at 4 chains x dim 4."""
    from tsu_tpu_torch.energy import MixtureOfGaussians
    from tsu_tpu_torch.samplers.hmc import run_hmc, run_hmc_adaptive
    from tsu_tpu_torch.samplers.langevin import run_langevin
    from tsu_tpu_torch.samplers.mala import run_mala
    from tsu_tpu_torch.samplers.nuts import run_nuts
    from tsu_tpu_torch.samplers.smc import run_smc
    from tsu_tpu_torch.samplers.vi import run_vi

    mix = MixtureOfGaussians(((-1.0, 0.0, 0.5, 0.0), (1.0, 0.5, 0.0, -0.5)), (0.8, 1.1))
    return {
        "langevin": lambda d, x, g: run_langevin(d, x, energy_fn=mix, n_samples=5, n_burnin=10,
                                                 n_steps=3, dt=0.05, graph=g),
        "langevin_em": lambda d, x, g: run_langevin(d, x, energy_fn=mix, n_samples=5,
                                                    n_burnin=10, n_steps=3, dt=0.01,
                                                    underdamped=False, graph=g),
        "mala": lambda d, x, g: (lambda r: (r[0], r[1]["route"]))(run_mala(
            d, x, energy_fn=mix, n_samples=10, n_burnin=10, graph=g)),
        "hmc": lambda d, x, g: (lambda r: (r[0], r[2]))(run_hmc(
            d, x, energy_fn=mix, n_samples=5, n_burnin=5, n_leapfrog=4, graph=g)),
        "hmc_adaptive": lambda d, x, g: (lambda r: (r[0], r[1]["route"]))(run_hmc_adaptive(
            d, x, energy_fn=mix, n_samples=8, n_burnin=3, n_leapfrog=6, graph=g)),
        "nuts": lambda d, x, g: (lambda r: (r[0], r[1]["route"]))(run_nuts(
            d, x, energy_fn=mix, n_samples=3, n_burnin=2, max_depth=4, graph=g)),
        "smc": lambda d, x, g: (lambda r: (r["particles"][0], r["route"]))(run_smc(
            d, [3.0 * x.repeat(8, 1)], energy_fn=mix, n_steps=8, n_moves=2, ess_threshold=0.7,
            graph=g)),
        "vi": lambda d, x, g: (lambda r: (torch.cat([r[0].mu, r[0].rho]), r[2]))(run_vi(
            d, mix, 4, x.device, n_steps=20, n_mc=4, graph=g)),
    }


@pytest.mark.parametrize("name", ["langevin", "langevin_em", "mala", "hmc", "hmc_adaptive",
                                  "nuts", "smc", "vi"])
def test_continuous_loop_graph_equals_eager_and_cpu(cuda, name):
    """On one set of draws: the CUDA graph replay equals the eager loop bit
    for bit, and the card equals the CPU within 1e-4."""
    from tsu_tpu_torch.samplers.loop import Draws

    run = _continuous_runs()[name]
    x0 = torch.randn((4, 4), generator=torch.Generator().manual_seed(3))
    # Record the draws of a CPU run, then hand them to the card's runs.
    log = {}

    class Recording(Draws):
        def fill(self, key, kind, out, *bounds):
            super().fill(key, kind, out, *bounds)
            log.setdefault(key, []).append(out.clone())

    ref, _ = run(Recording(torch.Generator().manual_seed(4)), x0, True)
    given = {k: torch.cat(v) for k, v in log.items()}
    eager, route_e = run(Draws(given=given), x0.to(cuda), False)
    graph, route_g = run(Draws(given=given), x0.to(cuda), True)
    assert (route_e, route_g) == ("eager", "graph")
    assert torch.equal(graph, eager)
    np.testing.assert_allclose(eager.cpu().numpy(), ref.numpy(), atol=1e-4)


def test_uncapturable_energies_run_eagerly_with_one_warning(cuda):
    import warnings

    from tsu_tpu_torch import Quadratic, sample_langevin

    def copies_in(x):        # a host-to-card copy: not capturable
        return torch.sum(x**2 * torch.tensor([1.0, 2.0], device=x.device)) / 2.0

    def reads_a_value(x):    # .item(): vmap cannot batch it
        if float(x.abs().max()) > 1e6:
            raise ValueError("diverged")
        return torch.sum(x**2) / 2.0

    for energy, words in ((copies_in, "could not be captured"), (reads_a_value, "chain by chain")):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            s = sample_langevin(0, np.zeros((4, 2)), energy_fn=energy, n_samples=5, n_burnin=5,
                                device=cuda)
        assert sample_langevin.last_route == "eager"
        assert sum(words in str(w.message) for w in caught) == 1
        assert bool(torch.isfinite(s).all())
    sample_langevin(0, np.zeros((4, 2)), energy_fn=Quadratic(), n_samples=5, n_burnin=5,
                    device=cuda)
    assert sample_langevin.last_route == "graph"


def test_continuous_api_on_the_card(cuda):
    from tsu_tpu_torch import (
        GaussianSampler,
        OptimizationProblem,
        Quadratic,
        TSUConfig,
        annealed_smc,
        annealed_smc_sharded,
        make_mesh,
        optimize,
    )

    res = GaussianSampler(1.0, 0.5, seed=0, config=TSUConfig(n_chains=64, n_burnin=100,
                                                             n_steps=100, dt=0.1)).sample(2000)
    assert res.metadata["route"] == "graph" and abs(res.samples.mean() - 1.0) < 0.15

    class Shifted(OptimizationProblem):
        def objective(self, x):
            return torch.sum((x - 1.5) ** 2)

        @property
        def dimension(self):
            return 3

    out = optimize(Shifted(), seed=0, device=cuda)
    assert out["route"] == "graph"
    np.testing.assert_allclose(out["best_solution"], 1.5, atol=0.1)
    parts = 3.0 * torch.randn((512, 3), generator=torch.Generator().manual_seed(5))
    one = annealed_smc(2, parts, energy_fn=Quadratic(), n_steps=10, device=cuda)
    four = annealed_smc_sharded(make_mesh(chains=4, devices=[cuda] * 4), 2, parts,
                                energy_fn=Quadratic(), n_steps=10)
    assert one["route"] == four["route"] == "graph"
    np.testing.assert_array_equal(four["particles"], one["particles"].cpu().numpy())
    assert four["log_Z"] == float(one["log_Z"])


# -- slice 6: the BNN loops on the card ----------------------------------------


def _bnn_setup(n_points=40, sizes=(1, 16, 16, 1)):
    from tsu_tpu_torch.models import ml

    rng = np.random.default_rng(0)
    x = torch.tensor(rng.uniform(-1, 1, (n_points, 1)).astype(np.float32))
    y = torch.sin(3 * x)
    net = ml.BayesianRegressor(1, list(sizes[1:-1]), seed=0, device="cpu")
    trainable = {"layers": [{k: v.detach().clone() for k, v in p.items()} for p in net.params],
                 "log_noise": net.log_noise.detach().clone()}
    return ml, x, y, trainable


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("which", ["fit", "ensemble", "predict"])
def test_bnn_loop_graph_equals_eager_and_cpu(cuda, which):
    """Each BNN loop on one set of draws: the graph replay == the eager loop
    on the card bit for bit, the card == the CPU (losses within 1e-5
    relative, the ensemble's 1e-4; parameters and predictions within
    1e-4). The ensemble runs tanh units: a relu unit whose input rounds to
    the other side of 0 on the card takes another gradient from there on."""
    from tsu_tpu_torch.samplers.loop import Draws

    ml, x, y, trainable = _bnn_setup()
    sizes = (1, 16, 16, 1)
    gen = torch.Generator().manual_seed(1)

    if which == "fit":
        eps = torch.randn((70, 3, ml.n_weights(sizes)), generator=gen)

        def run(dev, graph):
            tr, losses, kls, route = ml.run_fit(
                Draws(given={"eps": eps}), _to(trainable, dev), x.to(dev), y.to(dev), n_steps=70,
                learning_rate=0.01, kl_weight=0.1, temperature=1.0, prior_std=1.0, n_mc=3,
                activation="relu", graph=graph)
            return [losses, kls] + ml._flat(tr), route
        rtol = 1e-5
    elif which == "ensemble":
        reg = ml.AnchoredEnsembleRegressor(1, [16, 16], n_members=4, seed=0, device="cpu")

        def run(dev, graph):
            tr, losses, route = ml.run_anchored(_to(reg.trainable, dev), _to(reg.anchors, dev),
                                                x.to(dev), y.to(dev), n_steps=70,
                                                learning_rate=0.01, prior_std=1.0,
                                                activation="tanh", graph=graph)
            return [losses, tr["log_noise"]] + [l["w"] for l in tr["layers"]], route
        rtol = 1e-4
    else:
        eps = torch.randn((1, 50, ml.n_weights(sizes)), generator=gen)

        def run(dev, graph):
            pred, route = ml.run_predict(Draws(given={"eps": eps}), _to(trainable["layers"], dev),
                                         x.to(dev), 1.0, "relu", 50, graph=graph)
            return [pred], route
        rtol = 1e-5
    ref, _ = run(torch.device("cpu"), False)
    eager, route_e = run(cuda, False)
    graph, route_g = run(cuda, True)
    assert (route_e, route_g) == ("eager", "graph")
    for g, e, r in zip(graph, eager, ref):
        assert torch.equal(g, e)
        np.testing.assert_allclose(e.cpu().numpy(), r.numpy(), rtol=rtol, atol=1e-4)


def test_bnn_classes_on_the_card(cuda):
    """The class surface on the card: a full-batch fit and the predictive
    replay graphs, a minibatch fit over [cuda] * 2 equals one device's."""
    from tsu_tpu_torch import AnchoredEnsembleRegressor, BayesianRegressor
    from tsu_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (64, 1)).astype(np.float32)
    y = np.sin(3 * x).astype(np.float32)
    reg = BayesianRegressor(1, [16], seed=0, device=cuda)
    reg.fit(x, y, n_epochs=100, batch_size=64)
    assert reg.last_route == "graph"
    res = reg.predict(x, n_samples=30)
    assert reg.last_route == "graph" and res.samples.shape == (30, 64, 1)
    ens = AnchoredEnsembleRegressor(1, [16], n_members=4, seed=0, device=cuda)
    ens.fit(x, y, n_epochs=100)
    assert ens.last_route == "graph" and ens.loss_history[-1] < ens.loss_history[0]
    a = BayesianRegressor(1, [8], seed=1, device=cuda)
    b = BayesianRegressor(1, [8], seed=1, device=cuda)
    ha = a.fit(x, y, n_epochs=3, batch_size=16)["loss_history"]
    hb = b.fit(x, y, n_epochs=3, batch_size=16,
               mesh=make_mesh(chains=2, devices=[cuda] * 2))["loss_history"]
    np.testing.assert_allclose(hb, ha, rtol=1e-5)


# -- the ferromagnet's observables from the planes (K11) ---------------------


def _lattice_planes(kind, shape, dtype=torch.bfloat16, B=None, seed=0):
    """Red and black planes of an (R, C) lattice (B of them when B is
    given): random spins, all up, all down, or the antiferromagnetic
    checkerboard (every red site up, every black one down)."""
    R, C = shape
    full = (R, C) if B is None else (B, R, C)
    if kind == "random":
        lat = torch.where(torch.rand(full, generator=torch.Generator().manual_seed(seed)) < 0.5,
                          1.0, -1.0)
    elif kind == "checkerboard":
        x, y = torch.meshgrid(torch.arange(R), torch.arange(C), indexing="ij")
        lat = torch.where((x + y) % 2 == 0, 1.0, -1.0).expand(full)
    else:
        lat = torch.full(full, 1.0 if kind == "up" else -1.0)
    return [p.to(dtype).contiguous() for p in split_checkerboard(lat)]


def _merge_route(red, black, J, field, periodic):
    """The CPU route of ``IsingGrid.sample_observables``: the merged
    lattice's float64 magnetization per spin and total energy."""
    from tsu_tpu_torch.ops.checkerboard import lattice_energy_batch, merge_checkerboard

    lattice = merge_checkerboard(red.cpu(), black.cpu()).to(torch.float32)
    n = lattice.shape[-1] * lattice.shape[-2]
    return (lattice.to(torch.float64).sum((-2, -1)) / n,
            lattice_energy_batch(lattice, J=J, field=field, periodic=periodic))


def _k11(red, black, cuda, J=1.0, field=0.0, periodic=True, rows=1):
    """K11 on the planes on the card, into row ``rows - 1`` of fresh
    outputs; returns (m, e) of that row on the CPU."""
    from tsu_tpu_torch.ops.plane_observables import observables_scratch, plane_observables

    red, black = red.to(cuda), black.to(cuda)
    B = red.shape[0] if red.dim() == 3 else 1
    m = torch.full((rows, B), float("nan"), dtype=torch.float64, device=cuda)
    e = torch.full_like(m, float("nan"))
    plane_observables(red, black, m, e, rows - 1, observables_scratch(red.shape, cuda), J=J,
                      field=field, periodic=periodic)
    return m[-1].cpu().reshape(red.shape[:-2]), e[-1].cpu().reshape(red.shape[:-2])


@pytest.mark.parametrize("shape", [(2, 2), (6, 10), (64, 64), (1024, 4096), (4096, 4096)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "open"])
@pytest.mark.parametrize("kind", ["random", "up", "down", "checkerboard"])
def test_plane_observables_equal_the_merge_route_bit_for_bit(cuda, shape, periodic, kind):
    """K11's float64 m and E equal the CPU route's (merge_checkerboard and
    lattice_energy_batch) bit for bit, at the extreme sums too: all up and
    all down (|m| = 1, E = -2N periodic) and the antiferromagnetic
    checkerboard (E = +2N periodic)."""
    red, black = _lattice_planes(kind, shape)
    got, want = _k11(red, black, cuda, periodic=periodic), _merge_route(red, black, 1.0, 0.0,
                                                                         periodic)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (got, want)
    n = shape[0] * shape[1]
    if periodic and kind == "checkerboard":
        assert float(got[1]) == 2 * n and float(got[0]) == 0.0
    if periodic and kind in ("up", "down"):
        assert float(got[1]) == -2 * n and abs(float(got[0])) == 1.0


@pytest.mark.parametrize("case", ["float32", "field", "batch", "unaligned", "grid-stride"])
def test_plane_observables_other_operands(cuda, monkeypatch, case):
    """K11 on float32 planes, with a non-integer coupling and a field, on a
    batch of lattices written at row * B + b, on planes whose pointers are
    not 16-byte aligned (its element-wise loads), and with fewer blocks
    than a lattice's strips (every thread walks several): each == the
    merge route bit for bit."""
    from tsu_tpu_torch.ops import plane_observables as k11

    J, field, periodic, B, shape = 1.0, 0.0, True, None, (64, 96)
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    if case == "field":
        J, field, periodic = 0.7, 0.3, False
    if case == "batch":
        B = 3
    if case == "grid-stride":
        monkeypatch.setattr(k11, "MAX_BLOCKS", 2)
        shape = (256, 512)
    red, black = _lattice_planes("random", shape, dtype, B=B, seed=7)
    if case == "unaligned":
        buf = torch.empty(2 * red.numel() + 2, dtype=dtype)
        red = buf[1:1 + red.numel()].view(red.shape).copy_(red)
        black = buf[2 + red.numel():].view(black.shape).copy_(black)
    got = _k11(red, black, cuda, J=J, field=field, periodic=periodic, rows=3)
    want = _merge_route(red, black, J, field, periodic)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (got, want)


def test_plane_observables_reuse_one_scratch_launch_after_launch(cuda):
    """One scratch serves a chain of launches: each leaves its tickets at
    zero, so sample i of 6 different lattices lands in row i, each equal
    to its merge route."""
    from tsu_tpu_torch.ops.plane_observables import observables_scratch, plane_observables

    m = torch.empty(6, dtype=torch.float64, device=cuda)
    e = torch.empty_like(m)
    scratch = observables_scratch((512, 256), cuda)
    planes = [_lattice_planes("random", (512, 512), seed=i) for i in range(6)]
    for i, (red, black) in enumerate(planes):
        plane_observables(red.to(cuda), black.to(cuda), m, e, i, scratch, J=1.0)
    assert int(scratch[-1]) == 0
    for i, (red, black) in enumerate(planes):
        want = _merge_route(red, black, 1.0, 0.0, True)
        assert float(m[i]) == float(want[0]) and float(e[i]) == float(want[1]), i


def test_sample_observables_on_the_card_equal_the_cpu_and_count_k11(cuda):
    """The card's IsingGrid.sample_observables takes K11 once a sample and
    answers what the CPU answers from the same seed, bit for bit;
    ``observables.fused_samples`` counts each sample K11 took."""
    from tsu_tpu_torch.ops.plane_observables import plane_observables

    def run(device):
        grid = IsingGrid((64, 96), periodic=True, seed=11, device=device,
                         config=IsingConfig(n_burnin=20, n_sweeps=3))
        return grid.sample_observables(n_samples=7, temperature=2.269)

    want = run("cpu")
    before = plane_observables.launches
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = run(cuda)
    assert profiling.counters()["observables.fused_samples"] == 7
    assert plane_observables.launches == before + 7
    for k in ("magnetization", "energy"):
        assert got[k].dtype == want[k].dtype == np.float64
        assert np.array_equal(got[k], want[k]), k


def _syncs_of(call):
    """(the program's ``host_syncs`` count, the synchronizing-operation
    warnings of ``torch.cuda.set_sync_debug_mode("warn")``) of one call of
    ``call``, made after a warm-up call, with tracing on."""
    import warnings

    from tsu_tpu_torch import profiling

    call()
    torch.cuda.synchronize()
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    warned = [w for w in caught if "synchronizing CUDA operation" in str(w.message)]
    return profiling.counters().get("host_syncs", 0), len(warned)


@pytest.mark.parametrize("entry", ["sample_observables", "pt_ground_state_search",
                                   "parallel_tempering_dense"])
def test_host_syncs_equal_the_sync_warnings(cuda, entry):
    """``host_syncs`` counts every point where a call of the benchmarked
    entries waits for the card, no more and no fewer."""
    if entry == "sample_observables":
        def call():
            IsingGrid((64, 64), periodic=True, seed=3, device=cuda).sample_observables(
                n_samples=5, temperature=2.269)
    elif entry == "parallel_tempering_dense":
        from tsu_tpu_torch.samplers import parallel_tempering_dense

        _, Jb, hb = _sk_bits(64, 2, cuda)

        def call():
            parallel_tempering_dense(3, Jb, hb, temperatures=np.geomspace(2.4, 12.0, 4),
                                     n_samples=6, swap_interval=1, n_burnin=0, keep="all",
                                     device=cuda)
    else:
        gen = torch.Generator(device=cuda).manual_seed(5)
        Jh, Jv = (2.0 * torch.randint(0, 2, (2, 32, 32), generator=gen, device=cuda) - 1.0)

        def call():
            pt_ground_state_search(7, Jh, Jv, temperatures=np.geomspace(0.4, 2.0, 4),
                                   n_iters=20, n_copies=2, houdayer_every=2, quench_sweeps=4,
                                   device=cuda)
    counted, warned = _syncs_of(call)
    assert counted == warned > 0
