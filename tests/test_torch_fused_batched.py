"""The port's batched fused sweep (its plain version, on the CPU) against
tsu_tpu's fused Pallas kernel in TPU interpret mode, element by element.

The JAX batched kernel has no injection mode; its contract is that element b
equals the unbatched kernel under seeds[b]. So each element of the port's
batched sweep, fed injected 16-bit uniforms made with numpy from a seed, is
held bit for bit against the JAX unbatched ``fused_sweeps`` on the same
uniforms, and in Philox mode against the port's own unbatched plain version.
The CUDA kernel is held against the same plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tsu_tpu.ops import checkerboard as jcb  # noqa: E402
from tsu_tpu.ops import checkerboard_fused as jfused  # noqa: E402
from tsu_tpu_torch.ops.checkerboard import split_checkerboard  # noqa: E402
from tsu_tpu_torch.ops.checkerboard_fused import (  # noqa: E402
    MAX_BATCH,
    fused_sweep_batched,
    fused_sweep_batched_reference,
    fused_sweep_reference,
    fused_sweeps_batched,
    fused_sweeps_keyed,
    sigmoid_table16,
)
from tsu_tpu_torch.rng import fold_seed, sweep_keys, to_int32  # noqa: E402

J, FIELD = 1.0, 0.1
TEMPS = [2.269, 4.0, 0.5]   # one per lattice; both packages' tables agree exactly here
SEEDS = [101, 202, 303]
B, R, C, N_SWEEPS = 3, 16, 16, 2


def _lattices(seed, shape):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(shape) < 0.5, 1.0, -1.0).astype(np.float32)


def _planes(seed, shape, dtype=torch.float32):
    return split_checkerboard(torch.from_numpy(_lattices(seed, shape)).to(dtype))


@pytest.mark.parametrize("band_rows", [None, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("periodic", [True, False])
def test_batched_plain_matches_jax_unbatched_interpret(periodic, dtype, band_rows):
    np.testing.assert_array_equal(
        sigmoid_table16(J, FIELD, torch.tensor(TEMPS)).numpy(),
        np.stack([np.asarray(jfused.sigmoid_table16(J, FIELD, T)) for T in TEMPS]))
    lats = _lattices(20, (B, R, C))
    rng = np.random.default_rng(21)
    U = rng.integers(0, 1 << 16, (N_SWEEPS, B, 2, R, C // 2), dtype=np.int32)
    tdt = getattr(torch, dtype)
    reds, blacks = split_checkerboard(torch.from_numpy(lats).to(tdt))
    r_t, b_t = fused_sweeps_batched(SEEDS, reds, blacks, TEMPS, N_SWEEPS, J=J,
                                    field=FIELD, periodic=periodic,
                                    uniforms=torch.from_numpy(U))
    assert r_t.dtype == b_t.dtype == tdt and r_t.shape == (B, R, C // 2)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        for b in range(B):
            red, black = jcb.split_checkerboard(jnp.asarray(lats[b]))
            r_j, b_j = jfused.fused_sweeps(
                jnp.int32(SEEDS[b]), red.astype(jdt), black.astype(jdt), TEMPS[b],
                N_SWEEPS, J=J, field=FIELD, periodic=periodic,
                uniforms=jnp.asarray(U[:, b]), band_rows=band_rows)
            np.testing.assert_array_equal(r_t[b].float().numpy(), np.asarray(r_j, np.float32))
            np.testing.assert_array_equal(b_t[b].float().numpy(), np.asarray(b_j, np.float32))


@pytest.mark.parametrize("periodic,shape", [(True, (B, R, C)), (False, (2, 12, 20))])
def test_philox_element_equals_unbatched_plain_version(periodic, shape):
    """Element b of the batched sweep is the unbatched sweep under seeds[b],
    sweep by sweep (R = 12 and C/2 = 10 cross no 8-row or 4-column edge)."""
    reds, blacks = _planes(22, shape)
    seeds, temps = SEEDS[:shape[0]], TEMPS[:shape[0]]
    r_t, b_t = fused_sweeps_batched(seeds, reds, blacks, temps, N_SWEEPS, J=J,
                                    field=FIELD, periodic=periodic)
    for b in range(shape[0]):
        black = blacks[b]
        for k in range(N_SWEEPS):
            red, black = fused_sweep_reference(black, sigmoid_table16(J, FIELD, temps[b]),
                                               seed=seeds[b], sweep=k, periodic=periodic)
        assert torch.equal(red, r_t[b]) and torch.equal(black, b_t[b]), b


def test_seed_rows_behave_like_seeds():
    """(B, 2) seed rows ignore their second column, as in the JAX package
    (tests/test_pallas_interpret.py::test_fused_sweeps_batched_accepts_seed_rows);
    members with equal lattices and temperatures but distinct seeds differ."""
    reds, blacks = split_checkerboard(torch.ones(2, 16, 16))
    seeds = torch.tensor([7, 8], dtype=torch.int32)
    rows = torch.stack([seeds, torch.tensor([99, 77], dtype=torch.int32)], dim=1)
    r1, b1 = fused_sweeps_batched(seeds, reds, blacks, [2.6, 2.6], 2)
    r2, b2 = fused_sweeps_batched(rows, reds, blacks, [2.6, 2.6], 2)
    assert torch.equal(r1, r2) and torch.equal(b1, b2)
    assert not torch.equal(b1[0], b1[1])


def test_keyed_sweeps_take_a_table_row_per_sweep():
    """(n, B, 9) tables give sweep k its own row (the annealer's schedule);
    zero keys give back the input planes."""
    reds, blacks = _planes(24, (2, 8, 12))
    sched = torch.tensor([[4.0, 3.0], [2.0, 1.5], [1.0, 0.7]])
    tables = sigmoid_table16(J, FIELD, sched)
    keys = sweep_keys(np.array([[5, 6]]), np.arange(3)[:, None])
    r_t, b_t = fused_sweeps_keyed(reds, blacks, tables, keys, periodic=False)
    black = blacks
    for k in range(3):
        red, black = fused_sweep_batched_reference(black, tables[k], keys[k], periodic=False)
    assert torch.equal(red, r_t) and torch.equal(black, b_t)
    same = fused_sweeps_keyed(reds, blacks, tables, keys[:0])
    assert same[0] is reds and same[1] is blacks


def test_sweep_keys_fold_the_seed_and_wrap_the_sweep():
    keys = sweep_keys(np.array([[3, 2**31 + 5]]), np.array([[0], [2**32 + 1]]))
    assert keys.shape == (2, 2, 2) and keys.dtype == torch.int32
    assert keys[0, :, 0].tolist() == [fold_seed(3), fold_seed(2**31 + 5)]
    assert keys[1, :, 0].tolist() == keys[0, :, 0].tolist()
    assert keys[:, 0, 1].tolist() == [0, 1]
    assert fold_seed(2**31 + 5) == fold_seed(to_int32(2**31 + 5))


def test_cpu_call_runs_the_plain_version_without_launching():
    _, blacks = _planes(23, (2, 8, 8))
    tables = sigmoid_table16(1.0, 0.0, torch.tensor([2.0, 3.0]))
    keys = sweep_keys([1, 2], 0)
    before = fused_sweep_batched.launches
    got = fused_sweep_batched(blacks, tables, keys, periodic=False)
    want = fused_sweep_batched_reference(blacks, tables, keys, periodic=False)
    assert fused_sweep_batched.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


_BLACKS = torch.ones(2, 8, 4)
_TABLES = sigmoid_table16(1.0, 0.0, torch.tensor([2.0, 3.0]))
_KEYS = sweep_keys([1, 2], 0)


@pytest.mark.parametrize("kw", [
    {"blacks": torch.ones(8, 4)},                                    # not batched
    {"blacks": torch.ones(2, 7, 4)},                                 # odd R
    {"blacks": torch.ones(2, 8, 4, dtype=torch.float64)},            # dtype
    {"tables": _TABLES[:1]},                                         # one row short
    {"tables": _TABLES.float()},                                     # not int32
    {"keys": _KEYS[:, :1]},                                          # (B, 1)
    {"keys": _KEYS.long()},                                          # not int32
    {"uniforms": torch.zeros(2, 8, 4, dtype=torch.int32)},           # no colour axis
    {"uniforms": torch.zeros(2, 2, 8, 4, dtype=torch.int64)},        # not int32
    {"blacks": torch.ones(MAX_BATCH + 1, 2, 1),                      # B above the grid's z
     "tables": torch.zeros(MAX_BATCH + 1, 9, dtype=torch.int32),
     "keys": torch.zeros(MAX_BATCH + 1, 2, dtype=torch.int32)},
])
def test_batched_sweep_rejects_misshapen_operands(kw):
    args = {"blacks": _BLACKS, "tables": _TABLES, "keys": _KEYS, "uniforms": None, **kw}
    with pytest.raises(ValueError):
        fused_sweep_batched(args["blacks"], args["tables"], args["keys"],
                            uniforms=args["uniforms"])


def test_fused_sweeps_batched_rejects_misshapen_seeds_and_uniforms():
    reds, blacks = split_checkerboard(torch.ones(2, 8, 8))
    with pytest.raises(ValueError):
        fused_sweeps_batched([1, 2, 3], reds, blacks, 2.0, 1)
    with pytest.raises(ValueError):
        fused_sweeps_batched([1, 2], reds, blacks, 2.0, 2,
                             uniforms=torch.zeros(1, 2, 2, 8, 4, dtype=torch.int32))
