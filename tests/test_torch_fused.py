"""The port's fused sweep (its plain version, on the CPU) against tsu_tpu's
fused Pallas kernel run in TPU interpret mode.

Both sides get the same lattice and the same injected 16-bit uniforms, made
with numpy from a seed, and must return bit-identical planes. The CUDA kernel
is held against the same plain version on the card (tests/test_torch_gpu.py,
chip_smoke.py).
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
    fused_sweep,
    fused_sweep_reference,
    fused_sweeps,
    sigmoid_table,
    sigmoid_table16,
)

J, FIELD = 1.0, 0.1
SCHEDULE = [2.269, 4.0, 0.5]   # temperatures at which both tables agree exactly


def _planes(seed, R, C):
    rng = np.random.default_rng(seed)
    lat = np.where(rng.random((R, C)) < 0.5, 1.0, -1.0).astype(np.float32)
    return jcb.split_checkerboard(jnp.asarray(lat))


def _uniforms(seed, n_sweeps, R, C):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 16, (n_sweeps, 2, R, C // 2), dtype=np.int32)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x, np.float32), dtype=dtype)


def test_sigmoid_tables_close_to_jax():
    """16-bit thresholds within 1 count of the JAX package's over a grid of
    temperatures, 24-bit within 2 (torch's and XLA's float32 sigmoids each
    err by about one ulp, and an ulp of p >= 0.5 is one 24-bit count)."""
    Ts = np.linspace(0.05, 10.0, 200).astype(np.float32)
    for j, f in [(1.0, 0.0), (1.0, 0.1), (1.0, -0.3)]:
        t16 = sigmoid_table16(j, f, torch.from_numpy(Ts)).numpy()
        t24 = sigmoid_table(j, f, torch.from_numpy(Ts)).numpy()
        j16 = np.stack([np.asarray(jfused.sigmoid_table16(j, f, T)) for T in Ts])
        j24 = np.stack([np.asarray(jfused.sigmoid_table(j, f, T)) for T in Ts])
        assert np.abs(t16 - j16).max() <= 1
        assert np.abs(t24 - j24).max() <= 2
    for j, f, T in [(J, FIELD, T) for T in SCHEDULE] + [(1.0, 0.0, 2.5), (0.0, 5.0, 1.0)]:
        np.testing.assert_array_equal(sigmoid_table16(j, f, T).numpy(),
                                      np.asarray(jfused.sigmoid_table16(j, f, T)))


@pytest.mark.parametrize("periodic,dtype,band_rows", [
    (True, "float32", None),
    (False, "float32", 8),
    (True, "bfloat16", 8),
    (False, "bfloat16", None),
])
def test_fused_sweeps_match_jax_interpret(periodic, dtype, band_rows):
    """Three sweeps over a temperature schedule with injected uniforms; the
    JAX side runs one band (band_rows=None) or two (band_rows=8)."""
    R = C = 16
    red, black = _planes(10, R, C)
    U = _uniforms(11, 3, R, C)
    Ts = np.asarray(SCHEDULE, np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        r_j, b_j = jfused.fused_sweeps(
            jnp.int32(0), red.astype(jdt), black.astype(jdt), jnp.asarray(Ts), 3,
            J=J, field=FIELD, periodic=periodic, uniforms=jnp.asarray(U),
            band_rows=band_rows)
    tdt = getattr(torch, dtype)
    r_t, b_t = fused_sweeps(0, _t(red, tdt), _t(black, tdt), Ts, 3, J=J,
                            field=FIELD, periodic=periodic,
                            uniforms=torch.from_numpy(U))
    assert r_t.dtype == b_t.dtype == tdt
    np.testing.assert_array_equal(r_t.float().numpy(), np.asarray(r_j, np.float32))
    np.testing.assert_array_equal(b_t.float().numpy(), np.asarray(b_j, np.float32))


def _oracle_halfstep_table(other, update_red, u16, periodic, table):
    """Quantized-table heat-bath halfstep on the JAX package's neighbour sums
    (the oracle construction of tests/test_pallas_interpret.py)."""
    up, down = jcb.wrap_halos(other, periodic)
    nbr = jcb.neighbor_sum_half_halo(other, up, down, update_red, periodic)
    thresh = table[nbr.astype(jnp.int32) + 4]
    return jnp.where(u16 < thresh, 1.0, -1.0)


@pytest.mark.parametrize("periodic", [True, False])
def test_fused_sweeps_r12_match_jax_oracle(periodic):
    """R = 12 is not a multiple of 8, which the JAX fused kernel refuses;
    the port takes it and must equal the JAX oracle."""
    R, C = 12, 20
    red, black = _planes(12, R, C)
    U = _uniforms(13, 3, R, C)
    r_o, b_o = red, black
    for s, T in enumerate(SCHEDULE):
        table = jfused.sigmoid_table16(J, FIELD, T)
        r_o = _oracle_halfstep_table(b_o, True, jnp.asarray(U[s, 0]), periodic, table)
        b_o = _oracle_halfstep_table(r_o, False, jnp.asarray(U[s, 1]), periodic, table)
    r_t, b_t = fused_sweeps(0, _t(red), _t(black), SCHEDULE, 3, J=J,
                            field=FIELD, periodic=periodic,
                            uniforms=torch.from_numpy(U))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_o))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_o))


def test_biased_field_pushes_up_like_jax():
    """A strong +field with mid-scale uniforms drives every spin up."""
    R = C = 16
    red, black = _planes(14, R, C)
    U = np.full((1, 2, R, C // 2), 1 << 15, np.int32)
    with pltpu.force_tpu_interpret_mode():
        r_j, b_j = jfused.fused_sweeps(jnp.int32(0), red, black, 1.0, 1, J=0.0,
                                       field=5.0, periodic=True,
                                       uniforms=jnp.asarray(U))
    r_t, b_t = fused_sweeps(0, _t(red), _t(black), 1.0, 1, J=0.0, field=5.0,
                            periodic=True, uniforms=torch.from_numpy(U))
    assert float(r_t.mean()) == float(b_t.mean()) == 1.0
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))


def test_prng_mode_is_keyed_by_seed_and_sweep():
    black = torch.from_numpy(np.array(_planes(15, 16, 16)[1]))
    table = sigmoid_table16(1.0, 0.0, 1e9)   # every threshold is 2^15
    r1, b1 = fused_sweep(black, table, seed=3, sweep=1)
    r2, b2 = fused_sweep(black, table, seed=3, sweep=1)
    assert torch.equal(r1, r2) and torch.equal(b1, b2)
    for kw in ({"seed": 4, "sweep": 1}, {"seed": 3, "sweep": 2}):
        r3, _ = fused_sweep(black, table, **kw)
        assert not torch.equal(r1, r3)
    r, b = fused_sweeps(3, None, black, 1e9, 2)
    assert abs(float(r.mean())) < 0.3 and abs(float(b.mean())) < 0.3


def test_cpu_sweep_runs_the_plain_version_without_launching():
    red, black = split_checkerboard(torch.ones(8, 8))
    table = sigmoid_table16(1.0, 0.0, 2.0)
    before = fused_sweep.launches
    got = fused_sweep(black, table, seed=1, sweep=0, periodic=False)
    want = fused_sweep_reference(black, table, seed=1, sweep=0, periodic=False)
    assert fused_sweep.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("shape,dtype", [
    ((7, 4), torch.float32),      # odd R
    ((8, 4), torch.float64),      # unsupported dtype
    ((8,), torch.float32),        # not a plane
])
def test_fused_sweep_rejects_bad_planes(shape, dtype):
    with pytest.raises(ValueError):
        fused_sweep(torch.ones(shape, dtype=dtype), sigmoid_table16(1.0, 0.0, 2.0))


def test_fused_sweeps_rejects_misshapen_uniforms():
    _, black = split_checkerboard(torch.ones(8, 8))
    with pytest.raises(ValueError):
        fused_sweeps(0, None, black, 2.0, 2,
                     uniforms=torch.zeros(1, 2, 8, 4, dtype=torch.int32))
