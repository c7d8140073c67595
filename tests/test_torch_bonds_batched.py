"""The port's batched bond half-sweep (its plain version, on the CPU) against
tsu_tpu's unbatched Pallas bond kernel in TPU interpret mode, element by
element.

The JAX batched bond kernel has no injection mode and its interpret-mode
PRNG ignores the seed, so the only oracle for the port's batched kernel is
the unbatched JAX kernel on injected uniforms: element b of the port's
batched sweep, fed the uniforms of replica b, equals the JAX kernel at
replica b's temperature. Discrete mode bit for bit over whole sweeps;
continuous mode one half-sweep at a time outside CONTINUOUS_BAND. In Philox
mode element b equals the port's single-lattice plain version under the
matching key.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tsu_tpu.ops import checkerboard as jcb  # noqa: E402
from tsu_tpu.ops import checkerboard_bonds as jbonds  # noqa: E402
from tsu_tpu.ops import checkerboard_bonds_pallas as jpallas  # noqa: E402
from tsu_tpu.ops.checkerboard_fused import sigmoid_table as jax_sigmoid_table  # noqa: E402
from tsu_tpu_torch.interop import bond_weights_from_numpy  # noqa: E402
from tsu_tpu_torch.ops.checkerboard import split_checkerboard  # noqa: E402
from tsu_tpu_torch.ops.checkerboard_bonds import color_bond_weights, pack_bond_codes  # noqa: E402
from tsu_tpu_torch.ops.checkerboard_bonds_kernel import (  # noqa: E402
    bond_halfsweep_batched,
    bond_halfsweep_batched_reference,
    bond_halfsweep_reference,
    bond_modes,
    bond_sweep_keys,
    bond_sweeps_keyed,
    checkerboard_sweeps_bonds_batched,
    continuous_band,
)
from tsu_tpu_torch.ops.checkerboard_fused import MAX_BATCH, sigmoid_table  # noqa: E402

B, R, C = 3, 16, 16
TEMPS = [0.8, 1.5, 3.0]    # one per replica; both packages' 24-bit tables agree here


def _spins(seed, shape):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(shape) < 0.5, 1.0, -1.0).astype(np.float32)


def _pm1(seed, zeros=False):
    rng = np.random.default_rng(seed)
    Jh = rng.choice([-1.0, 1.0], (R, C)).astype(np.float32)
    Jv = rng.choice([-1.0, 1.0], (R, C)).astype(np.float32)
    if zeros:
        Jh = np.where(rng.random((R, C)) < 0.3, 0.0, Jh).astype(np.float32)
    return Jh, Jv


@pytest.mark.parametrize("periodic", [True, False])
def test_discrete_batched_element_equals_jax_unbatched(periodic):
    np.testing.assert_array_equal(sigmoid_table(1.0, 0.0, torch.tensor(TEMPS)).numpy(),
                                  np.stack([np.asarray(jax_sigmoid_table(1.0, 0.0, T))
                                            for T in TEMPS]))
    Jh, Jv = _pm1(1, zeros=True)
    codes_j = jbonds.pack_bond_codes(jbonds.color_bond_weights(Jh, Jv, 0.0, periodic))
    codes = bond_weights_from_numpy({c: np.asarray(v) for c, v in codes_j.items()})
    lats = _spins(2, (B, R, C))
    U = np.random.default_rng(3).integers(0, 1 << 24, (2, B, 2, R, C // 2), dtype=np.int32)
    reds, blacks = split_checkerboard(torch.from_numpy(lats).to(torch.bfloat16))
    r_t, b_t = checkerboard_sweeps_bonds_batched([11, 22, 33], reds, blacks, codes, TEMPS, 2,
                                                 periodic=periodic, discrete=True,
                                                 uniforms=torch.from_numpy(U))
    with pltpu.force_tpu_interpret_mode():
        for b in range(B):
            red, black = jcb.split_checkerboard(jnp.asarray(lats[b]))
            r_j, b_j = jpallas.checkerboard_sweeps_bonds_pallas(
                jnp.int32(0), red.astype(jnp.bfloat16), black.astype(jnp.bfloat16), codes_j,
                TEMPS[b], 2, periodic=periodic, uniforms=jnp.asarray(U[:, b]), block_rows=8,
                discrete=True, packed=True)
            np.testing.assert_array_equal(r_t[b].float().numpy(), np.asarray(r_j, np.float32))
            np.testing.assert_array_equal(b_t[b].float().numpy(), np.asarray(b_j, np.float32))


@pytest.mark.parametrize("update_red", [True, False])
@pytest.mark.parametrize("periodic", [True, False])
def test_continuous_batched_element_equals_jax_unbatched(periodic, update_red):
    """Gaussian bonds and field, one half-sweep from a shared input at each
    replica's temperature: equal outside CONTINUOUS_BAND."""
    rng = np.random.default_rng(4)
    Jh, Jv = rng.normal(size=(2, R, C)).astype(np.float32)
    f = rng.normal(0, 0.3, (R, C)).astype(np.float32)
    jw = jbonds.color_bond_weights(Jh, Jv, f, periodic)
    color = "red" if update_red else "black"
    w = bond_weights_from_numpy({c: tuple(map(np.asarray, jw[c])) for c in jw})[color]
    others = split_checkerboard(torch.from_numpy(_spins(5, (B, R, C))))[1 if update_red else 0]
    U = torch.from_numpy(rng.integers(0, 1 << 24, (B, R, C // 2), dtype=np.int32))
    temps = torch.tensor(TEMPS)
    keys = bond_sweep_keys([1, 2, 3], 1)[0, 0]
    got = bond_halfsweep_batched_reference(others, w, keys, update_red=update_red,
                                           periodic=periodic, temperatures=temps, uniforms=U)
    band = continuous_band(others, w, update_red=update_red, temperature=temps, key=keys,
                           periodic=periodic, uniforms=U).numpy()
    with pltpu.force_tpu_interpret_mode():
        for b in range(B):
            o = jnp.asarray(others[b].numpy())
            halo = (o[-1:], o[:1]) if periodic else (jnp.zeros_like(o[:1]),) * 2
            want = jpallas.halfsweep_bonds_pallas(jnp.int32(0), TEMPS[b], o, *halo, jw[color],
                                                  update_red=update_red,
                                                  u24=jnp.asarray(U[b].numpy()), block_rows=8)
            differ = got[b].numpy() != np.asarray(want)
            assert not (differ & ~band[b]).any(), b
    assert band.sum() <= 3


@pytest.mark.parametrize("mode", ["discrete", "continuous"])
def test_philox_element_equals_single_lattice_plain_version(mode):
    """Element b of the batched half-sweep is the single-lattice half-sweep
    under key row b and replica b's temperature or table."""
    rng = np.random.default_rng(6)
    Jh, Jv = (rng.choice([-1.0, 1.0], (2, 12, 20)) if mode == "discrete"
              else rng.normal(size=(2, 12, 20))).astype(np.float32)
    w = color_bond_weights(torch.from_numpy(Jh), torch.from_numpy(Jv), 0.0, False)
    if mode == "discrete":
        w = pack_bond_codes(w)
    others = split_checkerboard(torch.from_numpy(_spins(7, (B, 12, 20))))[1]
    keys = bond_sweep_keys([5, 6, 7], 2)[1, 1]      # sweep 1, black
    modes = bond_modes(TEMPS, mode == "discrete", "cpu")
    got = bond_halfsweep_batched(others, w["black"], keys, update_red=False, periodic=False,
                                 **modes)
    for b in range(B):
        kw = ({"table": modes["tables"][b]} if mode == "discrete"
              else {"temperature": TEMPS[b]})
        one = bond_halfsweep_reference(others[b], w["black"], update_red=False,
                                       key=tuple(int(k) & 0xFFFFFFFF for k in keys[b]),
                                       periodic=False, **kw)
        assert torch.equal(one, got[b]), b


def test_keyed_sweeps_take_a_row_per_sweep():
    """(n, B) temperatures give sweep k its own row (the pilot's annealing
    schedule); zero keys give back the input planes."""
    Jh, Jv = _pm1(8)
    w = pack_bond_codes(color_bond_weights(torch.from_numpy(Jh), torch.from_numpy(Jv)))
    reds, blacks = split_checkerboard(torch.from_numpy(_spins(9, (B, R, C))))
    sched = np.array([[4.0, 3.0, 2.0], [2.0, 1.5, 1.0], [1.0, 0.7, 0.5]], np.float32)
    keys = bond_sweep_keys([1, 2, 3], 3)
    r_t, b_t = bond_sweeps_keyed(reds, blacks, w, keys, **bond_modes(sched, True, "cpu"))
    red, black = reds, blacks
    for k in range(3):
        red, black = bond_sweeps_keyed(red, black, w, keys[k:k + 1],
                                       **bond_modes(sched[k], True, "cpu"))
    assert torch.equal(red, r_t) and torch.equal(black, b_t)
    same = bond_sweeps_keyed(reds, blacks, w, keys[:0], **bond_modes(sched[0], True, "cpu"))
    assert same[0] is reds and same[1] is blacks


def test_sweep_keys_fold_the_seed_and_count_half_sweeps():
    keys = bond_sweep_keys(np.array([[3, 4]]), 2)
    assert keys.shape == (1, 2, 2, 2, 2) and keys.dtype == torch.int32
    assert keys[0, :, :, 0, 1].flatten().tolist() == [0, 1, 2, 3]
    assert keys[0, 1, 1, :, 0].tolist() == keys[0, 0, 0, :, 0].tolist()


def test_cpu_call_runs_the_plain_version_without_launching():
    others = split_checkerboard(torch.from_numpy(_spins(10, (2, 8, 8))))[0]
    w = color_bond_weights(torch.ones(8, 8), torch.ones(8, 8))["black"]
    keys = bond_sweep_keys([1, 2], 1)[0, 1]
    temps = torch.tensor([1.0, 2.0])
    before = bond_halfsweep_batched.launches
    got = bond_halfsweep_batched(others, w, keys, update_red=False, temperatures=temps)
    want = bond_halfsweep_batched_reference(others, w, keys, update_red=False, temperatures=temps)
    assert bond_halfsweep_batched.launches == before and torch.equal(got, want)


_OTHERS = torch.ones(2, 8, 4)
_W = color_bond_weights(torch.ones(8, 8), torch.ones(8, 8))["red"]
_CODES = pack_bond_codes(color_bond_weights(torch.ones(8, 8), torch.ones(8, 8)))["red"]
_KEYS = bond_sweep_keys([1, 2], 1)[0, 0]
_TEMPS = torch.tensor([1.0, 2.0])


@pytest.mark.parametrize("kw", [
    {"others": torch.ones(8, 4)},                                    # not batched
    {"others": torch.ones(2, 6, 4)},                                 # plane shape != weights'
    {"keys": _KEYS[:1]},                                             # one row short
    {"keys": _KEYS.long()},                                          # not int32
    {"temperatures": _TEMPS[:1]},                                    # one short
    {"temperatures": _TEMPS.double()},                               # not float32
    {"temperatures": None},                                          # no mode
    {"weights": _CODES},                                             # codes with temperatures
    {"weights": _CODES, "temperatures": None,
     "tables": sigmoid_table(1.0, 0.0, 2.0)},                        # one table for two replicas
    {"uniforms": torch.zeros(2, 2, 8, 4, dtype=torch.int32)},        # a sweep's, not a half's
    {"others": torch.ones(MAX_BATCH + 1, 2, 1), "weights": tuple(w[:2, :1] for w in _W),
     "keys": torch.zeros(MAX_BATCH + 1, 2, dtype=torch.int32),
     "temperatures": torch.ones(MAX_BATCH + 1)},                     # B above the grid's z
])
def test_batched_halfsweep_rejects_misshapen_operands(kw):
    args = {"others": _OTHERS, "weights": _W, "keys": _KEYS, "temperatures": _TEMPS,
            "tables": None, "uniforms": None, **kw}
    with pytest.raises(ValueError):
        bond_halfsweep_batched(args["others"], args["weights"], args["keys"], update_red=True,
                               temperatures=args["temperatures"], tables=args["tables"],
                               uniforms=args["uniforms"])
