"""The port's bond planes, energies and single-lattice bond half-sweep (its
plain version, on the CPU) against tsu_tpu's bond engine and its Pallas bond
kernel in TPU interpret mode.

Discrete modes (weight planes packed by the port, code planes, the parity
table) are held bit for bit over whole sweeps on injected 24-bit uniforms.
The continuous mode is held one half-sweep at a time from a shared input:
JAX's and torch's ``exp`` may differ by an ulp, so sites whose uniform lies
within CONTINUOUS_BAND of its probability may differ, and only those.
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
from tsu_tpu_torch.ops.checkerboard import merge_checkerboard, split_checkerboard  # noqa: E402
from tsu_tpu_torch.ops.checkerboard_bonds import (  # noqa: E402
    checkerboard_sweeps_bonds,
    color_bond_weights,
    dense_from_bonds,
    lattice_energy_bonds,
    lattice_energy_bonds_planes,
    pack_bond_codes,
)
from tsu_tpu_torch.ops.checkerboard_bonds_kernel import (  # noqa: E402
    bond_halfsweep,
    bond_halfsweep_reference,
    bond_key,
    checkerboard_sweeps_bonds_kernel,
    continuous_band,
)
from tsu_tpu_torch.ops.checkerboard_fused import sigmoid_table  # noqa: E402

R = C = 16
T_DISCRETE = [1.1, 1.3]     # temperatures where the port's 24-bit table equals JAX's


def _spins(seed, shape):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(shape) < 0.5, 1.0, -1.0).astype(np.float32)


def _bonds(seed, kind, shape=(R, C)):
    """Bond planes and field: "pm1" (±1), "zeros" (±1 with a third of the
    vertical bonds zero) or "gauss" (normal bonds and a normal field)."""
    rng = np.random.default_rng(seed)
    if kind == "gauss":
        return (rng.normal(0, 1, shape).astype(np.float32),
                rng.normal(0, 1, shape).astype(np.float32),
                rng.normal(0, 0.3, shape).astype(np.float32))
    Jh = rng.choice([-1.0, 1.0], shape).astype(np.float32)
    Jv = rng.choice([-1.0, 1.0], shape).astype(np.float32)
    if kind == "zeros":
        Jv = np.where(rng.random(shape) < 0.3, 0.0, Jv).astype(np.float32)
    return Jh, Jv, np.float32(0.0)


def _u24(seed, shape):
    return np.random.default_rng(seed).integers(0, 1 << 24, shape, dtype=np.int32)


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("kind", ["pm1", "zeros", "gauss"])
def test_weights_and_codes_equal_jax(kind, periodic):
    Jh, Jv, f = _bonds(1, kind)
    want = jbonds.color_bond_weights(Jh, Jv, f, periodic)
    got = color_bond_weights(torch.from_numpy(Jh), torch.from_numpy(Jv), torch.tensor(f), periodic)
    for color in ("red", "black"):
        for g, w in zip(got[color], want[color]):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if kind == "gauss":
        with pytest.raises(ValueError):
            pack_bond_codes(got)
        return
    codes = pack_bond_codes(got)
    for color in ("red", "black"):
        assert codes[color].dtype == torch.uint8
        np.testing.assert_array_equal(
            codes[color].numpy(),
            np.asarray(jbonds.pack_bond_codes(want)[color], np.float32).astype(np.uint8))


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("kind", ["pm1", "zeros", "gauss"])
def test_interop_carries_weights_and_codes(kind, periodic):
    Jh, Jv, f = _bonds(2, kind)
    jw = jbonds.color_bond_weights(Jh, Jv, f, periodic)
    ported = bond_weights_from_numpy({c: tuple(np.asarray(w) for w in jw[c]) for c in jw})
    own = color_bond_weights(torch.from_numpy(Jh), torch.from_numpy(Jv), torch.tensor(f), periodic)
    for color in ("red", "black"):
        assert all(torch.equal(a, b) for a, b in zip(ported[color], own[color]))
    w16 = {c: tuple(np.asarray(jnp.asarray(w, jnp.bfloat16)) for w in jw[c]) for c in jw}
    assert all(w.dtype == torch.bfloat16 for w in bond_weights_from_numpy(w16)["red"])
    if kind != "gauss":
        codes = bond_weights_from_numpy({c: np.asarray(v) for c, v in
                                         jbonds.pack_bond_codes(jw).items()})
        for color in ("red", "black"):
            assert torch.equal(codes[color], pack_bond_codes(own)[color])


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("kind", ["pm1", "zeros", "gauss"])
def test_energies_equal_jax_and_dense(kind, periodic):
    """Float64 energies, exact for ±J bonds. For Gaussian bonds: the port's
    lattice energy equals the dense float64 energy to 1e-12; JAX's float32
    sum of ~800 terms of order 1 to 1e-4; the plane energy, whose 4-term
    bond sum per site is float32, to 1e-5."""
    Jh, Jv, f = _bonds(3, kind)
    lats = _spins(4, (3, R, C))
    e = lattice_energy_bonds(torch.from_numpy(lats), Jh, Jv, torch.from_numpy(np.broadcast_to(
        f, (R, C)).copy()), periodic=periodic)
    assert e.dtype == torch.float64
    e_jax = np.asarray(jbonds.lattice_energy_bonds(lats, Jh, Jv, f, periodic=periodic))
    J = jbonds.dense_from_bonds(Jh, Jv, periodic=periodic)
    s = lats.reshape(3, -1).astype(np.float64)
    e_dense = -0.5 * np.einsum("bi,ij,bj->b", s, J, s) - s @ np.broadcast_to(f, (R, C)).reshape(-1)
    red, black = split_checkerboard(torch.from_numpy(lats))
    w = color_bond_weights(torch.from_numpy(Jh), torch.from_numpy(Jv), torch.tensor(f), periodic)
    e_planes = lattice_energy_bonds_planes(red.to(torch.bfloat16), black.to(torch.bfloat16), w,
                                           periodic=periodic)
    if kind == "gauss":
        np.testing.assert_allclose(e.numpy(), e_dense, rtol=1e-12)
        np.testing.assert_allclose(e_jax, e_dense, rtol=0, atol=1e-4)
        np.testing.assert_allclose(e_planes.numpy(), e_dense, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(e.numpy(), e_dense)
        np.testing.assert_array_equal(e_jax, e_dense)
        np.testing.assert_array_equal(e_planes.numpy(), e_dense)


def _jax_sweeps(lat, weights, T, n, periodic, U, dtype=jnp.bfloat16, **mode):
    red, black = jcb.split_checkerboard(jnp.asarray(lat))
    with pltpu.force_tpu_interpret_mode():
        r, b = jpallas.checkerboard_sweeps_bonds_pallas(
            jnp.int32(0), red.astype(dtype), black.astype(dtype), weights, T, n,
            periodic=periodic, uniforms=jnp.asarray(U), block_rows=8, **mode)
    return np.asarray(r, np.float32), np.asarray(b, np.float32)


@pytest.mark.parametrize("mode,periodic", [("planes", True), ("planes", False),
                                           ("packed", True), ("packed", False), ("pure", True)])
def test_discrete_sweeps_equal_jax_kernel(mode, periodic):
    """Two sweeps at a per-sweep schedule, bit for bit: the port's discrete
    sweep (packing the weight planes it is given, or taking JAX's codes)
    against the Pallas bond kernel's discrete mode with weight planes, code
    planes, or code planes and the parity table (periodic lattices only)."""
    np.testing.assert_array_equal(sigmoid_table(1.0, 0.0, torch.tensor(T_DISCRETE)).numpy(),
                                  np.stack([np.asarray(jax_sigmoid_table(1.0, 0.0, T))
                                            for T in T_DISCRETE]))
    Jh, Jv, _ = _bonds(5, "pm1" if mode == "pure" else "zeros")
    jw = jbonds.color_bond_weights(Jh, Jv, 0.0, periodic)
    lat = _spins(6, (R, C))
    U = _u24(7, (2, 2, R, C // 2))
    if mode == "planes":
        jax_weights = {c: tuple(jnp.asarray(w, jnp.bfloat16) for w in jw[c]) for c in jw}
        port_weights = bond_weights_from_numpy({c: tuple(map(np.asarray, jw[c])) for c in jw})
        jmode = dict(discrete=True)
    else:
        jax_weights = jbonds.pack_bond_codes(jw)
        port_weights = bond_weights_from_numpy({c: np.asarray(v) for c, v in jax_weights.items()})
        jmode = dict(discrete=True, packed=True, pure=mode == "pure")
    r_j, b_j = _jax_sweeps(lat, jax_weights, jnp.asarray(T_DISCRETE), 2, periodic, U, **jmode)
    red, black = split_checkerboard(torch.from_numpy(lat).to(torch.bfloat16))
    r_t, b_t = checkerboard_sweeps_bonds_kernel(
        0, red, black, port_weights, T_DISCRETE, 2, periodic=periodic, discrete=True,
        pure=mode == "pure", uniforms=torch.from_numpy(U))
    assert r_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(r_t.float().numpy(), r_j)
    np.testing.assert_array_equal(b_t.float().numpy(), b_j)


def test_pure_and_general_tables_agree_without_a_variant():
    """pure=True gives the bits of pure=False (the 9-entry table picks the
    parity table's entries for the even fields of a periodic ±1 lattice)."""
    Jh, Jv, _ = _bonds(8, "pm1")
    codes = pack_bond_codes(color_bond_weights(torch.from_numpy(Jh), torch.from_numpy(Jv)))
    red, black = split_checkerboard(torch.from_numpy(_spins(9, (R, C))).to(torch.bfloat16))
    outs = [checkerboard_sweeps_bonds_kernel(3, red, black, codes, 1.2, 3, discrete=True, pure=p)
            for p in (False, True)]
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("update_red", [True, False])
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("periodic", [True, False])
def test_continuous_halfsweep_equals_jax_kernel_outside_the_band(periodic, wdtype, update_red):
    """Gaussian bonds and a field at T = 1.5, one half-sweep from a shared
    float32 input: equal wherever |u - p| > CONTINUOUS_BAND; the sites inside
    the band (expected ~0 of 128) may differ."""
    Jh, Jv, f = _bonds(10, "gauss")
    jw = jbonds.color_bond_weights(Jh, Jv, f, periodic)
    color = "red" if update_red else "black"
    jdt = jnp.float32 if wdtype == "float32" else jnp.bfloat16
    jax_w = tuple(jnp.asarray(w, jdt) for w in jw[color])
    port_w = bond_weights_from_numpy({c: tuple(np.asarray(jnp.asarray(w, jdt)) for w in jw[c])
                                      for c in jw})[color]
    other = split_checkerboard(torch.from_numpy(_spins(11, (R, C))))[1 if update_red else 0]
    U = _u24(12, (R, C // 2))
    o = jnp.asarray(other.numpy())
    halo = (o[-1:], o[:1]) if periodic else (jnp.zeros_like(o[:1]),) * 2
    with pltpu.force_tpu_interpret_mode():
        want = jpallas.halfsweep_bonds_pallas(jnp.int32(0), 1.5, o, *halo, jax_w,
                                              update_red=update_red, u24=jnp.asarray(U),
                                              block_rows=8)
    got = bond_halfsweep_reference(other, port_w, update_red=update_red, temperature=1.5,
                                   periodic=periodic, uniforms=torch.from_numpy(U))
    band = continuous_band(other, port_w, update_red=update_red, temperature=1.5,
                           periodic=periodic, uniforms=torch.from_numpy(U)).numpy()
    differ = got.numpy() != np.asarray(want)
    assert not (differ & ~band).any()
    assert band.sum() <= 2


@pytest.mark.parametrize("C2", [1, 3, 5, 33])
@pytest.mark.parametrize("R", [8, 16])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("mode", ["codes", "continuous"])
def test_halfsweep_equals_jax_kernel_at_narrow_and_ragged_widths(mode, periodic, R, C2):
    """The widths where the CUDA kernel's strip body takes its edge cases (a
    plane narrower than a Philox group, a ragged last group, a warp past the
    plane's edge), on injected 24-bit uniforms, red on 8 rows and black on
    16: the discrete mode on code planes bit for bit, the continuous mode
    (Gaussian bonds and a field, T = 1.5) outside CONTINUOUS_BAND."""
    update_red = R == 8
    color = "red" if update_red else "black"
    Jh, Jv, f = _bonds(20 + C2, "zeros" if mode == "codes" else "gauss", (R, 2 * C2))
    jw = jbonds.color_bond_weights(Jh, Jv, f, periodic)
    other = split_checkerboard(torch.from_numpy(_spins(21 + C2, (R, 2 * C2))))[
        1 if update_red else 0].contiguous()
    U = _u24(22 + C2, (R, C2))
    o = jnp.asarray(other.numpy())
    halo = (o[-1:], o[:1]) if periodic else (jnp.zeros_like(o[:1]),) * 2
    kw = dict(update_red=update_red, periodic=periodic, uniforms=torch.from_numpy(U))
    if mode == "codes":
        T = T_DISCRETE[0]
        jcodes = jbonds.pack_bond_codes(jw)
        with pltpu.force_tpu_interpret_mode():
            want = jpallas.halfsweep_bonds_pallas(jnp.int32(0), T, o, *halo, jcodes[color],
                                                  update_red=update_red, u24=jnp.asarray(U),
                                                  block_rows=8, discrete=True, packed=True)
        codes = bond_weights_from_numpy({c: np.asarray(v) for c, v in jcodes.items()})[color]
        got = bond_halfsweep_reference(other, codes, table=sigmoid_table(1.0, 0.0, T), **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    with pltpu.force_tpu_interpret_mode():
        want = jpallas.halfsweep_bonds_pallas(jnp.int32(0), 1.5, o, *halo, tuple(jw[color]),
                                              update_red=update_red, u24=jnp.asarray(U),
                                              block_rows=8)
    w = bond_weights_from_numpy({c: tuple(map(np.asarray, jw[c])) for c in jw})[color]
    got = bond_halfsweep_reference(other, w, temperature=1.5, **kw)
    band = continuous_band(other, w, temperature=1.5, **kw).numpy()
    assert not ((got.numpy() != np.asarray(want)) & ~band).any()


def test_generator_sweeps_reach_the_cold_and_hot_limits():
    """The generator-driven plain sweep: at T -> 0 with ferromagnetic bonds a
    sweep aligns every spin with its neighbours' majority; at T = 1e9 the
    result is a fair coin."""
    ones = torch.ones(R, C)
    w = color_bond_weights(ones, ones)
    gen = torch.Generator().manual_seed(0)
    red, black = split_checkerboard(torch.ones(R, C))
    red, black = checkerboard_sweeps_bonds(gen, red, black, w, 1e-3, 2)
    assert merge_checkerboard(red, black).eq(1).all()
    red, black = checkerboard_sweeps_bonds(gen, red, black, w, 1e9, 4)
    assert abs(float(merge_checkerboard(red, black).mean())) < 0.2


def test_philox_keys_differ_by_colour_and_sweep():
    assert len({bond_key(5, c, k) for c in (0, 1) for k in (0, 1)}) == 4
    other = split_checkerboard(torch.from_numpy(_spins(13, (R, C))))[1]
    codes = pack_bond_codes(color_bond_weights(torch.ones(R, C), torch.ones(R, C)))["red"]
    table = sigmoid_table(1.0, 0.0, 2.0)
    a, b = (bond_halfsweep(other, codes, update_red=True, table=table, key=bond_key(5, c, 0))
            for c in (0, 1))
    assert not torch.equal(a, b)


def test_cpu_call_runs_the_plain_version_without_launching():
    other = split_checkerboard(torch.from_numpy(_spins(14, (8, 8))))[1]
    w = color_bond_weights(torch.ones(8, 8), -torch.ones(8, 8))["red"]
    before = bond_halfsweep.launches
    got = bond_halfsweep(other, w, update_red=True, temperature=2.0, key=(1, 2))
    want = bond_halfsweep_reference(other, w, update_red=True, temperature=2.0, key=(1, 2))
    assert bond_halfsweep.launches == before and torch.equal(got, want)


_OTHER = torch.ones(8, 4)
_W = color_bond_weights(torch.ones(8, 8), torch.ones(8, 8))["red"]
_CODES = pack_bond_codes(color_bond_weights(torch.ones(8, 8), torch.ones(8, 8)))["red"]
_TABLE = sigmoid_table(1.0, 0.0, 2.0)


@pytest.mark.parametrize("kw", [
    {"other": torch.ones(7, 4)},                                     # odd R
    {"other": torch.ones(2, 8, 4)},                                  # batched plane
    {"other": torch.ones(8, 4, dtype=torch.float64)},                # dtype
    {"weights": _W[:4]},                                             # four planes
    {"weights": (_W[0].double(), *_W[1:])},                          # a float64 plane
    {"weights": (_W[0].bfloat16(), *_W[1:])},                        # mixed dtypes
    {"weights": tuple(w[:4] for w in _W)},                           # shape
    {"weights": _CODES.int()},                                       # codes not uint8
    {"weights": _CODES, "temperature": 2.0, "table": None},          # codes without a table
    {"weights": _W, "table": _TABLE},                                # planes with a table
    {"weights": _CODES, "table": _TABLE.long()},                     # table not int32
    {"uniforms": torch.zeros(8, 4, dtype=torch.int64)},              # uniforms not int32
])
def test_halfsweep_rejects_misshapen_operands(kw):
    args = {"other": _OTHER, "weights": _W, "temperature": 2.0, "table": None,
            "uniforms": None, **kw}
    if "table" in kw and kw["table"] is not None:
        args["temperature"] = None
    with pytest.raises(ValueError):
        bond_halfsweep(args["other"], args["weights"], update_red=True,
                       temperature=args["temperature"], table=args["table"],
                       uniforms=args["uniforms"])


@pytest.mark.parametrize("shape", [(4, 4), (5, 3), (8, 8), (2, 2), (1, 3)])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("kind", ["pm1", "gauss"])
def test_dense_from_bonds_equals_jax(kind, periodic, shape):
    """The dense coupling matrix equals the JAX package's bit for bit
    (float64), from numpy bonds and from tensors; the 2 x 2 and 1 x 3
    lattices add two bonds into one entry, or a bond onto the diagonal."""
    Jh, Jv, _ = _bonds(11, kind, shape)
    ref = jbonds.dense_from_bonds(Jh, Jv, periodic=periodic)
    for bonds in ((Jh, Jv), (torch.from_numpy(Jh), torch.from_numpy(Jv))):
        J = dense_from_bonds(*bonds, periodic=periodic)
        assert J.dtype == np.float64 and J.shape == ref.shape
        np.testing.assert_array_equal(J, ref)
