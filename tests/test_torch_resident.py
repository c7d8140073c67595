"""The resident multi-sweep path (K6, K7) on the CPU.

The JAX package's resident kernels draw their uniforms from the TPU's PRNG,
which interpret mode does not reproduce (from all-ones at T = 2.5 its bits
flip no spin), and they take no injected uniforms. So the plain versions are
held, bit for bit and half-step by half-step, against the JAX functions that
compose the same arithmetic outside a kernel: ``neighbor_sum_half`` then
``_heatbath_table`` on the same 24-bit uniforms and JAX's own tables. The
Philox mode is held to exact enumeration, to an anneal's energy and to the
fused sweep's moments."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tsu_tpu.oracle import exact_ising_moments  # noqa: E402
from tsu_tpu.ops.checkerboard import neighbor_sum_half as jax_neighbor_sum_half  # noqa: E402
from tsu_tpu.ops.checkerboard_fused import _heatbath_table  # noqa: E402
from tsu_tpu.ops.checkerboard_fused import sigmoid_table as jax_sigmoid_table  # noqa: E402
import tsu_tpu_torch  # noqa: E402
from tsu_tpu_torch.ops.checkerboard import plane_energy_batch, split_checkerboard  # noqa: E402
from tsu_tpu_torch.ops.checkerboard_fused import fused_sweeps, sigmoid_table  # noqa: E402
from tsu_tpu.ops.checkerboard_resident import resident_fits  # noqa: E402
from tsu_tpu_torch.config import ConfigurationError  # noqa: E402
from tsu_tpu_torch.ops import checkerboard_resident as resident_module  # noqa: E402
from tsu_tpu_torch.ops.checkerboard_resident import (  # noqa: E402
    TABLE_BYTES,
    WARP_WORDS,
    resident_anneal,
    resident_anneal_reference,
    resident_anneal_tables,
    resident_anneal_tables_reference,
    resident_sweeps,
    resident_sweeps_reference,
    resident_sweeps_table,
    resident_grid,
    resident_plan,
    resident_sweeps_table_reference,
    tile_bounds,
)

J, FIELD = 0.7, 0.1
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
SHAPES = [(18, 20), (16, 10)]      # 18: R not a multiple of the reference's 16-row chunks
SCHEDULE = np.geomspace(4.0, 0.3, 6).astype(np.float32)


def _planes(seed, shape, dtype):
    lat = np.where(np.random.default_rng(seed).random(shape) < 0.5, 1.0, -1.0)
    return split_checkerboard(torch.from_numpy(lat).to(dtype))


def _u24(seed, n_sweeps, shape):
    R, C = shape
    u = np.random.default_rng(seed).integers(0, 1 << 24, (n_sweeps, 2, R, C // 2))
    return torch.from_numpy(u.astype(np.int32))


def _jax_half_steps(black, tables, uniforms, periodic, dtype):
    """The reference composition, sweep by sweep: (red, black) as float32
    numpy after every sweep."""
    black = jnp.asarray(black.float().numpy())
    out = []
    for s in range(len(tables)):
        table, u = jnp.asarray(tables[s]), uniforms[s].numpy()
        red = _heatbath_table(jax_neighbor_sum_half(black, True, periodic), jnp.asarray(u[0]),
                              table, JAX_DTYPES[dtype], even_only=periodic).astype(jnp.float32)
        black = _heatbath_table(jax_neighbor_sum_half(red, False, periodic), jnp.asarray(u[1]),
                                table, JAX_DTYPES[dtype], even_only=periodic).astype(jnp.float32)
        out.append((np.asarray(red), np.asarray(black)))
    return out


def _assert_planes(got, want, what):
    for g, w, colour in zip(got, want, ("red", "black")):
        np.testing.assert_array_equal(g.float().numpy(), w, err_msg=f"{what}, {colour}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_resident_sweeps_equal_jax_composition(shape, periodic, dtype):
    """K6's plain version at JAX's table for J = 0.7, field = 0.1, T = 2.3:
    every half-step of 3 sweeps run one at a time, and the 3 in one call."""
    red, black = _planes(1, shape, dtype)
    U = _u24(2, 3, shape)
    table = np.array(jax_sigmoid_table(J, FIELD, 2.3))
    want = _jax_half_steps(black, [table] * 3, U, periodic, dtype)
    t = torch.from_numpy(table)
    r, b = red, black
    for s in range(3):
        r, b = resident_sweeps_table_reference(0, r, b, t, 1, periodic=periodic,
                                               uniforms=U[s:s + 1])
        assert r.dtype == b.dtype == dtype
        _assert_planes((r, b), want[s], f"sweep {s}")
    _assert_planes(resident_sweeps_table_reference(0, red, black, t, 3, periodic=periodic,
                                                   uniforms=U), want[-1], "one call")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_resident_anneal_equals_jax_composition(shape, periodic, dtype):
    """K7's plain version on JAX's tables of a 6-sweep geometric schedule:
    sweep s uses row s, half-step by half-step and in one call."""
    red, black = _planes(3, shape, dtype)
    U = _u24(4, len(SCHEDULE), shape)
    tables = np.array(jax.vmap(lambda T: jax_sigmoid_table(J, FIELD, T))(jnp.asarray(SCHEDULE)))
    want = _jax_half_steps(black, tables, U, periodic, dtype)
    t = torch.from_numpy(tables)
    r, b = red, black
    for s in range(len(SCHEDULE)):
        r, b = resident_anneal_tables_reference(0, r, b, t[s:s + 1], periodic=periodic,
                                                uniforms=U[s:s + 1])
        _assert_planes((r, b), want[s], f"sweep {s}")
    _assert_planes(resident_anneal_tables_reference(0, red, black, t, periodic=periodic,
                                                    uniforms=U), want[-1], "one call")


@pytest.mark.parametrize("periodic", [True, False])
def test_signature_functions_use_the_ports_tables(periodic):
    """resident_sweeps and resident_anneal are the table functions at the
    port's sigmoid_table, which stays within 2 counts of JAX's; on a CPU
    tensor the wrappers run the plain versions and leave their inputs alone."""
    red, black = _planes(5, (18, 20), torch.bfloat16)
    before = red.clone(), black.clone()
    U = _u24(6, len(SCHEDULE), (18, 20))
    ours = sigmoid_table(J, FIELD, torch.from_numpy(SCHEDULE))
    theirs = np.asarray(jax.vmap(lambda T: jax_sigmoid_table(J, FIELD, T))(jnp.asarray(SCHEDULE)))
    assert np.abs(ours.numpy().astype(np.int64) - theirs).max() <= 2
    kw = dict(J=J, field=FIELD, periodic=periodic)
    got = resident_anneal(9, red, black, SCHEDULE, uniforms=U, **kw)
    _assert_planes(got, [x.float().numpy() for x in resident_anneal_tables_reference(
        9, red, black, ours, periodic=periodic, uniforms=U)], "anneal")
    _assert_planes(got, [x.float().numpy() for x in resident_anneal_reference(
        9, red, black, SCHEDULE, uniforms=U, **kw)], "anneal plain")
    got = resident_sweeps(9, red, black, 2.3, 4, uniforms=U[:4], **kw)
    _assert_planes(got, [x.float().numpy() for x in resident_sweeps_reference(
        9, red, black, 2.3, 4, uniforms=U[:4], **kw)], "sweeps")
    _assert_planes(got, [x.float().numpy() for x in resident_sweeps_table(
        9, red, black, sigmoid_table(J, FIELD, 2.3), 4, periodic=periodic, uniforms=U[:4])],
        "sweeps table")
    assert torch.equal(red, before[0]) and torch.equal(black, before[1])
    assert resident_sweeps_table.launches == resident_anneal_tables.launches == 0
    assert tsu_tpu_torch.resident_sweeps is resident_sweeps


def test_philox_stream_is_keyed_per_sweep_and_colour():
    """An anneal over two equal tables is the two-sweep call at that table;
    another seed gives other planes; zero sweeps change nothing; tables that
    do not fit the sweeps and an odd R raise."""
    red, black = _planes(7, (16, 24), torch.float32)
    table = sigmoid_table(1.0, 0.0, 2.269)
    tables = table.expand(2, 9).contiguous()
    two = resident_anneal_tables(11, red, black, tables)
    assert not torch.equal(two[1], resident_anneal_tables(12, red, black, tables)[1])
    assert torch.equal(two[0], resident_sweeps_table(11, red, black, table, 2)[0])
    r, b = resident_sweeps_table(3, red, black, table, 0)
    assert torch.equal(r, red) and torch.equal(b, black)
    with pytest.raises(ValueError):
        resident_sweeps_table(0, red, black, tables, 2)        # per-sweep tables to K6
    with pytest.raises(ValueError):
        resident_anneal_tables(0, red, black, table)           # one table to K7
    with pytest.raises(ValueError):
        resident_sweeps(0, red[:3], black[:3], 2.0, 1)         # odd R


def _dense_grid_couplings(R, C):
    Jd = np.zeros((R * C, R * C))
    for r in range(R):
        for c in range(C):
            i = r * C + c
            for j in (r * C + (c + 1) % C, ((r + 1) % R) * C + c):
                Jd[i, j] = Jd[j, i] = 1.0
    return Jd


def _batch_means_se(x, n_batches=30):
    b = np.asarray(x, np.float64)[: len(x) // n_batches * n_batches]
    return b.reshape(n_batches, -1).mean(axis=1).std(ddof=1) / np.sqrt(n_batches)


def _moments(step, shape, T, n_samples, thin, periodic=True):
    """|m| and e per site of n_samples samples thin sweeps apart, after 50
    burn-in sweeps from all-ones."""
    red, black = split_checkerboard(torch.ones(shape))
    red, black = step(0, red, black, T, 50)
    m, e = [], []
    for i in range(n_samples):
        red, black = step(1 + i, red, black, T, thin)
        m.append(float(red.sum() + black.sum()) / red.numel() / 2)
        e.append(float(plane_energy_batch(red, black, periodic=periodic)) / red.numel() / 2)
    return np.abs(m), np.asarray(e)


def test_resident_sweeps_match_exact_enumeration():
    """4x4 periodic at T = 2.5 in Philox mode: <|m|> and <e> per site within
    4 standard errors of exact enumeration."""
    m, e = _moments(lambda i, r, b, T, n: resident_sweeps(1 + 7919 * i, r, b, T, n),
                    (4, 4), 2.5, 3000, 1)
    exact = exact_ising_moments(_dense_grid_couplings(4, 4), np.zeros(16), 2.5)
    assert abs(m.mean() - exact["abs_magnetization"]) < 4 * _batch_means_se(m)
    assert abs(e.mean() - exact["energy"] / 16) < 4 * _batch_means_se(e)


def test_resident_anneal_reaches_ground_state():
    """tests/test_tpu_kernels2.py's anneal: a random 64^2 start, 2000 sweeps
    geometric from T = 5 to 0.05, ends below -1.85 per site."""
    red, black = _planes(0, (64, 64), torch.float32)
    red, black = resident_anneal(5, red, black, np.geomspace(5.0, 0.05, 2000).astype(np.float32))
    assert float(plane_energy_batch(red, black)) / (64 * 64) < -1.85


@pytest.mark.parametrize("periodic", [True, False])
def test_resident_matches_fused_sweeps(periodic):
    """tests/test_tpu_kernels2.py's comparison at 16^2, T = 3.0, samples 2
    sweeps apart: <|m|> within 0.02 and <e> within 0.03 of the fused sweep."""
    def resident(i, r, b, T, n):
        return resident_sweeps(91 + 100003 * i, r, b, T, n, periodic=periodic)

    def fused(i, r, b, T, n):
        return fused_sweeps(77 + 100003 * i, r, b, T, n, periodic=periodic)

    m_r, e_r = _moments(resident, (16, 16), 3.0, 1500, 2, periodic)
    m_f, e_f = _moments(fused, (16, 16), 3.0, 1500, 2, periodic)
    assert m_r.mean() == pytest.approx(m_f.mean(), abs=0.02)
    assert e_r.mean() == pytest.approx(e_f.mean(), abs=0.03)


# The tile plan of the resident kernel on the card (H100 SXM: 132 SMs, 232,448 B
# of shared memory a block may opt in to).
H100_SMS, H100_SMEM = 132, 232448
CHIP_SHAPES = [(4, 4), (2, 2), (64, 64), (18, 20), (34, 522), (130, 250), (512, 512),
               (1002, 1000), (4096, 4096), (8192, 8192)]


@pytest.mark.parametrize("blocks", [1, 5, 132, 264])
@pytest.mark.parametrize("shape", CHIP_SHAPES + [(16, 1 << 21), (4096, 4094), (2, 66)])
def test_resident_plan_puts_every_site_in_one_tile(shape, blocks):
    """Every row lies in exactly one band and every word of a row in exactly
    one range; bands and ranges differ by at most one row or word, fit the
    plan's shared memory, and there are no more tiles than blocks."""
    R, C2 = shape[0], shape[1] // 2
    plan = resident_plan(R, C2, blocks, 1 << 40)
    assert plan is not None and plan.blocks <= blocks and plan.ranges == 1
    W = -(-C2 // 32)
    tiles = tile_bounds(plan, R, C2)
    cover = np.zeros((R, W), dtype=int)
    for r0, nr, w0, nw in tiles:
        assert 1 <= nr <= plan.rows and 1 <= nw
        assert WARP_WORDS * -(-nw // WARP_WORDS) + 2 <= plan.stride
        cover[r0:r0 + nr, w0:w0 + nw] += 1
    assert (cover == 1).all()
    assert max(t[1] for t in tiles) - min(t[1] for t in tiles) <= 1
    assert plan.smem_bytes == TABLE_BYTES + 2 * (plan.rows + 2) * plan.stride * 4


@pytest.mark.parametrize("shape,blocks", [((16, 1 << 21), 132), ((4, 2000), 8), ((14, 1000), 8),
                                          ((6, 514), 8)])
def test_resident_plan_splits_rows_into_ranges_when_bands_do_not_fit(shape, blocks):
    """Below the shared memory whole rows need, the plan cuts rows into
    ranges of words, each word of a row in exactly one range."""
    R, C2 = shape[0], shape[1] // 2
    whole = resident_plan(R, C2, blocks, 1 << 40)
    smem = min(whole.smem_bytes - 1, H100_SMEM)
    plan = resident_plan(R, C2, blocks, smem)
    assert plan is not None and plan.ranges > 1 and plan.smem_bytes <= smem
    W = -(-C2 // 32)
    cover = np.zeros((R, W), dtype=int)
    for r0, nr, w0, nw in tile_bounds(plan, R, C2):
        cover[r0:r0 + nr, w0:w0 + nw] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("itemsize", [2, 4])
def test_resident_plan_admits_every_shape_the_reference_admits(itemsize):
    """Every shape the reference's resident kernel runs fits the card's
    plan: R a multiple of its 16-row chunks, planes within resident_fits's 48
    MB, and the planes as the TPU lays them out in VMEM (C2 padded to 128
    lanes) within its 128 MB, at the widest C2 of each R."""
    R = 16
    while True:
        C2 = (48 * 2**20) // (2 * R * itemsize)
        while C2 and -(-C2 // 128) * 128 * 2 * R * itemsize > 128 * 2**20:
            C2 = (128 * 2**20 // (2 * R * itemsize)) // 128 * 128
        if C2 < 1:
            break
        assert resident_fits(R, C2, itemsize), (R, C2)
        assert resident_plan(R, C2, H100_SMS, H100_SMEM) is not None, (R, C2)
        R += 16 if R < 4096 else 4096


@pytest.mark.parametrize("shape", CHIP_SHAPES + [(15360, 15360)])
def test_resident_plan_admits_the_chip_shapes(shape):
    assert resident_plan(shape[0], shape[1] // 2, H100_SMS, H100_SMEM) is not None


@pytest.mark.parametrize("shape", [(16384, 16384), (2, 1 << 28)])
def test_resident_plan_refuses_lattices_above_the_card(shape):
    assert resident_plan(shape[0], shape[1] // 2, H100_SMS, H100_SMEM) is None


def test_resident_grid_takes_the_most_resident_blocks_and_raises_above_the_limit(monkeypatch):
    """resident_grid against a stand-in card (132 SMs, up to 2 blocks an SM,
    one if a block holds more than half an SM's shared memory): the most
    blocks that stay resident, and ConfigurationError naming the limit."""
    resident_grid.cache_clear()
    monkeypatch.setattr(resident_module, "_card_limits", lambda index: (132, 232448))
    monkeypatch.setattr(resident_module, "_blocks_per_sm",
                        lambda index, smem, bf16: 2 if smem <= 115 * 1024 else 1)
    try:
        plan = resident_grid(4096, 2048)
        assert (plan.bands, plan.ranges, plan.rows) == (264, 1, 16)
        plan = resident_grid(15360, 7680)
        assert (plan.bands, plan.ranges, plan.rows) == (132, 1, 117)
        with pytest.raises(ConfigurationError, match="232448 B of shared memory"):
            resident_grid(16384, 8192)
    finally:
        resident_grid.cache_clear()
