"""The port's exact-sigmoid half-sweep (K3's plain version, on the CPU)
against tsu_tpu's ``halfsweep_pallas`` run in TPU interpret mode, and the
2-D halo neighbour sums against the JAX package's; the kernel's threshold
table against the probability compare it replaces, and the sharded path's
column halos, which the kernel reads in place.

Both sides get the same planes, halos and injected 24-bit uniforms, made
with numpy from a seed. torch's and XLA's ``exp`` may differ by an ulp, so
the planes must agree at every site outside the band |u - p| <= 1e-6
(``CONTINUOUS_BAND``), as tests/test_pallas_interpret.py holds the bond
kernel. The CUDA kernel is held against the same plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tsu_tpu.ops import checkerboard as jcb  # noqa: E402
from tsu_tpu.ops import checkerboard_pallas as jpal  # noqa: E402
from tsu_tpu_torch.ops.checkerboard import (  # noqa: E402
    halfstep_with_halo2d,
    neighbor_sum_half_halo2d,
    split_checkerboard,
)
from tsu_tpu_torch.ops.checkerboard_kernel import (  # noqa: E402
    _kernel_operands,
    checkerboard_sweeps_planes_kernel,
    halfsweep,
    halfsweep_band,
    halfsweep_reference,
    halfsweep_thresholds,
)
from tsu_tpu_torch.parallel import lattice, make_mesh, sharded_checkerboard_sweeps  # noqa: E402
from tsu_tpu_torch.parallel.lattice import _halo_exchange_cols  # noqa: E402
from tsu_tpu_torch.rng import philox_words  # noqa: E402

T = 2.269
# J and field per plane dtype: the reference computes the local field in the
# plane's dtype, the port in float32, so bf16 cases use values exact in bf16.
COUPLING = {"float32": (1.0, 0.1), "bfloat16": (0.75, 0.25)}


def _spins(rng, shape):
    return np.where(rng.random(shape) < 0.5, 1.0, -1.0).astype(np.float32)


def _both(x, dtype):
    """(jax array, torch tensor) of a numpy array in ``dtype``, or Nones."""
    if x is None:
        return None, None
    return jnp.asarray(x, getattr(jnp, dtype)), torch.as_tensor(x, dtype=getattr(torch, dtype))


@pytest.mark.parametrize("update_red", [True, False])
@pytest.mark.parametrize("col_halo", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("periodic", [True, False])
def test_halfsweep_matches_jax_interpret(periodic, dtype, col_halo, update_red):
    """One half-sweep of a 16 x 12 (compact) plane with random halo rows and,
    with ``col_halo``, random column halos; the JAX side runs two row blocks."""
    rng = np.random.default_rng(1 + 2 * periodic + 4 * col_halo + 8 * update_red)
    R, C2 = 16, 12
    other, up, down = _spins(rng, (R, C2)), _spins(rng, (1, C2)), _spins(rng, (1, C2))
    left, right = (_spins(rng, (R, 1)), _spins(rng, (R, 1))) if col_halo else (None, None)
    u24 = rng.integers(0, 1 << 24, (R, C2), dtype=np.int32)
    J, field = COUPLING[dtype]
    (oj, ot), (uj, ut), (dj, dt) = (_both(x, dtype) for x in (other, up, down))
    (lj, lt), (rj, rt) = _both(left, dtype), _both(right, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jpal.halfsweep_pallas(jnp.int32(0), T, oj, uj, dj, update_red=update_red, J=J,
                                     field=field, periodic=periodic, u24=jnp.asarray(u24),
                                     block_rows=8, left_col=lj, right_col=rj)
    kw = dict(update_red=update_red, temperature=T, J=J, field=field, periodic=periodic,
              left_col=lt, right_col=rt, uniforms=torch.from_numpy(u24))
    got = halfsweep(ot, ut, dt, **kw)
    band = halfsweep_band(ot, ut, dt, **kw).numpy()
    assert got.dtype == ot.dtype
    differ = got.float().numpy() != np.asarray(want, np.float32)
    assert not (differ & ~band).any()


@pytest.mark.parametrize("periodic", [True, False])
def test_sweeps_match_jax_interpret(periodic):
    """Three full sweeps of a 32^2 lattice, both colours, the halos the
    plane's own wrap rows (or zeros); the JAX side runs four row blocks."""
    rng = np.random.default_rng(20 + periodic)
    R = C = 32
    red, black = jcb.split_checkerboard(jnp.asarray(_spins(rng, (R, C))))
    U = rng.integers(0, 1 << 24, (3, 2, R, C // 2), dtype=np.int32)
    with pltpu.force_tpu_interpret_mode():
        r_j, b_j = jpal.checkerboard_sweeps_planes_pallas(
            jnp.int32(0), red, black, T, 3, J=1.0, field=0.1, periodic=periodic,
            uniforms=jnp.asarray(U), block_rows=8)
    r_t, b_t = checkerboard_sweeps_planes_kernel(
        0, torch.from_numpy(np.array(red)), torch.from_numpy(np.array(black)), T, 3, J=1.0,
        field=0.1, periodic=periodic, uniforms=torch.from_numpy(U))
    # A site update in the band could flip a later sweep's neighbourhoods;
    # at these seeds none falls in it, so the planes agree everywhere.
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))


@pytest.mark.parametrize("update_red", [True, False])
def test_halo2d_neighbor_sum_matches_jax(update_red):
    rng = np.random.default_rng(30 + update_red)
    R, C2 = 6, 5
    parts = [_spins(rng, s) for s in ((R, C2), (1, C2), (1, C2), (R, 1), (R, 1))]
    want = jcb.neighbor_sum_half_halo2d(*(jnp.asarray(p) for p in parts), update_red)
    got = neighbor_sum_half_halo2d(*(torch.from_numpy(p) for p in parts), update_red)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_halfstep_with_halo2d_draws_spins_from_the_generator():
    """The generator-driven 2-D halfstep: spins stay +-1 in the plane's
    dtype, a strong field drives every site up, and the draw follows the
    generator."""
    rng = np.random.default_rng(40)
    R, C2 = 8, 4
    o, up, dn, lc, rc = (torch.from_numpy(_spins(rng, s))
                         for s in ((R, C2), (1, C2), (1, C2), (R, 1), (R, 1)))
    args = (o, up, dn, lc, rc, True)
    a = halfstep_with_halo2d(torch.Generator().manual_seed(1), *args, 2.0, 1.0, 0.0)
    b = halfstep_with_halo2d(torch.Generator().manual_seed(1), *args, 2.0, 1.0, 0.0)
    assert torch.equal(a, b) and set(a.unique().tolist()) <= {-1.0, 1.0}
    up_all = halfstep_with_halo2d(torch.Generator().manual_seed(2), *args, 1.0, 0.0, 50.0)
    assert float(up_all.mean()) == 1.0


@pytest.mark.parametrize("row0,col0", [(0, 0), (6, 3), (10, 9)])
def test_philox_draws_are_keyed_by_global_coordinates(row0, col0):
    """A shard's words are the whole lattice's at its sites, also where its
    columns start inside a group of four."""
    whole = philox_words(123, 4, 24, 20)
    R, C2 = 8, 7
    rows = row0 + torch.arange(R)
    shard = philox_words(123, 4, R, C2, rows=rows, col0=col0)
    assert torch.equal(shard, whole[row0:row0 + R, col0:col0 + C2])


def test_sharded_halfsweep_equals_the_lattice_halfsweep_in_philox_mode():
    """Cut a 16 x 10 plane into four 8 x 5 shards with their true halos:
    each shard's half-sweep is the lattice's at its sites, bit for bit."""
    rng = np.random.default_rng(50)
    o = torch.from_numpy(_spins(rng, (16, 10)))
    kw = dict(update_red=False, temperature=T, key=(77, 5))
    whole = halfsweep(o, o[-1:], o[:1], **kw)
    for i in (0, 1):
        for j in (0, 1):
            s = o[8 * i:8 * i + 8, 5 * j:5 * j + 5]
            up = o[(8 * i - 1) % 16, 5 * j:5 * j + 5]
            down = o[(8 * i + 8) % 16, 5 * j:5 * j + 5]
            left = o[8 * i:8 * i + 8, (5 * j - 1) % 10]
            right = o[8 * i:8 * i + 8, (5 * j + 5) % 10]
            got = halfsweep(s.contiguous(), up, down, row0=8 * i, col0=5 * j,
                            left_col=left.contiguous(), right_col=right.contiguous(), **kw)
            assert torch.equal(got, whole[8 * i:8 * i + 8, 5 * j:5 * j + 5])


def test_cpu_halfsweep_runs_the_plain_version_without_launching():
    o = torch.ones(4, 3)
    before = halfsweep.launches
    got = halfsweep(o, o[-1:], o[:1], update_red=True, temperature=1.0, key=(1, 2))
    want = halfsweep_reference(o, o[-1:], o[:1], update_red=True, temperature=1.0, key=(1, 2))
    assert halfsweep.launches == before and torch.equal(got, want)


@pytest.mark.parametrize("case", ["odd rows", "float64", "one column halo", "odd row0",
                                  "short halo", "uniforms dtype"])
def test_halfsweep_rejects_bad_operands(case):
    o = torch.ones(4, 3)
    kw = dict(update_red=True, temperature=1.0)
    up, down = o[-1:], o[:1]
    if case == "odd rows":
        o = torch.ones(5, 3)
        up, down = o[-1:], o[:1]
    elif case == "float64":
        o, up, down = o.double(), up.double(), down.double()
    elif case == "one column halo":
        kw["left_col"] = torch.ones(4, 1)
    elif case == "odd row0":
        kw["row0"] = 3
    elif case == "short halo":
        up = torch.ones(1, 2)
    else:
        kw["uniforms"] = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        halfsweep(o, up, down, **kw)


# The kernel's threshold table. J, field, T: the cases of the tests above,
# p = 0 and p = 1 (T = 0.05, |field| = 10, or J n / T large), a hot lattice,
# a negative J, and couplings whose p lands on or near a multiple of 2^-24.
TABLE_CASES = [(1.0, 0.1, 2.269), (0.75, 0.25, 2.269), (1.0, 0.0, 2.269), (1.0, 10.0, 0.05),
               (1.0, -10.0, 0.05), (1.0, 0.0, 0.05), (1.0, 0.0, 1e3), (1.0, 0.1, 1e3),
               (-1.0, 0.3, 0.7), (2.0, 0.0, 1.5), (1.0, 0.0, 1e-3), (0.5, -0.25, 4.0)]


def _table_probability(J, field, T):
    """float32 p of nbr = -4..4 in the kernel's order of operations."""
    n = torch.arange(-4, 5, dtype=torch.float32)
    local = n * J + field
    return 1.0 / (1.0 + torch.exp(-(2.0 * local) / torch.tensor(T, dtype=torch.float32)))


@pytest.mark.parametrize("J,field,T", TABLE_CASES)
def test_threshold_table_gives_the_probability_compare(J, field, T):
    """u24 < t[nbr + 4] exactly when u24 * 2^-24 < p, at u24 = t-2 .. t+1
    and at both ends of the range, for every nbr."""
    t = halfsweep_thresholds(J, field, T)
    p = _table_probability(J, field, T)
    assert t.dtype == torch.int64 and ((t >= 0) & (t <= 1 << 24)).all()
    for n in range(9):
        u = torch.tensor([0, (1 << 24) - 1] + [int(t[n]) + d for d in (-2, -1, 0, 1)])
        u = u[(u >= 0) & (u < 1 << 24)].to(torch.int32)
        by_p = u.float() * (1.0 / 16777216.0) < p[n]
        assert torch.equal(u < t[n], by_p), (n, float(p[n]), int(t[n]))


def test_threshold_table_reaches_both_ends():
    """p = 0 gives t = 0 (never +1) and p = 1 gives t = 2^24 (always +1);
    the kernel then compares word >> 8 < t, not word < t << 8."""
    cold = halfsweep_thresholds(1.0, -10.0, 0.05)
    hot = halfsweep_thresholds(1.0, 10.0, 0.05)
    assert int(cold[0]) == 0 and int(hot[8]) == 1 << 24
    assert int(halfsweep_thresholds(1.0, 0.0, 2.269)[4]) == 1 << 23   # p = 1/2 exactly


def test_shifted_compare_equals_the_24_bit_compare():
    """For every t < 2^24 and words whose top 24 bits are t-1, t and t+1 with
    random low bytes: word < t << 8 exactly when word >> 8 < t (unsigned)."""
    gen = torch.Generator().manual_seed(3)
    chunk = 1 << 22
    for lo in range(0, 1 << 24, chunk):
        t = torch.arange(lo, lo + chunk, dtype=torch.int64)
        for d in (-1, 0, 1):
            u24 = (t + d).clamp(0, (1 << 24) - 1)
            word = (u24 << 8) | torch.randint(0, 256, (chunk,), generator=gen)
            assert torch.equal(word < (t << 8), (word >> 8) < t)


def _shards(rng, rows, cols, R, C2):
    """A grid of contiguous +-1 shards, as _scatter makes them."""
    plane = torch.from_numpy(_spins(rng, (rows * R, cols * C2)))
    return [[plane[i * R:(i + 1) * R, j * C2:(j + 1) * C2].contiguous() for j in range(cols)]
            for i in range(rows)]


@pytest.mark.parametrize("periodic", [True, False])
def test_column_halos_are_views_of_the_neighbour_planes(periodic):
    """On one device _halo_exchange_cols copies nothing: each column halo is
    a strided (R, 1) view of the neighbour shard's plane; an open global edge
    gets zeros."""
    planes = _shards(np.random.default_rng(60 + periodic), 2, 2, 6, 5)
    lefts, rights = _halo_exchange_cols(planes, periodic)
    for i in range(2):
        for j in range(2):
            for halo, nj, col, edge in ((lefts[i][j], (j - 1) % 2, -1, j == 0),
                                        (rights[i][j], (j + 1) % 2, 0, j == 1)):
                assert halo.shape == (6, 1)
                if edge and not periodic:
                    assert not halo.any()
                    continue
                src = planes[i][nj]
                assert halo.untyped_storage().data_ptr() == src.untyped_storage().data_ptr()
                assert not halo.is_contiguous() and halo.stride(0) == 5
                assert torch.equal(halo[:, 0], src[:, col])


@pytest.mark.parametrize("periodic", [True, False])
def test_sharded_k3_sweep_passes_column_views_to_the_kernel(monkeypatch, periodic):
    """A 2 x 2 K3 sweep on a CPU mesh hands halfsweep the neighbours' columns
    in place, and the result is the one-shard run's."""
    seen = []

    def spy(other, up, down, **kw):
        seen.append((kw["left_col"], kw["right_col"]))
        return halfsweep(other, up, down, **kw)

    rng = np.random.default_rng(62 + periodic)
    red, black = (x.contiguous() for x in split_checkerboard(torch.from_numpy(
        _spins(rng, (16, 20)))))
    one = sharded_checkerboard_sweeps(make_mesh(devices=["cpu"]), 5, red, black, T, 2,
                                      periodic=periodic, fused=False)
    monkeypatch.setattr(lattice, "halfsweep", spy)
    got = sharded_checkerboard_sweeps(make_mesh(rows=2, cols=2, devices=["cpu"] * 4), 5, red,
                                      black, T, 2, periodic=periodic, col_axis="col")
    assert torch.equal(one[0], got[0]) and torch.equal(one[1], got[1])
    assert len(seen) == 2 * 2 * 4
    views = [c for pair in seen for c in pair if c.any()]
    assert len(views) == (2 * len(seen) if periodic else len(seen))
    assert all(not c.is_contiguous() and c.stride(0) == 5 for c in views)


def test_kernel_checks_take_strided_column_views():
    """The checks of the kernel path accept an (R, 1) column of a wider
    plane and return its row stride; the plain version reads it in place."""
    rng = np.random.default_rng(64)
    o = torch.from_numpy(_spins(rng, (6, 5)))
    wide = torch.from_numpy(_spins(rng, (6, 9)))
    left, right = wide[:, -1:], wide[:, 2:3]
    assert _kernel_operands(o, o[-1:], o[:1], left, right, None) == (9, 9)
    assert _kernel_operands(o, o[-1:], o[:1], left.contiguous(), right[:, 0], None) == (1, 9)
    assert _kernel_operands(o, o[-1:], o[:1], None, None, None) == (0, 0)
    kw = dict(update_red=True, temperature=T, key=(3, 4), row0=2, col0=7)
    got = halfsweep(o, o[-1:], o[:1], left_col=left, right_col=right, **kw)
    want = halfsweep(o, o[-1:], o[:1], left_col=left.contiguous(), right_col=right.contiguous(),
                     **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["long column", "short column", "column dtype", "row of R",
                                  "2-D block", "other strided", "halo row strided"])
def test_kernel_checks_reject_bad_columns(case):
    """A column of the wrong length or dtype fails the checks of both paths;
    a tensor that is not one column, or a strided operand other than a
    column, fails the kernel path's."""
    o = torch.ones(6, 5)
    up, down = o[-1:], o[:1]
    left = right = torch.ones(6, 9)[:, :1]
    if case == "long column":
        left = torch.ones(7, 1)
    elif case == "short column":
        right = torch.ones(12, 1)[::3]
    elif case == "column dtype":
        left = torch.ones(6, 1, dtype=torch.bfloat16)
    elif case == "row of R":
        left = torch.ones(2, 6)[:1]            # 6 values, but along a row: accepted
    elif case == "2-D block":
        left = torch.ones(3, 4)[:, :2]
    elif case == "other strided":
        o = torch.ones(6, 10)[:, ::2]
    else:
        up = torch.ones(2, 10)[:1, ::2]
    if case in ("long column", "short column", "column dtype"):    # _check, both paths
        with pytest.raises(ValueError):
            halfsweep(o, up, down, update_red=True, temperature=1.0, left_col=left,
                      right_col=right)
    elif case == "row of R":
        assert _kernel_operands(o, up, down, left, right, None) == (1, 9)
    else:
        with pytest.raises(ValueError):
            _kernel_operands(o, up, down, left, right, None)
