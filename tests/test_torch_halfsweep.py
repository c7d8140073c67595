"""The port's exact-sigmoid half-sweep (K3's plain version, on the CPU)
against tsu_tpu's ``halfsweep_pallas`` run in TPU interpret mode, and the
2-D halo neighbour sums against the JAX package's.

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
)
from tsu_tpu_torch.ops.checkerboard_kernel import (  # noqa: E402
    checkerboard_sweeps_planes_kernel,
    halfsweep,
    halfsweep_band,
    halfsweep_reference,
)
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
