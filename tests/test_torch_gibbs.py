"""The port's dense Gibbs engine on the CPU against the JAX package:
colouring, the colour step on the same uniforms, the routes, moments
against exact enumeration, tempering and annealing."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tsu_tpu import native as jnative  # noqa: E402
from tsu_tpu.oracle import exact_boltzmann_moments  # noqa: E402
from tsu_tpu.samplers import gibbs as jgibbs  # noqa: E402
from tsu_tpu_torch import GibbsConfig, GibbsSampler, SamplingError  # noqa: E402
from tsu_tpu_torch.native import gibbs_dense_native  # noqa: E402
from tsu_tpu_torch.samplers.annealing import simulated_annealing_dense  # noqa: E402
from tsu_tpu_torch.samplers.gibbs import (  # noqa: E402
    ColourPlan,
    DenseSweeper,
    blocked_sweeps,
    boltzmann_energy_batch,
    color_groups,
    colour_step,
    dense_gibbs_sample,
    gibbs_sweeps,
)
from tsu_tpu_torch.samplers.tempering import parallel_tempering_dense  # noqa: E402

CPU = "cpu"
BAND = 1e-6        # |u - p| below this may round either way between the two packages


def _random_J(seed, n, scale=0.7, density=1.0):
    rng = np.random.default_rng(seed)
    J = rng.normal(0, scale, (n, n)) * (rng.random((n, n)) < density)
    J = (J + J.T) / 2
    np.fill_diagonal(J, 0.0)
    return J.astype(np.float32), rng.normal(0, 0.5, n).astype(np.float32)


def _chain(n, w=0.5):
    J = np.zeros((n, n), np.float32)
    for i in range(n - 1):
        J[i, i + 1] = J[i + 1, i] = w
    return J


@pytest.mark.parametrize("J", [
    _chain(9), _random_J(1, 12)[0], _random_J(2, 40, density=0.2)[0],
    _random_J(3, 60, density=0.05)[0], np.zeros((5, 5), np.float32),
    np.kron(np.eye(3), np.ones((4, 4))).astype(np.float32),    # cliques: a skewed colouring
], ids=["chain", "dense", "sparse", "very-sparse", "empty", "cliques"])
def test_color_groups_equal_the_reference(J):
    ours = color_groups(J)
    assert np.array_equal(ours, jgibbs.color_groups(J))
    plan = ColourPlan(J, np.zeros(len(J)), ours, device=CPU)
    assert sorted(plan.perm.tolist()) == list(range(len(J)))
    off = J - np.diag(np.diag(J))
    for a, b in plan.bounds:          # no two sites of one colour couple
        sites = plan.perm[a:b]
        assert not np.any(off[np.ix_(sites, sites)])


def test_one_site_colour_step_equals_site_update():
    """A sequential sweep, site by site, against the JAX package's
    _site_update on the same uniforms, equal outside the band."""
    J, h = _random_J(5, 16)
    T = 0.8
    plan = ColourPlan(J, h, sequential=True, device=CPU)
    rng = np.random.default_rng(6)
    state = rng.integers(0, 2, 16).astype(np.float32)
    ours = torch.tensor(state[None, :])
    ref = jnp.asarray(state)
    Tt = torch.full((1, 1), T)
    n_band = 0
    for sweep in range(3):
        u = rng.random(16).astype(np.float32)
        for i in range(16):
            field = float(J[i] @ np.asarray(ref) + h[i] - J[i, i] * np.asarray(ref)[i])
            p = 1.0 / (1.0 + np.exp(-field / T))
            ref = jgibbs._site_update(i, ref, jnp.asarray(J), jnp.asarray(h), T, u[i])
            colour_step(ours, plan.J, plan.h, plan.diag, torch.tensor(u[None, :]), Tt, i, i + 1)
            if abs(u[i] - p) < BAND:
                n_band += 1
                ours[0, i] = float(ref[i])
            assert float(ours[0, i]) == float(ref[i])
    assert n_band == 0


def _reference_colour(state, J, h, colour, n, T, u):
    """The JAX package's colour update (gibbs.py:152-156) on one colour,
    padded as blocked_sweeps pads it."""
    J_ext = jnp.zeros((n + 1, n + 1), jnp.float32).at[:n, :n].set(J)
    h_ext = jnp.zeros(n + 1, jnp.float32).at[:n].set(h)
    ext = jnp.zeros((state.shape[0], n + 1), jnp.float32).at[:, :n].set(state)
    onehot = jax.nn.one_hot(colour, n + 1, dtype=jnp.float32)
    memb = jnp.clip(onehot.sum(axis=0), 0.0, 1.0)
    f = ext @ J_ext[colour].T + h_ext[colour] - jnp.diag(J_ext)[colour][None, :] * (ext @ onehot.T)
    p = jax.nn.sigmoid(f / T)
    new = jnp.where(u < p, 1.0, 0.0)
    return (ext * (1.0 - memb) + new @ onehot)[:, :n], p


@pytest.mark.parametrize("seed,n,chains,density", [(7, 24, 3, 0.3), (8, 30, 2, 0.1)])
def test_wide_colour_step_equals_the_reference_formula(seed, n, chains, density):
    J, h = _random_J(seed, n, density=density)
    J[np.arange(n), np.arange(n)] = 0.25       # a diagonal, which the field excludes
    colors = color_groups(J)
    plan = ColourPlan(J, h, colors, device=CPU)
    rng = np.random.default_rng(seed)
    state = rng.integers(0, 2, (chains, n)).astype(np.float32)
    T = np.array([0.7, 1.3, 2.0][:chains], np.float32)
    ours = plan.to_plan(torch.tensor(state))
    ref = jnp.asarray(state)
    n_band = 0
    for c, (a, b) in enumerate(plan.bounds):
        colour = jnp.asarray(colors[c][colors[c] < n])
        u_site = rng.random((chains, b - a)).astype(np.float32)
        ref, p = _reference_colour(ref, J, h, colour, n, jnp.asarray(T)[:, None], u_site)
        u = torch.zeros((chains, n))
        u[:, a:b] = torch.tensor(u_site)
        colour_step(ours, plan.J, plan.h, plan.diag, u, torch.tensor(T)[:, None], a, b)
        band = np.abs(u_site - np.asarray(p)) < BAND
        n_band += int(band.sum())
        back = plan.from_plan(ours).numpy()
        site = np.asarray(colour)
        assert np.array_equal(back[:, site][~band], np.asarray(ref)[:, site][~band])
        ours = plan.to_plan(torch.tensor(np.asarray(ref)))     # carry on from one state
    assert n_band == 0


@pytest.mark.parametrize("order,init,route", [
    ("checkerboard", None, "device"),
    ("sequential", None, "native_cpp"),
    ("sequential", "zeros", "device"),
    ("random", None, "native_cpp"),
    ("random", "zeros", "device"),
])
def test_moments_match_exact_enumeration(order, init, route):
    """Each route's marginals against the exact Boltzmann distribution of a
    10-bit random-J machine (tests/test_gibbs.py's tolerance, 0.06)."""
    J, h = _random_J(7, 10)
    s = GibbsSampler(GibbsConfig(n_burnin=100, n_sweeps=3, n_chains=8, update_order=order),
                     seed=3, device=CPU)
    x = s.sample_boltzmann(J, bias=h, n_samples=4000,
                           initial_state=None if init is None else np.zeros(10))
    assert s.last_route == route
    exact = exact_boltzmann_moments(J, h, temperature=1.0)
    assert np.all(np.abs(x.mean(axis=0) - exact["mean"]) < 0.06)
    e = boltzmann_energy_batch(torch.tensor(x), torch.tensor(J), torch.tensor(h)).double()
    assert abs(float(e.mean()) - exact["energy"]) < 0.15


def test_iid_route_matches_sigmoid():
    s = GibbsSampler(GibbsConfig(n_burnin=20, n_sweeps=1, temperature=2.0, n_chains=4),
                     seed=1, device=CPU)
    b = np.array([1.0, -1.0])
    x = s.sample_boltzmann(np.zeros((2, 2)), bias=b, n_samples=2000)
    assert s.last_route == "iid" and x.shape == (2000, 2)
    assert np.all(np.abs(x.mean(axis=0) - 1.0 / (1.0 + np.exp(-b / 2.0))) < 0.05)


class TestRouteRecording:
    """tests/test_gibbs.py:200-231: the route is recorded, and a
    "checkerboard" request never takes the native sequential chain."""

    def test_checkerboard_never_routes_native(self):
        s = GibbsSampler(GibbsConfig(update_order="checkerboard", n_chains=4, n_burnin=10,
                                     n_sweeps=1), seed=0, device=CPU)
        s.sample_boltzmann(_chain(8), n_samples=8)
        assert s.last_route == "device"

    def test_sequential_tiny_route_recorded(self):
        s = GibbsSampler(GibbsConfig(update_order="sequential", n_chains=4, n_burnin=10,
                                     n_sweeps=1), seed=0, device=CPU)
        s.sample_boltzmann(_chain(8), n_samples=8)
        assert s.last_route == "native_cpp"

    def test_iid_route_recorded(self):
        s = GibbsSampler(GibbsConfig(n_chains=4, n_burnin=5), seed=0, device=CPU)
        s.sample_boltzmann(np.zeros((3, 3), np.float32), n_samples=8)
        assert s.last_route == "iid"

    def test_sequential_with_an_initial_state_stays_on_the_device_route(self):
        s = GibbsSampler(GibbsConfig(update_order="random", n_burnin=2, n_sweeps=1), seed=0,
                         device=CPU)
        s.sample_boltzmann(_chain(8), n_samples=4, initial_state=np.ones(8))
        assert s.last_route == "device"


@pytest.mark.parametrize("random_order", [False, True])
def test_native_gibbs_dense_equals_the_reference_library(random_order):
    J, h = _random_J(9, 20)
    kw = dict(temperature=1.3, n_chains=3, n_samples=40, n_burnin=5, n_sweeps=2,
              random_order=random_order, seed=1234)
    assert np.array_equal(gibbs_dense_native(J, h, **kw), jnative.gibbs_dense_native(J, h, **kw))


def test_native_route_equals_the_reference_sampler_draw_for_draw():
    """The native route runs the same library call with the seed drawn from
    the sampler's generator."""
    J, h = _random_J(10, 8)
    cfg = GibbsConfig(update_order="sequential", n_chains=2, n_burnin=5, n_sweeps=2)
    s = GibbsSampler(cfg, seed=4, device=CPU)
    out = s.sample_boltzmann(J, bias=h, n_samples=12)
    seed = int(torch.randint(0, 2**63 - 1, (), generator=torch.Generator().manual_seed(4)))
    ref = jnative.gibbs_dense_native(J, h, temperature=1.0, n_chains=2, n_samples=12,
                                     n_burnin=5, n_sweeps=2, random_order=False, seed=seed)
    assert np.array_equal(out, ref)


def test_local_field_energy_and_errors():
    s = GibbsSampler(seed=0, device=CPU)
    J = np.array([[0.0, 2.0, 0.0], [2.0, 0.0, 1.0], [0.0, 1.0, 0.0]])
    assert s._compute_local_field(0, np.array([0.0, 1.0, 1.0]), J) == pytest.approx(2.0)
    assert s._compute_local_field(0, np.ones(2), np.array([[5.0, 1.0], [1.0, 5.0]])) == 1.0
    assert s.compute_energy(np.ones(2), np.array([[0.0, 4.0], [4.0, 0.0]])) == -4.0
    assert s.compute_energy(np.ones(2), np.zeros((2, 2)), np.array([1.0, 2.0])) == -3.0
    with pytest.raises(SamplingError):
        s.sample_boltzmann(np.zeros((3, 2)), n_samples=5)
    with pytest.raises(SamplingError):
        s.sample_boltzmann(np.zeros((3, 3)), bias=np.zeros(2), n_samples=5)
    with pytest.raises(SamplingError):
        s.sample_boltzmann(np.zeros((3, 3)), n_samples=0)
    hot = GibbsSampler(GibbsConfig(temperature=0.05), seed=0, device=CPU)
    assert hot.sample_conditional(0, np.zeros(2), np.zeros((2, 2)), np.array([10.0, -10.0])) == 1
    assert hot.sample_conditional(1, np.zeros(2), np.zeros((2, 2)), np.array([10.0, -10.0])) == 0


def test_gibbs_sweep_blocked_sweeps_and_dense_sample_shapes():
    J, h = _random_J(11, 6)
    s = GibbsSampler(GibbsConfig(n_burnin=1, update_order="random"), seed=0, device=CPU)
    out = s.gibbs_sweep(np.zeros(6), J, h, n_sweeps=3)
    assert out.shape == (6,) and set(np.unique(out)) <= {0.0, 1.0}
    one = gibbs_sweeps(0, np.zeros(6), J, h, 1.0, 2, device=CPU)
    assert one.shape == (6,)
    b = blocked_sweeps(1, np.ones((3, 6)), J, h, np.array([0.5, 1.0, 2.0]), n_sweeps=2,
                       device=CPU)
    assert b.shape == (3, 6) and set(torch.unique(b).tolist()) <= {0.0, 1.0}
    x = dense_gibbs_sample(2, J, h, np.zeros((4, 6)), n_samples=5, n_burnin=3, n_sweeps=1,
                           device=CPU)
    assert x.shape == (4, 5, 6)


def test_plan_order_round_trip_and_energy():
    J, h = _random_J(12, 20, density=0.3)
    plan = ColourPlan(J, h, device=CPU)
    x = (torch.rand((5, 20), generator=torch.Generator().manual_seed(0)) < 0.5).float()
    assert torch.equal(plan.from_plan(plan.to_plan(x)), x)
    e_plan = boltzmann_energy_batch(plan.to_plan(x), plan.J, plan.h)
    e = boltzmann_energy_batch(x, torch.tensor(J), torch.tensor(h))
    ref = np.asarray(jgibbs.boltzmann_energy_batch(jnp.asarray(x.numpy()), jnp.asarray(J),
                                                   jnp.asarray(h)))
    np.testing.assert_allclose(e_plan.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(e.numpy(), ref, rtol=0, atol=1e-5)


def test_sweeper_is_reproducible_and_resumable_from_its_generators():
    J, h = _random_J(13, 12)
    plan = ColourPlan(J, h, device=CPU)
    a, b = DenseSweeper(plan, 4, 9), DenseSweeper(plan, 4, 9)
    for sw in (a, b):
        sw.load(torch.zeros((4, 12)))
        sw.set_temperature(1.5)
    assert torch.equal(a.run(3), b.run(3))
    assert a.route == "eager"


def test_parallel_tempering_cold_rung_matches_enumeration():
    J, h = _random_J(14, 8, scale=1.0)
    samples, info = parallel_tempering_dense(0, J, h, temperatures=[1.0, 1.5, 2.3, 3.4],
                                             n_samples=3000, swap_interval=2, n_sweeps=1,
                                             n_burnin=100, device=CPU)
    exact = exact_boltzmann_moments(J, h, temperature=1.0)
    assert samples.shape == (3000, 8)
    assert np.all(np.abs(samples.numpy().mean(axis=0) - exact["mean"]) < 0.07)
    assert info["swap_attempts"] > 0 and 0.1 < info["swap_acceptance_rate"] <= 1.0
    assert info["final_states"].shape == (4, 8) and info["energies"].shape == (3100, 4)
    ref_keys = {"swap_acceptance_rate", "swap_attempts", "swap_accepts", "pair_acceptance",
                "pair_attempts", "energies", "final_states"}
    assert set(info) == ref_keys


@pytest.mark.parametrize("seed", [0, torch.Generator().manual_seed(0)], ids=["native", "device"])
def test_simulated_annealing_finds_the_ferromagnetic_ground_state(seed):
    n = 8
    J = np.ones((n, n), np.float32)
    np.fill_diagonal(J, 0)
    state, energy = simulated_annealing_dense(seed, J, np.zeros(n), n_steps=300, n_chains=4,
                                              device=CPU)
    assert energy == -n * (n - 1) / 2 and np.all(state == 1.0)


def test_sampler_annealing_and_tempering_keep_the_config():
    cfg = GibbsConfig(temperature=1.7, n_chains=4, n_burnin=10, n_sweeps=1)
    s = GibbsSampler(cfg, seed=0, device=CPU)
    state, e = s.simulated_annealing(np.zeros((3, 3)), n_steps=50)
    assert state.shape == (3,) and e == 0.0
    J, _ = _random_J(15, 6)
    x, info = s.parallel_tempering(J, temperatures=[0.5, 1.0, 2.0, 4.0], n_samples=100,
                                   swap_interval=5)
    assert x.shape == (100, 6) and info["final_states"].shape == (4, 6)
    assert s.config.temperature == 1.7 and s.sample_count == 100
