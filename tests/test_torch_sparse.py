"""The port's sparse Ising path and native graph tools on the CPU against the
JAX package: ELL arrays, fields and energies, the native library, MAX-CUT,
and chunked and resumed anneals (mirrors tests/test_sparse.py)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tsu_tpu import native as jnative  # noqa: E402
from tsu_tpu.ops import sparse_ising as jsparse  # noqa: E402
from tsu_tpu_torch import native  # noqa: E402
from tsu_tpu_torch.interop import ell_from_numpy  # noqa: E402
from tsu_tpu_torch.ops import sparse_ising  # noqa: E402
from tsu_tpu_torch.ops.sparse_ising import (  # noqa: E402
    ell_energy,
    ell_from_edges,
    ell_local_fields,
    maxcut_sparse,
    sparse_anneal,
)

CPU = "cpu"


def _graph(seed, n, m, weights="ones", dup=0, loops=True):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, (m, 2))
    if dup:
        edges = np.concatenate([edges, edges[:dup], edges[:dup, ::-1]])
    if not loops:
        edges = edges[edges[:, 0] != edges[:, 1]]
    if weights == "ones":
        w = np.ones(len(edges))
    elif weights == "ties":
        w = rng.choice([-2.0, -1.0, 0.5, 1.0, 2.0], len(edges))
    else:
        w = rng.normal(size=len(edges))
    return edges, w


@pytest.mark.parametrize("weights,dup,k_max", [
    ("ones", 0, None), ("ties", 25, None), ("ties", 25, 3), ("normal", 10, None),
    ("normal", 0, 5), ("ties", 0, 0),
])
def test_ell_from_edges_equals_the_reference(weights, dup, k_max):
    """Ties, duplicate edges (both orientations), self-loops and a cut K:
    the same arrays, entry for entry."""
    edges, w = _graph(1, 40, 300, weights, dup)
    ours = ell_from_edges(40, edges, w, k_max)
    ref = jsparse.ell_from_edges(40, edges, w, k_max)
    assert ours[0].dtype == np.int32 and ours[1].dtype == np.float32
    assert np.array_equal(ours[0], ref[0]) and np.array_equal(ours[1], ref[1])


def test_ell_from_edges_handles_no_edges():
    ours = ell_from_edges(5, np.zeros((0, 2), np.int64), np.zeros(0))
    ref = jsparse.ell_from_edges(5, np.zeros((0, 2), np.int64), np.zeros(0))
    assert ours[0].shape == ref[0].shape == (5, 0)


def test_fields_and_energies_match_the_reference():
    edges, w = _graph(2, 60, 400, "normal", 10)
    idx, wt = jsparse.ell_from_edges(60, edges, w)
    rng = np.random.default_rng(3)
    s = rng.choice([-1.0, 1.0], (4, 60)).astype(np.float32)
    h = rng.normal(size=60).astype(np.float32)
    idx_t, w_t = ell_from_numpy(idx, wt, device=CPU)
    assert idx_t.dtype == torch.int64 and w_t.dtype == torch.float32
    f = ell_local_fields(torch.tensor(s), idx_t, w_t, torch.tensor(h)).numpy()
    e = ell_energy(torch.tensor(s), idx_t, w_t, torch.tensor(h)).numpy()
    for c in range(4):
        args = (jnp.asarray(s[c]), jnp.asarray(idx), jnp.asarray(wt), jnp.asarray(h))
        np.testing.assert_allclose(f[c], np.asarray(jsparse.ell_local_fields(*args)),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(e[c], float(jsparse.ell_energy(*args)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,restarts,seed", [(80, 3, 0), (300, 5, 11)])
def test_greedy_maxcut_and_cut_value_equal_the_reference_library(n, restarts, seed):
    edges, w = _graph(seed, n, 4 * n, "normal", loops=False)
    csr = native.csr_from_edges(n, edges, w)
    jcsr = jnative.csr_from_edges(n, edges, w)
    assert all(np.array_equal(a, b) for a, b in zip(csr, jcsr))
    cut, spins = native.greedy_maxcut_csr(*csr, n_restarts=restarts, seed=seed)
    ref_cut, ref_spins = jnative.greedy_maxcut_csr(*jcsr, n_restarts=restarts, seed=seed)
    assert cut == ref_cut and np.array_equal(spins, ref_spins)
    assert native.cut_value_csr(*csr, spins) == jnative.cut_value_csr(*jcsr, spins) == cut
    colors = np.arange(n, dtype=np.int32) % 3
    assert (native.coloring_conflicts_csr(csr[0], csr[1], colors)
            == jnative.coloring_conflicts_csr(jcsr[0], jcsr[1], colors))
    W = np.zeros((n, n))
    np.add.at(W, (edges[:, 0], edges[:, 1]), w)
    np.add.at(W, (edges[:, 1], edges[:, 0]), w)
    dense = native.csr_from_dense(W)
    assert native.greedy_maxcut_csr(*dense, n_restarts=restarts, seed=seed)[0] == pytest.approx(
        cut, abs=1e-9)


@pytest.mark.parametrize("n,chains,seed", [(12, 1, 5), (40, 3, 6), (200, 4, 7)])
def test_sa_dense_equals_the_reference_library(n, chains, seed):
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(n, n)).astype(np.float32)
    J = (J + J.T) / 2
    np.fill_diagonal(J, 0)
    h = rng.normal(size=n).astype(np.float32)
    sched = np.geomspace(5.0, 0.05, 150).astype(np.float32)
    state, e = native.sa_dense_native(J, h, sched, chains, seed)
    ref_state, ref_e = jnative.sa_dense_native(J, h, sched, chains, seed)
    assert e == ref_e and np.array_equal(state, ref_state)


def test_the_native_build_raises_without_a_compiler(monkeypatch, tmp_path):
    """No silent fall-back: a missing g++ is an error."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.library_path()


def test_the_native_build_lands_under_build(monkeypatch):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.parent.parts[-2:] == ("build",
                                                                          "tsu_tpu_torch")
    assert path.name.startswith("graph_tools-") and path.suffix == ".so"


def test_native_available_says_whether_the_library_builds_and_loads(monkeypatch, tmp_path):
    """A bool that agrees with whether library() raises, here and without a
    compiler or a build to load; a query only, so the entry points still
    raise there."""
    try:
        native.library()
        builds = True
    except (RuntimeError, OSError):
        builds = False
    assert native.native_available() is builds
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    native.library.cache_clear()
    assert native.native_available() is False
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.cut_value_csr(*native.csr_from_dense(np.ones((2, 2))), np.ones(2))


def _anneal_args(seed, n, m):
    edges, _ = _graph(seed, n, m, loops=False)
    idx, w = ell_from_edges(n, edges, np.ones(len(edges)))
    sched = np.geomspace(3.0, 0.1, 60).astype(np.float32)
    return idx, -w, np.zeros(n, np.float32), sched


@pytest.mark.parametrize("chunk", [17, 1, 59])
def test_chunked_matches_single_chunk(chunk):
    args = _anneal_args(0, 50, 200)
    s1, e1 = sparse_anneal(3, *args, n_steps=60, n_chains=4, device=CPU)
    s2, e2 = sparse_anneal(3, *args, n_steps=60, n_chains=4, chunk_steps=chunk, device=CPU)
    assert e1 == e2 and torch.equal(s1, s2)


@pytest.mark.parametrize("killed_after", [1, 2])
def test_killed_and_resumed_matches(tmp_path, monkeypatch, killed_after):
    args = _anneal_args(1, 40, 150)
    full_s, full_e = sparse_anneal(5, *args, n_steps=60, n_chains=4, device=CPU)
    real_save, calls = sparse_ising.save_state, []

    def dying_save(*a, **kw):
        real_save(*a, **kw)
        calls.append(1)
        if len(calls) == killed_after:
            raise RuntimeError("simulated preemption")

    path = str(tmp_path / "anneal")
    monkeypatch.setattr(sparse_ising, "save_state", dying_save)
    with pytest.raises(RuntimeError, match="preemption"):
        sparse_anneal(5, *args, n_steps=60, n_chains=4, chunk_steps=20,
                      checkpoint_path=path, device=CPU)
    monkeypatch.setattr(sparse_ising, "save_state", real_save)
    s, e = sparse_anneal(5, *args, n_steps=60, n_chains=4, chunk_steps=20,
                         checkpoint_path=path, resume=True, device=CPU)
    assert e == full_e and torch.equal(s, full_s)


def test_anneal_stopped_short_resumes_to_a_longer_schedule(tmp_path):
    """Step t draws fixed-shape blocks from a generator whose state the
    snapshot carries: the first 20 steps of the schedule, snapshotted, then
    resumed with all 60, equal the uninterrupted 60."""
    args = _anneal_args(4, 40, 150)
    full_s, full_e = sparse_anneal(7, *args, n_steps=60, n_chains=4, device=CPU)
    path = str(tmp_path / "anneal")
    sparse_anneal(7, *args, n_steps=20, n_chains=4, checkpoint_path=path, device=CPU)
    s, e = sparse_anneal(7, *args, n_steps=60, n_chains=4, chunk_steps=20,
                         checkpoint_path=path, resume=True, device=CPU)
    assert e == full_e and torch.equal(s, full_s)


def test_resume_without_a_snapshot_runs_from_the_start(tmp_path):
    args = _anneal_args(2, 30, 100)
    full = sparse_anneal(6, *args, n_steps=60, n_chains=2, device=CPU)
    again = sparse_anneal(6, *args, n_steps=60, n_chains=2, checkpoint_path=str(tmp_path / "x"),
                          resume=True, device=CPU)
    assert full[1] == again[1] and torch.equal(full[0], again[0])


def test_maxcut_sparse_reaches_the_greedy_bound_and_reports_its_cut():
    edges, w = _graph(3, 2000, 10000, loops=False)
    out = maxcut_sparse(0, 2000, edges, w, n_steps=300, n_chains=4, device=CPU)
    csr = native.csr_from_edges(2000, edges, w)
    greedy, _ = native.greedy_maxcut_csr(*csr, n_restarts=3, seed=0)
    assert out["cut_value"] == native.cut_value_csr(*csr, out["spins"])
    assert out["cut_value"] >= greedy
    assert out["energy"] == pytest.approx(len(edges) - 2 * out["cut_value"], abs=1e-3)
    ref = jsparse.maxcut_sparse(__import__("jax").random.key(0), 2000, edges, w, n_steps=300,
                                n_chains=4)
    assert abs(out["cut_value"] - ref["cut_value"]) < 0.01 * ref["cut_value"]
