"""The multi-process runtime on the CPU: gloo ranks, one process each.

Each module fixture starts the ranks once (2 or 4 processes of
``tsu_tpu_torch.tools.multiprocess_check``, a file rendezvous under the
test's temporary directory, every spawn under its own timeout) and the
parametrised cases read what each rank saved. Every sharded entry point
must return, bit for bit, what the one-process run returns at the same
seed (``multiprocess_check.run_case`` without a runtime, on CPU shards):
the sweeps (K1's shard mode on 16-bit injected uniforms and in Philox mode,
K3 on 24-bit uniforms and in Philox mode, rows and 2 x 2, periodic and
open), the sampler's observables and final planes, the replica-sharded
tempering's rungs and swaps, and the sharded SMC. One injected-uniform
sweep over 4 ranks is held against the JAX package's sharded sweep on its
virtual CPU devices. Snapshots resume across topologies, 2 ranks -> 1
process and 1 process -> 2 ranks.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tsu_tpu_torch.ops.checkerboard import split_checkerboard
from tsu_tpu_torch.parallel import distributed
from tsu_tpu_torch.tools import multiprocess_check
from tsu_tpu_torch.tools.multiprocess_check import lattice, run_case

REPO = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 240          # each spawn of ranks; the file's spawns take ~10 s each

L = (16, 16)
SWEEPS_4 = {
    # name: (mesh, kernel settings)
    "k1_rows4_u16_periodic": ({"rows": 4}, dict(uniform_bits=16, fused=True)),
    "k1_rows4_u16_open": ({"rows": 4}, dict(uniform_bits=16, fused=True, periodic=False)),
    "k1_rows4_philox": ({"rows": 4}, dict(fused=True, dtype="bfloat16")),
    "k3_rows4_u24_periodic": ({"rows": 4}, dict(uniform_bits=24, fused=False)),
    "k3_rows4_u24_open": ({"rows": 4}, dict(uniform_bits=24, fused=False, periodic=False)),
    "k3_2x2_u24_periodic": ({"rows": 2, "cols": 2}, dict(uniform_bits=24, fused=False)),
    "k3_2x2_u24_open": ({"rows": 2, "cols": 2},
                        dict(uniform_bits=24, fused=False, periodic=False)),
    "k3_2x2_philox": ({"rows": 2, "cols": 2}, dict(fused=False)),
}
SWEEPS_2 = {
    # Two ranks on a periodic ring: the up and the down halo go between one pair.
    "k1_rows2_u16_periodic": ({"rows": 2}, dict(uniform_bits=16, fused=True)),
    "k1_rows2_u16_open": ({"rows": 2}, dict(uniform_bits=16, fused=True, periodic=False)),
    "k3_rows2_u24_periodic": ({"rows": 2}, dict(uniform_bits=24, fused=False)),
    # Two shards a rank: in-place halos beside cross-rank ones.
    "k1_rows4_two_a_rank": ({"rows": 4, "ranks": [0, 0, 1, 1]},
                            dict(uniform_bits=16, fused=True)),
    "k3_2x2_rows_a_rank": ({"rows": 2, "cols": 2, "ranks": [0, 0, 1, 1]},
                           dict(uniform_bits=24, fused=False)),
    "k3_2x2_cols_a_rank": ({"rows": 2, "cols": 2, "ranks": [0, 1, 0, 1]},
                           dict(uniform_bits=24, fused=False, periodic=False)),
}
SAMPLES_4 = {
    "sample_k1_rows4": {"rows": 4},
    "sample_k3_2x2": {"rows": 2, "cols": 2},
}
SAMPLES_2 = {"sample_k1_rows4_two_a_rank": {"rows": 4, "ranks": [0, 0, 1, 1]}}
SAMPLE = dict(kind="sample", shape=[16, 16], seed=5, n_samples=4, n_burnin=4, n_sweeps=2)
RESUMED = dict(SAMPLE, mesh={"rows": 2}, seed=8)
JAX_SWEEP = dict(name="jax_k3_rows4", kind="sweeps", shape=[16, 16], seed=9,
                 mesh={"rows": 4}, n_sweeps=2, uniform_bits=24, fused=False)


def _sweep_cases(table):
    return [dict(name=name, kind="sweeps", shape=list(L), seed=11 + k, mesh=mesh, n_sweeps=2,
                 **kw) for k, (name, (mesh, kw)) in enumerate(table.items())]


def _cases4():
    return (_sweep_cases(SWEEPS_4)
            + [dict(SAMPLE, name=name, mesh=mesh) for name, mesh in SAMPLES_4.items()]
            + [JAX_SWEEP,
               dict(name="grid_rows4", kind="grid", shape=[16, 16], seed=6, mesh={"rows": 4},
                    n_samples=3, n_burnin=4, n_sweeps=2),
               dict(name="tempering", kind="tempering", shape=[8, 8], seed=7,
                    mesh={"replica": 4}, temperatures=[1.8, 3.0, 8], n_samples=6,
                    swap_interval=2, n_burnin=4),
               dict(name="smc", kind="smc", particles=[32, 3], seed=8, mesh={"chains": 4},
                    n_steps=12),
               dict(name="info", kind="info"),
               dict(name="pod_scaling", kind="pod_scaling", rows_per_device=8, cols=32,
                    chains_per_device=8, n_sweeps=4)])


def _cases2(snapshot_in, snapshot_out):
    return (_sweep_cases(SWEEPS_2)
            + [dict(SAMPLE, name=name, mesh=mesh) for name, mesh in SAMPLES_2.items()]
            + [dict(RESUMED, name="snapshot_then_stop",
                    checkpoint={"path": snapshot_out, "every": 2, "stop_after_first": True}),
               dict(RESUMED, name="resumed_from_one_process",
                    checkpoint={"path": snapshot_in, "every": 2, "resume": True}),
               dict(name="tempering", kind="tempering", shape=[8, 8], seed=7,
                    mesh={"replica": 2}, temperatures=[1.8, 3.0, 4], n_samples=6,
                    swap_interval=2, n_burnin=4),
               dict(name="smc", kind="smc", particles=[32, 3], seed=8, mesh={"chains": 2},
                    n_steps=12),
               dict(name="info", kind="info")])


def spawn(tmp: Path, n: int, cases: list) -> list:
    """Run ``cases`` on n gloo ranks, each a process of its own; returns each
    rank's saved results. Fails (after killing every rank) on a rank that
    fails or on the spawn outlasting its timeout."""
    (tmp / "cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tsu_tpu_torch.tools.multiprocess_check", str(tmp / "out"),
         str(tmp / "cases.json"), "--device", "cpu", "--init-method", f"file://{tmp}/rdzv",
         "--rank", str(r), "--world-size", str(n)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
              if p.returncode != 0]
    assert not failed, f"ranks failed: {failed}"
    return [torch.load(tmp / "out" / f"rank{r}.pt", weights_only=False) for r in range(n)]


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("ranks4"), 4, _cases4())


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    """Two ranks; before them one process writes a snapshot (stopped after
    it) that the ranks resume from, and the ranks write one (stopped after
    it) that the tests resume in one process."""
    tmp = tmp_path_factory.mktemp("ranks2")
    snapshot_in, snapshot_out = str(tmp / "one_process.pt"), str(tmp / "two_ranks.pt")
    one = dict(RESUMED, checkpoint={"path": snapshot_in, "every": 2,
                                    "stop_after_first": True})
    assert run_case(one, "cpu")["out"] == "stopped"
    return spawn(tmp, 2, _cases2(snapshot_in, snapshot_out)), snapshot_out


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a if k != "route")
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def _check_sweeps(results, case):
    ref = run_case(case, "cpu")["out"]
    for r, res in enumerate(results):
        got = res[case["name"]]["out"]
        assert _same(ref, got) if r == 0 else got == (None, None), f"rank {r}"


def _check_sample(results, case, ref=None):
    ref = run_case(case, "cpu")["out"] if ref is None else ref
    for r, res in enumerate(results):
        got = res[case["name"]]["out"]
        assert torch.equal(got["magnetization"], ref["magnetization"]), f"rank {r}"
        assert torch.equal(got["energy"], ref["energy"]), f"rank {r}"
        if r == 0:
            assert _same(got["final_planes"], ref["final_planes"])
        else:
            assert got["final_planes"] is None


@pytest.mark.parametrize("name", list(SWEEPS_4))
def test_sweeps_on_four_ranks_equal_one_process(ranks4, name):
    _check_sweeps(ranks4, next(c for c in _cases4() if c["name"] == name))


@pytest.mark.parametrize("name", list(SWEEPS_2))
def test_sweeps_on_two_ranks_equal_one_process(ranks2, name):
    _check_sweeps(ranks2[0], next(c for c in _cases2("", "") if c["name"] == name))


@pytest.mark.parametrize("name", list(SAMPLES_4))
def test_sample_on_four_ranks_equals_one_process(ranks4, name):
    _check_sample(ranks4, next(c for c in _cases4() if c["name"] == name))


@pytest.mark.parametrize("name", list(SAMPLES_2))
def test_sample_on_two_ranks_equals_one_process(ranks2, name):
    _check_sample(ranks2[0], next(c for c in _cases2("", "") if c["name"] == name))


def test_halos_cross_ranks_tagged(ranks2):
    """The two-rank ring trades its halos through the runtime: one exchange
    a sweep and one to gather the result, up and down halos both between
    ranks 0 and 1."""
    ex = [res["k1_rows2_u16_periodic"]["exchange"] for res in ranks2[0]]
    assert ex[0]["calls"] == 2 + 1 and ex[0]["messages"] == 2 * 2
    assert ex[1]["calls"] == 2 + 1 and ex[1]["messages"] == 2 * 2 + 2


def test_grid_sample_observables_takes_the_global_mesh(ranks4):
    case = next(c for c in _cases4() if c["name"] == "grid_rows4")
    ref = run_case(case, "cpu")["out"]
    for res in ranks4:
        assert _same(res["grid_rows4"]["out"], ref)


@pytest.mark.parametrize("n", [2, 4])
def test_replica_sharded_tempering_equals_one_process(ranks2, ranks4, n):
    results, cases = (ranks2[0], _cases2("", "")) if n == 2 else (ranks4, _cases4())
    ref = run_case(next(c for c in cases if c["name"] == "tempering"), "cpu")["out"]
    for res in results:
        got = res["tempering"]["out"]
        assert _same(got, ref)
        assert np.array_equal(got["rungs"], ref["rungs"])
        assert got["swap_accepts"] == ref["swap_accepts"]


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_smc_equals_one_process(ranks2, ranks4, n):
    results, cases = (ranks2[0], _cases2("", "")) if n == 2 else (ranks4, _cases4())
    ref = run_case(next(c for c in cases if c["name"] == "smc"), "cpu")["out"]
    for res in results:
        got = res["smc"]["out"]
        for k in ("particles", "log_weights", "ess_history"):
            assert np.array_equal(got[k], ref[k]), k
        assert got["log_Z"] == ref["log_Z"]
        assert got["route"] == "eager"


def test_one_sweep_on_four_ranks_matches_jax(ranks4):
    """K3 on 24-bit injected uniforms over 4 ranks against the JAX sharded
    sweep on 4 virtual CPU devices (interpret-mode Pallas), as
    tests/test_torch_sharding.py holds the one-process port."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from tsu_tpu.parallel import make_mesh as jax_make_mesh
    from tsu_tpu.parallel.lattice import sharded_checkerboard_sweeps as jax_sharded_sweeps

    R, C = JAX_SWEEP["shape"]
    red, black = (np.asarray(x) for x in split_checkerboard(lattice(JAX_SWEEP["seed"], (R, C))))
    U = np.random.default_rng(JAX_SWEEP["seed"] + 1).integers(0, 1 << 24, (2, 2, R, C // 2),
                                                              dtype=np.int32)
    with pltpu.force_tpu_interpret_mode():
        r_j, b_j = jax_sharded_sweeps(
            jax_make_mesh(rows=4), jax.random.key(0), jnp.asarray(red), jnp.asarray(black),
            2.269, 2, periodic=True, use_pallas=True, uniforms=jnp.asarray(U), fused=False)
    r_t, b_t = ranks4[0]["jax_k3_rows4"]["out"]
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))


def _uninterrupted():
    return run_case(RESUMED, "cpu")["out"]


def test_two_ranks_snapshot_resumes_on_one_process(ranks2):
    results, snapshot = ranks2
    assert all(res["snapshot_then_stop"]["out"] == "stopped" for res in results)
    resumed = run_case(dict(RESUMED, checkpoint={"path": snapshot, "every": 2,
                                                 "resume": True}), "cpu")["out"]
    assert _same(resumed, _uninterrupted())


def test_one_process_snapshot_resumes_on_two_ranks(ranks2):
    _check_sample(ranks2[0], dict(RESUMED, name="resumed_from_one_process"), _uninterrupted())


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_info_and_runner_topology_name_the_runtime(ranks2, ranks4, n):
    results = ranks2[0] if n == 2 else ranks4
    for res in results:
        info = res["info"]["out"]
        assert res["backend"] == "gloo" and res["world_size"] == n
        assert info["mesh_info"]["n_processes"] == n and info["mesh_info"]["n_devices"] == n
        assert info["mesh_info"]["n_hosts"] == 1 and info["mesh_info"]["backend"] == "gloo"
        topo = info["topology"]
        assert (topo["n_processes"], topo["n_hosts"], topo["dist_backend"]) == (n, 1, "gloo")


@pytest.mark.parametrize("n", [2, 4])
def test_multihost_initialize_twice_raises(ranks2, ranks4, n):
    for res in ranks2[0] if n == 2 else ranks4:
        assert res["info"]["out"]["twice"].startswith("RuntimeError: the multi-process runtime "
                                                      "is already initialised")


def test_pod_scaling_reports_the_runtime(ranks4):
    out = ranks4[0]["pod_scaling"]["out"]
    topo = out["topology"]
    assert (topo["backend"], topo["n_devices"], topo["n_processes"], topo["n_hosts"]) == (
        "gloo", 4, 4, 1)
    assert topo["shared_host_virtual_mesh"] is True
    for row in ("chains", "lattice"):
        assert out[row]["all_devices"]["n_devices"] == 4
        assert out[row]["efficiency"] is None      # four ranks on one host's CPU
    assert out["lattice"]["all_devices"]["flips_per_s"] > 0


@pytest.mark.parametrize("device,local_world,count,given,want", [
    ("cuda:0", 4, 4, None, "nccl"),      # a card a rank
    ("cuda:0", 4, 1, None, "gloo"),      # four ranks on one card
    ("cpu", 2, 0, None, "gloo"),
    ("cuda:0", 4, 1, "nccl", "nccl"),    # an explicit backend wins
    ("cpu", 1, 0, "gloo", "gloo"),
])
def test_backend_rule(device, local_world, count, given, want):
    assert distributed.backend_for(torch.device(device), local_world, count, given) == want


def test_one_process_has_no_runtime():
    """Without multihost_initialize nothing is distributed: meshes hold rank
    0 everywhere and a rank outside the group is refused."""
    from tsu_tpu_torch.parallel import make_mesh

    assert distributed.runtime() is None and distributed.world_size() == 1
    assert not make_mesh(rows=2, devices=["cpu"] * 2).ranks.any()
    with pytest.raises(ValueError, match="outside the process group"):
        make_mesh(rows=2, devices=["cpu"] * 2, ranks=[0, 1])
    with pytest.raises(RuntimeError, match="not initialised"):
        distributed.exchange([], [])


def test_initialize_without_a_card_raises(monkeypatch):
    """A rank asked for the card (the default) on a machine without CUDA
    raises before it joins any group: no fall-back to the CPU."""
    from tsu_tpu_torch.config import ConfigurationError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigurationError, match="CUDA is not available"):
        distributed.initialize(init_method="file:///nonexistent", rank=0, world_size=1)
    assert distributed.runtime() is None


def test_the_check_tool_knows_each_kind():
    assert set(multiprocess_check.KINDS) == {c["kind"] for c in _cases4() + _cases2("", "")}


def test_bnn_fit_refuses_a_mesh_across_processes():
    """The data-parallel BNN fit splits minibatches in one process; a mesh
    whose entries belong to other ranks is refused, not run on their devices."""
    from tsu_tpu_torch import BayesianRegressor
    from tsu_tpu_torch.config import ConfigurationError
    from tsu_tpu_torch.parallel import Mesh

    devices = np.empty((1, 2, 1, 1), dtype=object)
    devices[:] = torch.device("cpu")
    mesh = Mesh(devices, np.array([0, 1]).reshape(1, 2, 1, 1))
    x = np.linspace(-1, 1, 16, dtype=np.float32)[:, None]
    reg = BayesianRegressor(input_dim=1, hidden_dims=[4], seed=0, device="cpu")
    with pytest.raises(ConfigurationError, match="spans processes"):
        reg.fit(x, np.sin(x), n_epochs=1, batch_size=8, mesh=mesh)
