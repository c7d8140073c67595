"""The port's critical-ESS, scaling-projection and spin-glass probe tools
(``tsu_tpu_torch/tools/``) and its graft entry (``graft_entry.py``)
against the repository's scripts and ``__graft_entry__.py``, on the CPU.

critical_ess: the per-measurement |m| and e/site equal the reference's on
the same planes (1e-6), ``tau_and_ess`` equals the reference's (rtol
1e-6), ``main`` writes the reference's keys (quick and full, on synthetic
series in place of the sweeps), and the projection is the reference's
arithmetic at the kernel rate it is given, not a constant. scaling:
``project`` equals the reference's on the same inputs. The PT probe prints
the reference's keys at L = 8. ``entry`` and ``dryrun_multichip(4)`` pass on
the CPU repeated. Without CUDA every entry point raises.
"""

import importlib.util
import inspect
import json
import os
import sys

import numpy as np
import pytest
import torch

import tsu_tpu.oracle.wolff as jwolff
from tsu_tpu.ops.checkerboard import lattice_energy_batch as jax_lattice_energy
from tsu_tpu.ops.checkerboard import merge_checkerboard as jax_merge
from tsu_tpu_torch import graft_entry
from tsu_tpu_torch.config import ConfigurationError
from tsu_tpu_torch.ops.checkerboard import split_checkerboard
from tsu_tpu_torch.oracle import wolff_chain
from tsu_tpu_torch.tools import critical_ess as ce
from tsu_tpu_torch.tools import pt_spin_glass_probe as probe
from tsu_tpu_torch.tools import scaling_projection as sp

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(f"ref_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_ce():
    return _script("critical_ess")


@pytest.mark.parametrize("L,p_up", [(8, 0.5), (16, 0.9), (32, 0.2)])
def test_observables_equal_the_reference_meas(L, p_up):
    rng = np.random.default_rng(L)
    lat = np.where(rng.random((L, L)) < p_up, 1.0, -1.0).astype(np.float32)
    red, black = split_checkerboard(torch.from_numpy(lat).to(torch.bfloat16))
    ours = ce.observables(red, black).numpy()
    n = L * L
    r, b = red.float().numpy(), black.float().numpy()
    m_ref = abs((r.sum() + b.sum()) / n)
    e_ref = float(jax_lattice_energy(jax_merge(r, b), J=1.0, field=0.0, periodic=True)) / n
    np.testing.assert_allclose(ours, [m_ref, e_ref], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("thin", [1, 7])
def test_tau_and_ess_equal_the_reference(thin, ref_ce):
    rng = np.random.default_rng(thin)
    x = np.zeros(3000)
    for t in range(1, len(x)):
        x[t] = 0.9 * x[t - 1] + rng.normal()
    ours, ref = ce.tau_and_ess(x, thin), ref_ce.tau_and_ess(x, thin)
    np.testing.assert_allclose(ours, ref, rtol=1e-6)


def test_measure_series_pads_to_chunks_and_repeats(monkeypatch):
    monkeypatch.setattr(ce, "chunk_size", lambda L, thin: 10)
    a = ce.measure_series(3, 8, 2.269, thin=2, n_meas=25, burnin=10, device=CPU)
    b = ce.measure_series(3, 8, 2.269, thin=2, n_meas=25, burnin=10, device=CPU)
    m, e, rate = a
    assert m.shape == e.shape == (30,)
    assert np.all((m >= 0) & (m <= 1)) and np.all((e >= -2) & (e <= 2)) and rate > 0
    np.testing.assert_array_equal(m, b[0])
    np.testing.assert_array_equal(e, b[1])


def _fake_series(*args, n_meas, **_):
    """An AR(1) |m| and e/site series of n_meas points at 1e3 sweeps/s."""
    rng = np.random.default_rng(n_meas)
    x = np.zeros(n_meas)
    for t in range(1, n_meas):
        x[t] = 0.8 * x[t - 1] + 0.05 * rng.normal()
    return np.abs(0.5 + x), -1.4 + x, 1000.0


def _fast_wolff(seed, L, T, n_steps, **_):
    return wolff_chain(seed, L, T, n_steps=min(n_steps, 40), n_burnin=5)


def _run_reference(ref_ce, monkeypatch, tmp_path, quick):
    monkeypatch.setattr(ref_ce, "measure_series", _fake_series)
    monkeypatch.setattr(jwolff, "wolff_chain", _fast_wolff)
    import tsu_tpu.profiling

    monkeypatch.setattr(tsu_tpu.profiling, "enable_compilation_cache", lambda *a: None)
    monkeypatch.setattr(sys, "argv", ["critical_ess.py"] + (["--quick"] if quick else []))
    work = tmp_path / "ref"
    work.mkdir()
    monkeypatch.chdir(work)
    monkeypatch.setattr("tempfile.tempdir", str(work))
    ref_ce.main()
    name = "critical_ess_quick.json" if quick else os.path.join("visual_output",
                                                                "critical_ess.json")
    with open(work / name) as f:
        return json.load(f)


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
def test_main_writes_the_reference_keys(quick, ref_ce, monkeypatch, tmp_path, capsys):
    from tsu_tpu_torch.tools import timing

    ref = _run_reference(ref_ce, monkeypatch, tmp_path, quick)
    monkeypatch.setattr(ce, "measure_series", _fake_series)
    monkeypatch.setattr(ce, "wolff_chain", _fast_wolff)
    monkeypatch.setattr(ce, "kernel_sweeps_per_s", lambda dev: 1.30e11 / 4096 ** 2)
    monkeypatch.setattr(timing, "card", lambda: "TEST CARD, 700.00 W")
    work = tmp_path / "ours"
    work.mkdir()
    monkeypatch.chdir(work)
    monkeypatch.setattr("tempfile.tempdir", str(work))
    ours = ce.main(["--device", CPU] + (["--quick"] if quick else []))
    assert os.path.exists(work / ("critical_ess_quick.json" if quick
                                  else os.path.join("visual_output", "critical_ess.json")))
    assert ours.keys() == ref.keys()
    assert [r.keys() for r in ours["rows"]] == [r.keys() for r in ref["rows"]]
    assert [r["label"] for r in ours["rows"]] == [r["label"] for r in ref["rows"]]
    for a, b in zip(ours["rows"], ref["rows"]):
        assert a == b          # the same settings and arithmetic on the same series
    assert ours["fit_Tc"] == ref["fit_Tc"]
    assert [r.keys() for r in ours["wolff_Tc"]] == [r.keys() for r in ref["wolff_Tc"]]
    if not quick:
        # At the reference's kernel rate the projection is the reference's;
        # the port adds the card that rate was measured on.
        p, q = ours["projection_4096_Tc"], ref["projection_4096_Tc"]
        assert set(p) - set(q) == {"kernel_rate_card"}
        assert p["kernel_rate_card"] == "TEST CARD, 700.00 W"
        for k in q:
            if k != "note":
                assert p[k] == q[k], k


def test_projection_uses_the_rate_it_is_given():
    p = ce.projection(0.3, 2.17, 256, 5000.0, 12.5, 7777.0, "card X")
    assert p["sweeps_per_s_headline_kernel"] == 7777.0
    tau = 0.3 * 4096 ** 2.17
    assert p["ess_M_per_s_at_kernel_rate"][0] == round(7777.0 / (2 * tau), 6)
    assert p["tau_int_M_sweeps_projected_z2.17"] == round(5000.0 * 16 ** 2.17, 0)
    assert "card X" in p["note"]
    source = inspect.getsource(ce)
    assert "1.30e11" not in source and "1.3e11" not in source


@pytest.fixture(scope="module")
def ref_sp():
    return _script("scaling_projection")


@pytest.mark.parametrize("n_chips", [2, 4, 8])
@pytest.mark.parametrize("link", [1.0e11, 2.5e10, sp.NVLINK_BYTES_PER_S])
def test_project_equals_the_reference(n_chips, link, ref_sp):
    measured = {"size": 4096, "itemsize": 2, "sweep_time_s": 5.3e-5, "flips_per_s": 3.1e11}
    assert sp.project(measured, n_chips, link, ref_sp.COLLECTIVE_LATENCY_S) == \
        ref_sp.project(measured, n_chips, link)


def test_scaling_projection_on_the_cpu_writes_no_file(monkeypatch, tmp_path, capsys):
    small = sp.measure_sharded_sweep_time
    monkeypatch.setattr(sp, "measure_sharded_sweep_time",
                        lambda device=None: small(size=64, n_sweeps=4, trials=1, device=device))
    monkeypatch.chdir(tmp_path)
    out = sp.main(["--device", CPU])
    m = out["measured_1chip"]
    assert m["backend"] == CPU and m["itemsize"] == 2 and m["copy_latency_s"] > 0
    assert [p["n_chips"] for p in out["projected_nvlink"]] == [2, 4, 8]
    assert 0 < out["projected_ndr_2host"]["projected_efficiency"] <= 1
    assert not os.path.exists(tmp_path / "visual_output")


def test_pt_probe_prints_the_reference_keys(monkeypatch, capsys):
    monkeypatch.setenv("PT_FB_ITERS", "32")
    ref_probe = _script("pt_spin_glass_probe")
    monkeypatch.setattr(ref_probe, "enable_compilation_cache", lambda *a: None)
    monkeypatch.setattr(sys, "argv", ["pt_spin_glass_probe.py", "8", "20"])
    ref_probe.main()
    ref = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    ours = probe.main(["8", "20", "--device", CPU])
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert printed == ours
    assert [o.keys() for o in ours] == [r.keys() for r in ref]
    assert [o["stage"] for o in ours] == ["ladder", "gs"]
    assert ours[1]["L"] == 8 and ours[1]["n_iters"] == 20
    assert -2.0 <= ours[1]["energy_per_site"] < -1.0


def test_entry_runs_one_sweep():
    fn, args = graft_entry.entry(CPU)
    out = fn(*args)
    assert tuple(out.shape) == (256, 256) and out.dtype == torch.float32
    assert set(torch.unique(out).tolist()) <= {-1.0, 1.0}
    assert not torch.equal(out, args[1])
    assert torch.equal(out, fn(*args))


@pytest.mark.parametrize("n", [1, 4])
def test_dryrun_multichip_on_the_cpu(n):
    graft_entry.dryrun_multichip(n, CPU)


def test_mesh_devices_repeat_the_first_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    got = graft_entry.mesh_devices(4)
    assert got == [torch.device("cuda", 0), torch.device("cuda", 1),
                   torch.device("cuda", 0), torch.device("cuda", 0)]
    assert graft_entry.mesh_devices(3, CPU) == [torch.device(CPU)] * 3


@pytest.mark.parametrize("call", [
    lambda: ce.measure_series(0, 8, 2.269, thin=1, n_meas=10, burnin=1),
    lambda: ce.main([]),
    lambda: ce.kernel_sweeps_per_s(None),
    lambda: sp.main([]),
    lambda: probe.main([]),
    lambda: graft_entry.entry(),
    lambda: graft_entry.dryrun_multichip(4),
], ids=["measure_series", "critical_ess", "kernel_rate", "scaling_projection", "pt_probe",
        "entry", "dryrun"])
def test_without_cuda_the_tools_refuse_the_cpu(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigurationError):
        call()
