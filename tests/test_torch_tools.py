"""The port's measurement tools on the CPU: the headline bench,
kernel_bench and kernel_decomposition run at 64^2 when asked for the CPU and
raise without a card otherwise, as the body tool (bodies, for K3, K4/K5
and K6/K7) does; importing the tools imports no JAX or Triton and builds
nothing."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tsu_tpu_torch.config import ConfigurationError
from tsu_tpu_torch.tools import (
    bench,
    bodies,
    kernel_bench,
    kernel_decomposition,
)

REPO = Path(__file__).resolve().parents[1]
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "ea_bond_flips_per_s"}   # bench.py's


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.splitlines()[-1])


def test_bench_on_the_cpu_prints_bench_py_keys(capsys):
    assert bench.main(["--device", "cpu", "--size", "64", "--sweeps", "3", "--ea-sweeps", "2",
                       "--calls", "1", "--trials", "3"]) == 0
    out = _last_json(capsys)
    assert set(out) == BENCH_KEYS
    assert out["metric"] == "ising_spin_flips_per_s_per_chip_64x64" and out["unit"] == "flips/s"
    assert out["value"] > 0 and out["ea_bond_flips_per_s"] > 0
    assert out["vs_baseline"] == pytest.approx(out["value"] / bench.REFERENCE_FLIPS_PER_S)


def test_kernel_bench_on_the_cpu_times_every_row(capsys):
    assert kernel_bench.main(["all", "--device", "cpu", "--size", "64", "--sweeps", "4",
                              "--iters", "1", "--dtype", "f32"]) == 0
    out = _last_json(capsys)
    assert out["device"] == "cpu" and out["size"] == 64 and out["check"] == {}
    assert set(out["rows"]) == {"fused", "resident", "plain(10/call)"}
    assert out["rows"]["plain(10/call)"]["sweeps_per_call"] == 10
    assert all(r["flips_per_s"] > 0 for r in out["rows"].values())


def test_kernel_bench_check_gives_moments():
    cpu = torch.device("cpu")
    step, _, dtype = kernel_bench.steps("resident", torch.float32, 4, cpu)["resident"]
    c = kernel_bench.moments(step, dtype, cpu, size=16, T=3.0, burn_in=20, n_samples=40)
    assert 0.0 <= c["abs_m"] < 0.5 and -2.0 < c["e"] < -0.5
    assert np.isfinite([c["se_abs_m"], c["se_e"]]).all()


@pytest.mark.parametrize("main", [
    lambda: bench.main(["--size", "64", "--sweeps", "2", "--ea-sweeps", "2", "--calls", "1",
                        "--trials", "1"]),
    lambda: kernel_bench.main(["all", "--size", "64", "--sweeps", "2", "--iters", "1"]),
    lambda: kernel_decomposition.main(["--size", "64", "--sweeps", "2"]),
    lambda: bodies.main(["K4", "--rounds", "1"]),
    lambda: bodies.main(["K6", "--rounds", "1", "--sweeps", "2"]),
    lambda: bodies.main(["K3", "--rounds", "1"]),
])
def test_tools_without_a_card_raise(monkeypatch, main):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigurationError, match="CUDA is not available"):
        main()


def test_kernel_decomposition_on_the_cpu_times_every_variant(capsys):
    assert kernel_decomposition.main(["--device", "cpu", "--size", "64", "--sweeps", "3"]) == 0
    out = _last_json(capsys)
    assert out["device"] == "cpu"
    assert set(out["ms_per_sweep"]) == set(kernel_decomposition.VARIANTS)
    shares = out["share_of_baseline"]
    assert set(shares) == set(kernel_decomposition.PARTS)
    assert sum(shares.values()) == pytest.approx(1.0)


def test_importing_the_tools_pulls_in_no_jax_or_triton_and_builds_nothing():
    code = (
        "import json, sys\n"
        "import tsu_tpu_torch.tools.bench, tsu_tpu_torch.tools.kernel_bench\n"
        "import tsu_tpu_torch.tools.kernel_decomposition, tsu_tpu_torch.tools.profile_paths\n"
        "import tsu_tpu_torch.tools.timing, tsu_tpu_torch.tools.bodies\n"
        "from tsu_tpu_torch.ops import _build\n"
        "from tsu_tpu_torch.ops import checkerboard_resident as cr\n"
        "libs = (_build.library, cr.resident_grid, cr._card_limits)\n"
        "print(json.dumps({'jax': 'jax' in sys.modules, 'triton': 'triton' in sys.modules,\n"
        "                  'tsu_tpu': 'tsu_tpu' in sys.modules,\n"
        "                  'built': sum(f.cache_info().currsize for f in libs)}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.splitlines()[-1]) == {
        "jax": False, "triton": False, "tsu_tpu": False, "built": 0}


def test_sass_count_reads_registers_and_spills_from_ptxas():
    from tsu_tpu_torch.tools import sass_count

    text = (
        "ptxas info    : Compiling entry function '_Z1kPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1kPf\n"
        "    16 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads\n"
        "ptxas info    : Used 64 registers, used 1 barriers, 36 bytes smem\n"
        "ptxas info    : Compiling entry function '_Z1gPf' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 72 registers, used 0 barriers\n")
    assert sass_count.ptxas_report(text) == {
        "_Z1kPf": {"registers": 64, "stack": 16, "spill_stores": 12, "spill_loads": 16},
        "_Z1gPf": {"registers": 72, "stack": 0, "spill_stores": 0, "spill_loads": 0}}


def test_sass_count_gives_the_bond_kernels_rows_per_site():
    """A bond kernel's innermost loop is one row of a thread's four sites,
    and a bond kernel whose name fixes its strip height (TR = 8) is the
    whole strip unrolled: the report adds their int32 instructions per site,
    for the bond kernels only. The unguarded branch to itself that pads a
    kernel's end is no loop."""
    from tsu_tpu_torch.tools import sass_count

    body = (
        "        /*0000*/                   MOV R1, c[0x0][0x28] ;\n"
        "        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;\n"
        "        /*0020*/                   LOP3.LUT R3, R2, 0x3, RZ, 0xc0, !PT ;\n"
        "        /*0030*/                   STG.E [R4.64], R3 ;\n"
        "        /*0040*/                   ISETP.GE.AND P0, PT, R2, 0x8, PT ;\n"
        "        /*0050*/              @!P0 BRA 0x10 ;\n"
        "        /*0060*/                   EXIT ;\n")
    text = ("        Function : _Z21bond_halfsweep_kernelPf\n" + body
            + "        Function : _Z18fused_sweep_kernelPf\n" + body)
    got = sass_count.report(sass_count.parse(text))
    (bond,) = got["_Z21bond_halfsweep_kernelPf"]["loops"]
    assert bond == {"range": ["0x10", "0x50"], "instructions": 5, "longest_path": 5,
                    "longest_path_int32": 3, "int32_per_site": 0.75}
    (fused,) = got["_Z18fused_sweep_kernelPf"]["loops"]
    assert "int32_per_site" not in fused

    unrolled = (
        "        Function : _Z21bond_halfsweep_kernelILi8EEEvPf\n"
        "        /*0000*/                   IADD3 R2, R2, 0x1, RZ ;\n"
        "        /*0010*/                   LOP3.LUT R3, R2, 0x3, RZ, 0xc0, !PT ;\n"
        "        /*0020*/                   STG.E [R4.64], R3 ;\n"
        "        /*0030*/                   EXIT ;\n"
        "        /*0040*/                   BRA 0x40 ;\n")
    got = sass_count.report(sass_count.parse(unrolled))["_Z21bond_halfsweep_kernelILi8EEEvPf"]
    assert got["loops"] == [] and got["longest_path"] == 4 and got["rows"] == 8
    assert got["int32_per_site"] == 2 / 32


@pytest.mark.parametrize("names,rounds,want", [
    (["a", "b"], 2, [(0, "a"), (0, "b"), (1, "b"), (1, "a")]),
    (["a", "b", "c"], 3, [(0, "a"), (0, "b"), (0, "c"), (1, "c"), (1, "b"), (1, "a"),
                          (2, "a"), (2, "b"), (2, "c")]),
    (["a"], 2, [(0, "a"), (1, "a")]),
])
def test_body_versions_take_turns_forward_then_backward(names, rounds, want):
    assert list(bodies.in_turns(names, rounds)) == want


def test_build_versions_builds_each_source_under_its_own_name(monkeypatch, tmp_path):
    """Each source is built as <prefix>_<i> from its absolute path and loaded
    with the entries of the library the caller names for it; nothing is
    compiled here."""
    built = []
    monkeypatch.setattr(bodies._build, "library_path",
                        lambda name, sources: built.append((name, sources)) or f"{name}.so")
    monkeypatch.setattr(bodies._build, "load", lambda name, path: (name, path))
    srcs = [str(tmp_path / "a.cu"), "tsu_tpu_torch/csrc/checkerboard_resident.cu"]
    got = bodies.build_versions(srcs, "resident_body", lambda src: "checkerboard_resident")
    assert got == {srcs[0]: ("checkerboard_resident", "resident_body_0.so"),
                   srcs[1]: ("checkerboard_resident", "resident_body_1.so")}
    assert [name for name, _ in built] == ["resident_body_0", "resident_body_1"]
    assert all(Path(src[0]).is_absolute() for _, src in built)


def test_sass_count_gives_the_resident_kernel_int32_per_site():
    """An iteration of the resident kernel's item loop updates a lane's eight
    sites once a sweep: its loops carry int32 per site like the bond
    kernels' rows."""
    from tsu_tpu_torch.tools import sass_count

    text = ("        Function : _Z15resident_kernelI13__nv_bfloat16Lb0ELb1EEvPT_\n"
            "        /*0000*/                   IMAD.WIDE.U32 R2, R2, 0x3, RZ ;\n"
            "        /*0010*/                   LOP3.LUT R3, R2, 0x3, RZ, 0x96, !PT ;\n"
            "        /*0020*/                   LDS R4, [R3] ;\n"
            "        /*0030*/                   ISETP.GE.AND P0, PT, R2, 0x8, PT ;\n"
            "        /*0040*/              @!P0 BRA 0x0 ;\n"
            "        /*0050*/                   EXIT ;\n")
    (loop,) = sass_count.report(sass_count.parse(text))[
        "_Z15resident_kernelI13__nv_bfloat16Lb0ELb1EEvPT_"]["loops"]
    assert loop["longest_path_int32"] == 3 and loop["int32_per_site"] == 3 / 8


@pytest.mark.parametrize("after", [False, True])
def test_sass_count_gives_the_halfsweep_strip_per_site_and_its_mufu(after):
    """K3 computes its threshold table (MUFU, CALL) before a barrier and
    then walks an unrolled strip of TR = 8 rows: the report gives its int32
    per site like the bond kernels' and counts the MUFU and CALL
    instructions reachable from the barrier, none unless one follows it."""
    from tsu_tpu_torch.tools import sass_count

    name = "_ZN12_GLOBAL__N_116halfsweep_kernelIfLb1ELb0ELb1ELi8EEEvPKT_"
    tail = ("        /*0060*/                   MUFU.EX2 R5, R5 ;\n" if after else "")
    text = ("        Function : " + name + "\n"
            "        /*0000*/                   MUFU.EX2 R2, R2 ;\n"
            "        /*0010*/                   CALL.REL.NOINC 0x80 ;\n"
            "        /*0020*/                   BAR.RED.OR.DEFER_BLOCKING 0x0, P0 ;\n"
            "        /*0030*/                   IADD3 R2, R2, 0x1, RZ ;\n"
            "        /*0040*/                   LOP3.LUT R3, R2, 0x3, RZ, 0xc0, !PT ;\n"
            "        /*0050*/                   STG.E [R4.64], R3 ;\n"
            + tail +
            "        /*0070*/                   EXIT ;\n"
            "        /*0080*/                   MUFU.RCP R6, R6 ;\n"
            "        /*0090*/                   RET.REL.NODEC R20 0x0 ;\n")
    got = sass_count.report(sass_count.parse(text))[name]
    assert got["loops"] == [] and got["rows"] == 8
    assert got["int32_per_site"] == got["longest_path_int32"] / 32
    assert got["mufu_or_call_after_barrier"] == (1 if after else 0)


def test_sass_count_takes_a_shuffles_divergent_fallback_for_no_loop():
    """A shuffle the compiler cannot prove converged gets an out-of-line
    fallback (BRA.DIV to WARPSYNC.COLLECTIVE, SHFL, ENDCOLLECTIVE and a
    branch back): that backward branch is a return, not a loop."""
    from tsu_tpu_torch.tools import sass_count

    name = "_ZN12_GLOBAL__N_116halfsweep_kernelIfLb1ELb0ELb1ELi8EEEvPKT_"
    text = ("        Function : " + name + "\n"
            "        /*0000*/                   IADD3 R2, R2, 0x1, RZ ;\n"
            "        /*0010*/                   BRA.DIV UR4, 0x60 ;\n"
            "        /*0020*/                   SHFL.IDX PT, R3, R2, R5, 0x1f ;\n"
            "        /*0030*/                   LOP3.LUT R3, R3, 0x3, RZ, 0xc0, !PT ;\n"
            "        /*0040*/                   STG.E [R4.64], R3 ;\n"
            "        /*0050*/                   EXIT ;\n"
            "        /*0060*/                   WARPSYNC.COLLECTIVE R6, 0x90 ;\n"
            "        /*0070*/                   SHFL.IDX P0, R3, R2, R5, 0x1f ;\n"
            "        /*0080*/                   ENDCOLLECTIVE ;\n"
            "        /*0090*/                   BRA 0x30 ;\n")
    got = sass_count.report(sass_count.parse(text))[name]
    assert got["loops"] == [] and got["rows"] == 8
    assert got["longest_path"] == 6 and got["longest_path_int32"] == 2
