"""The port's counterparts of scripts/gen_docstrings.py and
scripts/extract_benchmarks.py, on the CPU: what they write, and that they
write new files only."""

import json
from pathlib import Path

import pytest

import tsu_tpu_torch
from tsu_tpu_torch.tools import extract_benchmarks, gen_docstrings

REPO = Path(__file__).resolve().parents[1]


def test_gen_docstrings_covers_the_namespace_and_the_surfaces(tmp_path):
    out = tmp_path / "DOCSTRINGS.md"
    assert gen_docstrings.main([str(out)]) == 0
    text = out.read_text()
    for name in tsu_tpu_torch.__all__:
        assert f"### `{name}" in text, name
    for mod, names in gen_docstrings.EXTRA_SURFACES:
        assert f"### module `{mod}`" in text
        for name in names:
            assert f"### `{mod.split('.')[-1]}.{name}(" in text, name
    assert "### `parallel.multihost_initialize(**kwargs)" in text


@pytest.mark.parametrize("tool,argv", [
    (gen_docstrings, lambda tmp: [str(REPO / "docs" / "DOCSTRINGS.md")]),
    (extract_benchmarks, lambda tmp: [str(tmp), str(REPO / "BENCHMARK_SUMMARY.md")]),
])
def test_tools_never_overwrite_a_file(tool, argv, tmp_path):
    (tmp_path / "benchmark_results.json").write_text(json.dumps({"topology": {}, "suites": {}}))
    before = {p: p.read_bytes() for p in (REPO / "docs" / "DOCSTRINGS.md",
                                          REPO / "BENCHMARK_SUMMARY.md")}
    with pytest.raises(FileExistsError):
        tool.main(argv(tmp_path))
    assert all(p.read_bytes() == b for p, b in before.items())


def _results(card):
    return {"topology": {"backend": "cuda", "n_devices": 1, "device_kind": "NVIDIA H100 80GB HBM3",
                         "card": card, "n_hosts": 2, "n_processes": 8, "dist_backend": "nccl",
                         "torch": "2.11.0", "cuda": "12.8"},
            "seed": 0, "quick": True, "total_time_s": 19.3, "resumed_run": False,
            "suites": {"sampling": [{"name": "gaussian", "ks_pvalue": 0.4, "time_s": 1.0},
                                    {"name": "ising", "time_s": 2.0}], "ml": []}}


def test_extract_benchmarks_names_the_card_and_summarises(tmp_path):
    (tmp_path / "benchmark_results.json").write_text(json.dumps(
        _results("NVIDIA H100 80GB HBM3, 700.00 W")))
    (tmp_path / "scaling_gloo4_h1.json").write_text(json.dumps({
        "topology": {"backend": "gloo", "n_devices": 4, "card": None},
        "chains": {"efficiency": None, "ideal": "one card"},
        "lattice": {"efficiency": None, "ideal": "one card"}}))
    out = tmp_path / "SUMMARY.md"
    assert extract_benchmarks.main([str(tmp_path), str(out)]) == 0
    text = out.read_text()
    assert "Card: NVIDIA H100 80GB HBM3, 700.00 W" in text
    assert "8 process(es) on 2 host(s)" in text and "quick mode" in text
    assert "| name | ks_pvalue | time_s |" in text and "| ising |  | 2.0 |" in text
    assert "### scaling (scaling_gloo4_h1.json; 4 device(s), backend gloo" in text
    assert "- lattice: efficiency=None (ideal: one card)" in text


def test_extract_benchmarks_on_a_cpu_run(tmp_path):
    res = _results(None)
    res["topology"]["backend"] = "cpu"
    assert "Card: no card (cpu)" in extract_benchmarks.render(res, {})
