"""Port parity: the sensitivity report (``repro_torch.core.report``) and
its launcher (``python -m repro_torch.launch.sensitivity``).

The reference cannot remake its report on jax 0.9.0 (its grid fails;
ROADMAP, "Reference baseline"), so the committed baseline
``benchmarks/baselines/sensitivity_rounds96.json`` is the reference's
output here:

* the launcher at the baseline's configuration (96 rounds, HS3D kernel
  0) writes a schema-3 report (solo, mix and NoC sections) and its
  markdown, and its gate passes; all 45 solo cells equal the
  baseline's within rel 1e-6 on every reported metric, with no more
  executables than the baseline's 9;
* sampled mix and NoC cells equal the port's per-point ``simulate()``;
* ``compare_reports`` returns the reference's failure list on planted
  drift, executable growth, a schema downgrade, a config mismatch and a
  missing cell; ``to_markdown`` and ``write_report`` give the
  reference's text and files for the same report.
"""
import copy
import dataclasses
import json
import math
import os

import pytest

torch = pytest.importorskip("torch")

from repro.core.report import compare_reports as ref_compare  # noqa: E402
from repro.core.report import to_markdown as ref_to_markdown  # noqa: E402
from repro.core.report import write_report as ref_write_report  # noqa: E402
from repro_torch.core import (APPS, PAPER_GEOMETRY, AppResult,  # noqa: E402
                              MixResult, WorkloadMix, make_trace, simulate)
from repro_torch.core import report  # noqa: E402
from repro_torch.launch import sensitivity  # noqa: E402

BASELINE = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                        "baselines", "sensitivity_rounds96.json")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The launcher's full run on the CPU: (exit code, report, paths)."""
    out = tmp_path_factory.mktemp("sens") / "sensitivity.json"
    rc = sensitivity.main(["--device", "cpu", "--rounds", "96",
                           "--report-json", str(out), "--check", BASELINE])
    return rc, report.load_report(str(out)), out


def test_launcher_writes_and_gates_the_full_report(cli):
    rc, rep, out = cli
    assert rc == 0
    assert rep["schema"] == report.SCHEMA_VERSION == 3
    assert out.with_suffix(".md").read_text() == report.to_markdown(rep)
    base = report.load_report(BASELINE)
    assert report.compare_reports(base, rep) == []
    assert rep["sweep"]["n_executables"] <= base["sweep"]["n_executables"]
    assert rep["sweep"]["n_executables"] == 9
    assert rep["sweep"]["n_points"] == 35 and rep["sweep"]["n_devices"] == 1
    got = {(c["arch"], c["knob"], c["value"]): c for c in rep["cells"]}
    assert len(got) == len(base["cells"]) == 45
    for c in base["cells"]:
        cell = got[(c["arch"], c["knob"], c["value"])]
        for m in report.CELL_METRICS:
            assert math.isclose(cell[m], c[m], rel_tol=1e-6, abs_tol=0.0), \
                (c["arch"], c["knob"], c["value"], m, cell[m], c[m])
    assert len(rep["mix"]["cells"]) == len(report.MIX_PAIRINGS) * 6
    assert len(rep["noc"]["cells"]) == 5 * 3 * 4
    assert rep["noc"]["sweep"]["n_executables"] == 3   # one per family


def test_report_noc_and_mix_cells_equal_per_point_simulate(cli):
    _, rep, _ = cli
    trace = make_trace(dataclasses.replace(APPS["HS3D"], rounds=96))
    noc = {(c["arch"], c["noc"], c["noc_bw"]): c for c in rep["noc"]["cells"]}
    for arch, model in (("remote", "crossbar"), ("victim", "ring")):
        geom = dataclasses.replace(PAPER_GEOMETRY, noc_bw=4.0)
        agg = AppResult("HS3D", arch, [simulate(arch, trace, geom,
                                                noc=model, device="cpu")])
        for m in report.NOC_CELL_METRICS:
            assert noc[(arch, model, 4.0)][m] == float(getattr(agg, m)), m
    mix = WorkloadMix(apps=("cfd", "HS3D"), rounds=96)
    mr = MixResult(mix, "ata", shared=simulate("ata", mix.compose(30),
                                               device="cpu"),
                   solo=[simulate("ata", t, device="cpu")
                         for t in mix.component_traces(30)])
    cell, = [c for c in rep["mix"]["cells"]
             if (c["mix"], c["arch"]) == ("cfd+HS3D", "ata")]
    assert cell["weighted_speedup"] == mr.weighted_speedup
    assert cell["unfairness"] == mr.unfairness
    assert cell["per_app_ipc"] == mr.per_app_ipc


def _plant(rep, how):
    rep = copy.deepcopy(rep)
    if how == "solo_drift":
        rep["cells"][7]["ipc"] *= 1.15
    elif how == "executable_growth":
        rep["sweep"]["n_executables"] += 1
    elif how == "schema_downgrade":
        rep["schema"] = 1
    elif how == "config_mismatch":
        rep["config"]["rounds"] = 128
    elif how == "missing_cell":
        del rep["cells"][3]
    elif how == "mix_drift":
        rep["mix"]["cells"][5]["weighted_speedup"] *= 0.8
        rep["mix"]["sweep"]["n_executables"] += 2
    elif how == "noc_drift":
        rep["noc"]["cells"][11]["ipc"] *= 1.2
    elif how == "noc_missing":
        del rep["noc"]
    return rep


@pytest.mark.parametrize("how,match", [
    ("solo_drift", "solo IPC drift"),
    ("executable_growth", "solo executable count grew: 9 -> 10"),
    ("schema_downgrade", "schema mismatch"),
    ("config_mismatch", "config mismatch"),
    ("missing_cell", "solo cell missing"),
    ("mix_drift", "mix weighted-speedup drift"),
    ("noc_drift", "noc IPC drift"),
    ("noc_missing", "noc section missing"),
])
def test_compare_reports_flags_what_the_reference_flags(cli, how, match):
    _, rep, _ = cli
    bad = _plant(rep, how)
    got = report.compare_reports(rep, bad)
    assert got == ref_compare(rep, bad)
    assert got and any(match in f for f in got), got
    # against the schema-1 baseline only the solo section gates
    base = report.load_report(BASELINE)
    assert report.compare_reports(base, bad) == ref_compare(base, bad)


def test_markdown_and_files_match_the_reference(cli, tmp_path):
    _, rep, _ = cli
    assert report.to_markdown(rep) == ref_to_markdown(rep)
    mine = report.write_report(str(tmp_path / "port.json"), rep)
    theirs = ref_write_report(str(tmp_path / "ref.json"), rep)
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()
    assert open(mine).read() == open(theirs).read()
    assert json.loads((tmp_path / "port.json").read_text()) == rep
    assert "## Multi-tenant fairness" in open(mine).read()
    assert "## Interconnect topology sensitivity" in open(mine).read()


def test_report_carries_a_manifest_and_still_gates(cli):
    """``run_sensitivity`` attaches the run manifest, as the reference's
    report does; the gate reads only the baseline's sections, so it
    passes with or without it."""
    rc, rep, _ = cli
    man = rep["manifest"]
    assert {"git_sha", "torch_version", "cuda_version", "backend",
            "device_name", "power_limit", "kernel_builds", "compile_counts",
            "phases_wall_s"} <= set(man)
    assert set(man["phases_wall_s"]) == {"sweep", "mix_grid", "report"}
    assert sorted(man["kernel_builds"]) == [
        "ata_probe_rank", "ata_tag_probe", "flash_attention", "wkv6"]
    base = report.load_report(BASELINE)
    assert "manifest" not in base
    assert rc == 0 and report.compare_reports(base, rep) == []
    bare = {k: v for k, v in rep.items() if k != "manifest"}
    assert report.compare_reports(base, bare) == []
    assert ref_compare(base, rep) == []
