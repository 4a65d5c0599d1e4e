"""Port parity: the benchmark surface (``repro_torch.launch``'s
``sim_speed``, ``serving_scale``, ``kernel_micro``, ``roofline``,
``bench`` and ``check_regression``; ``core.report``'s simspeed and
serving gates; ``core.figures``' geometry and NoC rows; the probe routes
of ``kernels.ops``).

* ``compare_simspeed``/``compare_serving`` return the reference's
  failure list, string for string once the reference's backend names are
  read as the port's, on the same mutated reports; both committed
  baselines pass the port's gate against themselves with their names
  translated;
* ``serving_scale.run`` equals the reference's ``fig_serving_scale.run``
  cell for cell (every field but the wall-clock ones) at a small grid;
* the probe routes on both impls equal the reference's ``impl="ref"``
  oracles at ``kernel_micro``'s shapes;
* ``sim_speed`` self-gates and its grids equal per-point reference
  ``simulate()`` (the reference's grid fails here, ROADMAP "Reference
  baseline"); the figure rows hold against reference per-point ratios;
* ``bench``'s failure collector and ``check_regression``'s exit codes;
* no module of the port, nor ``chip_smoke.py``, imports the reference.
"""
import ast
import copy
import dataclasses
import json
import math
import os
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import APPS as REF_APPS  # noqa: E402
from repro.core import PAPER_GEOMETRY as REF_GEOMETRY  # noqa: E402
from repro.core import make_trace as ref_make_trace  # noqa: E402
from repro.core import simulate as ref_simulate  # noqa: E402
from repro.core.metrics import AppResult as RefAppResult  # noqa: E402
from repro.core.report import compare_serving as ref_serving  # noqa: E402
from repro.core.report import compare_simspeed as ref_simspeed  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core import PAPER_GEOMETRY, figures, report  # noqa: E402
from repro_torch.core import sweep as psweep  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import (bench, check_regression,  # noqa: E402
                                kernel_micro, roofline, serving_scale,
                                sim_speed)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASELINES = ROOT / "benchmarks" / "baselines"
SIMSPEED = BASELINES / "simspeed_rounds64.json"
SERVING = BASELINES / "serving_rounds512.json"
SENSITIVITY = BASELINES / "sensitivity_rounds96.json"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(text: str) -> str:
    """The reference's backend names in ``text`` read as the port's."""
    for ref_name in ("lax_unfused", "lax", "pallas"):
        text = re.sub(rf"\b{ref_name}\b", report.REFERENCE_BACKENDS[ref_name],
                      text)
    return text


def port_report(rep: dict) -> dict:
    """A reference report as the port writes it: its backend names (the
    simspeed cells', the serving config's) translated."""
    return json.loads(to_port(json.dumps(rep)))


# ---------------------------------------------------------------------------
# the simspeed gate
# ---------------------------------------------------------------------------
def _simspeed(rps_lax=4500.0, rps_unfused=4200.0, execs=7, rounds=64):
    return {
        "kind": "simspeed", "schema": 1,
        "config": {"app": "cfd", "kernel": 0, "arch": "ata",
                   "rounds": rounds, "n_geoms": 13},
        "sweep": {"n_executables": 2 * execs},
        "cells": [
            {"backend": "lax", "rounds_per_sec": rps_lax, "wall_s": 1.0,
             "n_points": 13, "rounds": rounds, "n_executables": execs},
            {"backend": "lax_unfused", "rounds_per_sec": rps_unfused,
             "wall_s": 1.0, "n_points": 13, "rounds": rounds,
             "n_executables": execs},
        ],
        "headline": {"fused_speedup": rps_lax / rps_unfused},
    }


def _simspeed_case(how):
    if how == "identity":
        return _simspeed(), {}
    if how == "slower_host":
        return _simspeed(2250.0, 2100.0), {}
    if how == "faster_fused":
        return _simspeed(6000.0, 4200.0), {}
    if how == "within_band":
        return _simspeed(4000.0, 4200.0), {}
    if how == "lost_speedup":
        return _simspeed(2900.0, 4200.0), {}
    if how == "missing_backend":
        rep = _simspeed()
        rep["cells"] = rep["cells"][:1]
        del rep["headline"]["fused_speedup"]
        return rep, {}
    if how == "executable_growth":
        return _simspeed(execs=9), {}
    if how == "config_mismatch":
        return _simspeed(rounds=96), {}
    if how == "wrong_kind":
        return dict(_simspeed(), kind="sensitivity"), {}
    if how == "schema_downgrade":
        return dict(_simspeed(), schema=0), {}
    if how == "rps_opt_in":
        return _simspeed(2250.0, 2100.0), {"rps_rtol": 0.25}
    raise ValueError(how)


SIMSPEED_CASES = ("identity", "slower_host", "faster_fused", "within_band",
                  "lost_speedup", "missing_backend", "executable_growth",
                  "config_mismatch", "wrong_kind", "schema_downgrade",
                  "rps_opt_in")


@pytest.mark.parametrize("how", SIMSPEED_CASES)
def test_compare_simspeed_matches_the_reference(how):
    cand, kw = _simspeed_case(how)
    clean = how in ("identity", "slower_host", "faster_fused",
                    "within_band")
    for base in (_simspeed(), json.loads(SIMSPEED.read_text())):
        want = ref_simspeed(base, cand, **kw)
        got = report.compare_simspeed(base, port_report(cand), **kw)
        assert got == [to_port(f) for f in want], how
        assert (got == []) == clean, (how, got)


# ---------------------------------------------------------------------------
# the serving gate
# ---------------------------------------------------------------------------
def _serving_case(how):
    base = json.loads(SERVING.read_text())
    cand, kw = copy.deepcopy(base), {}
    if how == "probe_drift":
        cand["cells"][4]["probe_messages"] += 1
    elif how == "request_drift":
        cand["cells"][7]["requests"] -= 3
    elif how == "hit_drift":
        cand["cells"][2]["hit_rate"] *= 1.01
    elif how == "hit_within":
        cand["cells"][2]["hit_rate"] *= 1.004
    elif how == "missing_cell":
        del cand["cells"][5]
    elif how == "batched_abs_floor":
        cand["headline"]["batched_model_speedup"] = 1.4
    elif how == "batched_vs_baseline":
        cand["headline"]["batched_model_speedup"] = 2.5
    elif how == "batched_missing":
        del cand["headline"]["batched_model_speedup"]
    elif how == "latency_opt_in":
        cand["cells"][9]["p99_latency"] *= 1.5
        kw = {"latency_rtol": 0.10}
    elif how == "latency_off":
        cand["cells"][9]["p99_latency"] *= 1.5
    elif how == "wall_opt_in":
        cand["headline"]["batched_wall_speedup"] *= 0.5
        kw = {"wall_rtol": 0.10}
    elif how == "schema_downgrade":
        cand["schema"] = 1
    elif how == "wrong_kind":
        cand["kind"] = "simspeed"
    elif how == "config_mismatch":
        cand["config"]["shards"] = [8]
    elif how == "probe_backend_mismatch":
        cand["config"]["probe_backend"] = "pallas"
    elif how == "schema1_baseline":
        for c in base["cells"]:
            del c["slots"]
        base["cells"] = base["cells"][::2]
        base["schema"] = 1
    else:
        assert how == "identity"
    return base, cand, kw


SERVING_CASES = ("identity", "probe_drift", "request_drift", "hit_drift",
                 "hit_within", "missing_cell", "batched_abs_floor",
                 "batched_vs_baseline", "batched_missing",
                 "latency_opt_in", "latency_off", "wall_opt_in",
                 "schema_downgrade", "wrong_kind", "config_mismatch",
                 "probe_backend_mismatch", "schema1_baseline")


@pytest.mark.parametrize("how", SERVING_CASES)
def test_compare_serving_matches_the_reference(how):
    base, cand, kw = _serving_case(how)
    want = ref_serving(base, cand, **kw)
    got = report.compare_serving(base, port_report(cand), **kw)
    assert got == [to_port(f) for f in want], how
    clean = how in ("identity", "hit_within", "latency_off",
                    "schema1_baseline")
    assert (got == []) == clean, (how, got)


def test_serving_gate_keeps_the_probe_backend_in_the_config():
    """The baseline's ``lax`` reads as ``torch``: a report of the
    ``cuda`` probe is not comparable, as the reference's ``pallas`` one
    is not."""
    base = json.loads(SERVING.read_text())
    cand = port_report(base)
    cand["config"]["probe_backend"] = "cuda"
    fails = report.compare_serving(base, cand)
    assert len(fails) == 1 and "config mismatch" in fails[0]


# ---------------------------------------------------------------------------
# serving_scale against the reference's fig_serving_scale
# ---------------------------------------------------------------------------
def test_serving_scale_matches_the_reference_cell_for_cell(capsys):
    from benchmarks import fig_serving_scale
    from repro.core.trace.serving import ServingMix as RefMix
    from repro_torch.core.trace.serving import ServingMix
    kw = dict(rounds=64, shards=(4,), slot_counts=(1, 4), reps=1,
              policies=("private", "broadcast", "ata"))
    want = fig_serving_scale.run(
        mixes=(RefMix(("chat", "rag"), name="chat+rag"),), **kw)
    got = serving_scale.run(
        mixes=(ServingMix(("chat", "rag"), name="chat+rag"),),
        device="cpu", **kw)
    assert got["kind"] == want["kind"] == "serving"
    assert got["schema"] == want["schema"]
    assert got["config"] == port_report(want)["config"]
    assert got["config"]["probe_backend"] == "torch"
    assert len(got["cells"]) == len(want["cells"]) == 6
    wall = {"wall_s", "throughput_rps"}
    for g, w in zip(got["cells"], want["cells"]):
        assert set(g) == set(w)
        assert g["hist_exact"] is True
        for k in set(w) - wall:
            assert g[k] == w[k], (k, g[k], w[k])
    for k in ("probes_filtered", "batched_slots", "batched_model_speedup"):
        assert got["headline"][k] == want["headline"][k], k
    assert math.isclose(got["headline"]["ata_vs_private_hit_gain"],
                        want["headline"]["ata_vs_private_hit_gain"],
                        rel_tol=1e-12)
    assert set(got["headline"]) == set(want["headline"])
    assert report.compare_serving(port_report(want), got) == []
    printed = capsys.readouterr().out
    assert "serving_scale.s4.chat+rag.ata.b4.p99" in printed
    assert {"device_name", "torch_version", "phases_wall_s"} \
        <= set(got["manifest"])


def test_serving_engine_takes_only_the_fused_lowerings():
    from repro_torch.serving import SERVING_PROBE_BACKENDS
    assert SERVING_PROBE_BACKENDS == ("torch", "cuda")


# ---------------------------------------------------------------------------
# the probe routes of kernels.ops at kernel_micro's shapes
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def micro():
    return roofline.micro_inputs("cpu")


def _np(x):
    return {k: v.numpy() for k, v in x.items()}


@pytest.mark.parametrize("impl", ops.IMPLS)
def test_probe_routes_equal_the_reference_oracles(micro, impl):
    x = _np(micro)
    want = ref_ops.ata_probe(*(jnp.asarray(x[k]) for k in
                               ("set_idx", "qtag", "tags", "valid")),
                             impl="ref")
    got = ops.ata_probe(micro["set_idx"], micro["qtag"], micro["tags"],
                        micro["valid"], impl=impl)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    args = ("set_idx", "qtag", "core", "cbase", "deny", "tags", "valid",
            "dirty")
    want = ref_ops.ata_probe_rank(*(jnp.asarray(x[k]) for k in args),
                                  cluster_size=4, impl="ref")
    got = ops.ata_probe_rank(*(micro[k] for k in args), cluster_size=4,
                             impl=impl)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.shape == (1024,)
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(want[2].sum()) > 0 and int(want[0].sum()) > 0


def test_kernel_micro_runs_every_kernel_and_says_it_is_plain(capsys):
    out = kernel_micro.run("cpu")
    assert set(out) == set(roofline.KERNEL_NAMES)
    assert all(out[k]["maxerr"] == 0 for k in out)
    printed = capsys.readouterr().out
    for name in ("kernel.ata_tag_probe.kernel", "kernel.ata_probe_rank.ref",
                 "kernel.flash_attention.kernel", "kernel.wkv6.ref_scan",
                 "kernel.wkv6.kernel_scan"):
        assert name in printed
    assert printed.count("cpu:plain_version") == 4


def test_roofline_model_counts_the_kernels_traffic(micro):
    rows = roofline.kernel_table(device="cpu")
    assert [r[0] for r in rows] == list(roofline.KERNEL_NAMES)
    assert all(r[-1] is None for r in rows)        # the model alone here
    by = {r[0]: r for r in rows}
    R, C, S, W, G = (roofline.KERNEL_SHAPE[k] for k in "RCSWG")
    # every (cache, set) row is read once: all 16 x 8 rows are probed
    assert by["ata_tag_probe"][1] == R * 8 + C * S * W * 5 + R * C * 5
    hits, ways = ops.ata_probe(micro["set_idx"], micro["qtag"],
                               micro["tags"], micro["valid"], impl="ref")
    assert by["ata_tag_probe"][2] == int(torch.where(
        hits, ways + 1, W).sum())
    assert by["ata_probe_rank"][2] == R * G * W
    assert by["ata_probe_rank"][1] == (C * S * W * 6 + R * 17 + R * 18)
    B, Hq, Hkv, T, D = roofline.ATTN_SHAPE
    assert by["flash_attention"][2] == 4 * D * Hq * B * T * (T + 1) // 2
    assert by["flash_attention"][6] == "compute"


# ---------------------------------------------------------------------------
# sim_speed and the torch_unfused backend
# ---------------------------------------------------------------------------
SMALL = dataclasses.replace(PAPER_GEOMETRY, n_cores=8, cluster_size=4,
                            l1_sets=4, l1_ways=8)


def _ref_geom(geom):
    return dataclasses.replace(REF_GEOMETRY, **dataclasses.asdict(geom))


def _result_dict(r) -> dict:
    d = r._asdict()
    d["per_app"] = [a._asdict() for a in r.per_app]
    d["noc"] = r.noc._asdict()
    return d


def assert_close(got, want, where=""):
    """Integral fields exactly, other floats within rtol 1e-6."""
    def walk(gv, wv, path):
        if isinstance(wv, dict):
            assert list(gv) == list(wv), path
            for k in wv:
                walk(gv[k], wv[k], f"{path}.{k}")
        elif isinstance(wv, list):
            assert len(gv) == len(wv), path
            for i, (a, b) in enumerate(zip(gv, wv)):
                walk(a, b, f"{path}[{i}]")
        elif isinstance(wv, float) and math.isnan(wv):
            assert math.isnan(gv), path
        elif float(wv).is_integer():
            assert gv == wv, (path, gv, wv)
        else:
            assert math.isclose(gv, wv, rel_tol=1e-6, abs_tol=0.0), \
                (path, gv, wv)
    walk(_result_dict(got), _result_dict(want), where)


@pytest.fixture
def recorded_runs(monkeypatch):
    runs, orig = [], psweep.SweepGrid.run

    def run(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        runs.append((list(self.points), out))
        return out

    monkeypatch.setattr(psweep.SweepGrid, "run", run)
    return runs


def test_sim_speed_self_gates_and_equals_reference_simulate(tmp_path,
                                                            recorded_runs):
    path = tmp_path / "simspeed.json"
    rep = sim_speed.run(rounds=16, reps=1, geoms=[SMALL],
                        out_json=str(path), device="cpu")
    assert [c["backend"] for c in rep["cells"]] == ["torch", "torch_unfused"]
    assert all(c["rounds_per_sec"] > 0 and c["n_executables"] == 1
               for c in rep["cells"])
    assert rep["headline"]["fused_speedup"] > 0
    on_disk = report.load_report(str(path))
    assert report.compare_simspeed(on_disk, rep) == []
    assert check_regression.main([str(path), str(path)]) == 0
    assert len(recorded_runs) == 4              # warm + 1 timed, x 2
    ref_tr = ref_make_trace(dataclasses.replace(REF_APPS["cfd"], rounds=16),
                            n_cores=8, kernel=0)
    want = ref_simulate("ata", ref_tr, _ref_geom(SMALL))
    for points, run in recorded_runs:
        assert [p.probe_backend for p in points] in (["torch"],
                                                     ["torch_unfused"])
        assert_close(run.results[0], want, points[0].probe_backend)


def test_sim_speed_geometries_are_the_thirteen_of_the_knobs():
    geoms = sim_speed.unique_geometries()
    assert len(geoms) == 13 and len(set(geoms)) == 13
    from repro_torch.core.geometry import geom_structure
    assert len({geom_structure(g) for g in geoms}) == 7


# ---------------------------------------------------------------------------
# the geometry and NoC figures against reference per-point simulate()
# ---------------------------------------------------------------------------
FIG_ROUNDS = 64


def _ref_ratio(geom, noc="ideal", arch="ata"):
    tr = ref_make_trace(dataclasses.replace(REF_APPS["cfd"],
                                            rounds=FIG_ROUNDS), kernel=0)
    ipc = {a: RefAppResult("cfd", a, [ref_simulate(a, tr, _ref_geom(geom),
                                                   noc=noc)]).ipc
           for a in (arch, "private")}
    return ipc[arch] / ipc["private"]


def _rows(rows):
    return dict(rows)


def test_sweep_geometry_rows_match_reference_ratios():
    fig = figures.sweep_geometry_run(rounds=FIG_ROUNDS, device="cpu")
    rows = _rows(figures.sweep_geometry(fig))
    assert len(rows) == 21
    assert fig.report.n_executables == 15     # 7 + 7 structures, remote 1
    for knob, v in (("l1_ways", 32), ("hide", 5.0)):
        g = figures.knob_geometry(knob, v)
        want = _ref_ratio(g)
        got = (fig.cells[("ata", g, "ideal")].ipc
               / fig.cells[("private", g, "ideal")].ipc)
        assert math.isclose(got, want, rel_tol=1e-6), (knob, got, want)
        assert rows[f"fig_sweep.cfd.{knob}={v}.ata_vs_private"] \
            == f"{want:.3f}"
    assert "fig_sweep.cfd.noc_bw=8.0.remote_vs_private" in rows


def test_noc_topology_rows_match_reference_ratios():
    fig = figures.noc_topology_run(rounds=FIG_ROUNDS, device="cpu")
    rows = _rows(figures.noc_topology(fig))
    assert rows["fig_noc.executables"] == "3"
    assert len(rows) == 3 * 4 * 3 + 1
    for noc in ("ideal", "crossbar"):
        for v in (4.0, 32.0):
            g = figures.knob_geometry("noc_bw", v)
            want = _ref_ratio(g, noc)
            got = (fig.cells[("ata", g, noc)].ipc
                   / fig.cells[("private", g, noc)].ipc)
            assert math.isclose(got, want, rel_tol=1e-6), (noc, v)
            assert rows[f"fig_noc.cfd.{noc}.noc_bw={v:g}.ata_vs_private"] \
                == f"{want:.3f}"
    with pytest.raises(ValueError, match="needs 'private' and 'ata'"):
        figures.noc_topology_run(archs=("private", "remote"), rounds=8,
                                 device="cpu")


# ---------------------------------------------------------------------------
# the driver's failure collector and the regression CLI
# ---------------------------------------------------------------------------
def test_bench_collector_runs_every_figure_and_exits_1(monkeypatch, capsys):
    ran = []

    def stub(name, value=None):
        def fn(*args, **kwargs):
            ran.append(name)
            return value
        return fn

    def boom(*args, **kwargs):
        ran.append("sweep_geometry_run")
        raise RuntimeError("planted")

    suite = {}
    monkeypatch.setattr(bench.paper_repro, "run_paper_suite",
                        stub("suite", (suite, {})))
    for name in ("fig8", "fig9", "fig10", "table1", "noc_topology",
                 "mix_fairness"):
        monkeypatch.setattr(bench.figures, name, stub(name, []))
    monkeypatch.setattr(bench.figures, "sweep_geometry_run", boom)
    monkeypatch.setattr(bench.figures, "noc_topology_run", stub("noc_run"))
    monkeypatch.setattr(bench.sensitivity_report, "mix_grid_run",
                        stub("mix_grid", object()))
    monkeypatch.setattr(bench.kernel_micro, "run", stub("kernel_micro"))
    monkeypatch.setattr(bench.serving_ata, "run", stub("serving_ata"))
    monkeypatch.setattr(bench.roofline, "kernel_table",
                        stub("roofline", []))
    assert bench.main(["--device", "cpu"]) == 1
    assert ran == ["suite", "fig8", "fig9", "fig10", "table1",
                   "sweep_geometry_run", "noc_run", "noc_topology",
                   "mix_grid", "mix_fairness", "kernel_micro",
                   "serving_ata", "roofline"]
    captured = capsys.readouterr()
    assert "figure.fig_sweep_geometry.wall_s" in captured.out
    assert "FAILED" in captured.out
    assert "1 figure(s) failed: fig_sweep_geometry" in captured.err
    assert "RuntimeError: planted" in captured.err


def test_check_regression_exit_codes(tmp_path):
    def write(name, rep):
        path = tmp_path / name
        path.write_text(json.dumps(rep))
        return str(path)

    serving = json.loads(SERVING.read_text())
    good = write("serving.json", port_report(serving))
    bad_rep = port_report(serving)
    bad_rep["cells"][0]["probe_messages"] += 1
    bad = write("serving_bad.json", bad_rep)
    assert check_regression.main([str(SERVING), good]) == 0
    assert check_regression.main([str(SERVING), bad]) == 1
    simspeed = json.loads(SIMSPEED.read_text())
    good = write("simspeed.json", port_report(simspeed))
    slow = port_report(simspeed)
    slow["headline"]["fused_speedup"] = 0.5
    assert check_regression.main([str(SIMSPEED), good]) == 0
    assert check_regression.main([str(SIMSPEED),
                                  write("simspeed_bad.json", slow)]) == 1
    # the default tolerances are the reference script's
    assert check_regression.main([str(SIMSPEED), good,
                                  "--rps-rtol", "0.0"]) == 0
    sens = json.loads(SENSITIVITY.read_text())
    assert check_regression.main([str(SENSITIVITY),
                                  write("sens.json", sens)]) == 0
    sens["cells"][0]["ipc"] *= 1.2
    assert check_regression.main([str(SENSITIVITY),
                                  write("sens_bad.json", sens)]) == 1


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------
def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_port_and_chip_smoke_import_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 50
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "benchmarks"), \
                (os.path.relpath(path, ROOT), name)
