"""Port parity: the last two scripts, ``launch/bench_trend.py`` and
``launch/calibrate.py``.

``bench_trend`` against the reference's ``scripts/bench_trend.py`` on
the same histories (the cases of ``tests/test_trend.py``: solo, mix and
NoC series, drift flags, the simspeed, serving and telemetry kinds, the
CLI with ``--strict``, one report, an empty and a missing directory):
the series, trend rows, CSV and markdown equal the reference's once the
reference's probe backend names are read as the port's (``lax`` ->
``torch``, ``lax_unfused`` -> ``torch_unfused``, ``pallas`` -> ``cuda``).
A history that mixes the committed baselines with port-named reports
keeps one series per backend.

``calibrate`` on a small CPU suite against the reference script's
formulas (its ``normalized_ipc`` and ``geomean`` over the same results)
and against ``core/figures``' Fig. 8 and Fig. 10 rows.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import metrics as ref_metrics  # noqa: E402
from repro.core import trace as ref_trace  # noqa: E402
from repro_torch.core import figures, run_suite  # noqa: E402
from repro_torch.launch import bench_trend, calibrate  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SCRIPT = os.path.join(ROOT, "scripts", "bench_trend.py")
BASELINES = os.path.join(ROOT, "benchmarks", "baselines")
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import bench_trend as ref_trend  # noqa: E402

NAMES = {"lax": "torch", "lax_unfused": "torch_unfused", "pallas": "cuda",
         "lax/lax_unfused": "torch/torch_unfused"}


def _port_key(key):
    return tuple(NAMES.get(k, k) if isinstance(k, str) else k for k in key)


def _port_text(text):
    for old in ("lax/lax_unfused", "lax_unfused", "lax"):
        text = text.replace(f"simspeed,{old},", f"simspeed,{NAMES[old]},")
        text = text.replace(f"| simspeed | {old} |",
                            f"| simspeed | {NAMES[old]} |")
    return text


def _report(ipc, ws=2.0, noc_ipc=10.0):
    return {
        "schema": 3,
        "config": {}, "sweep": {"n_executables": 2},
        "cells": [{"arch": "ata", "knob": "noc_bw", "value": 16.0,
                   "ipc": ipc, "l1_hit_rate": 0.5}],
        "mix": {"cells": [{"mix": "cfd+HS3D", "arch": "ata",
                           "weighted_speedup": ws}]},
        "noc": {"cells": [{"arch": "ata", "noc": "crossbar",
                           "noc_bw": 8.0, "ipc": noc_ipc}]},
    }


def _simspeed(rps_a, rps_b, names=("lax", "lax_unfused")):
    return {"kind": "simspeed", "schema": 1,
            "config": {"app": "cfd", "kernel": 0, "arch": "ata",
                       "rounds": 64, "n_geoms": 13},
            "sweep": {"n_executables": 14},
            "cells": [{"backend": names[0], "rounds_per_sec": rps_a,
                       "wall_s": 1.0, "n_points": 13, "rounds": 64,
                       "n_executables": 7},
                      {"backend": names[1], "rounds_per_sec": rps_b,
                       "wall_s": 1.0, "n_points": 13, "rounds": 64,
                       "n_executables": 7}],
            "headline": {"fused_speedup": rps_a / rps_b}}


def _serving(hit, p99, rps, slots=None, headline=None):
    cell = {"shards": 8, "mix": "chat+rag", "policy": "ata",
            "requests": 4000, "hit_rate": hit, "probe_messages": 0,
            "p99_latency": p99, "throughput_rps": rps}
    if slots is not None:
        cell["slots"] = slots
    return {"kind": "serving", "schema": 1 if slots is None else 2,
            "config": {"shards": [8], "rounds": 512}, "cells": [cell],
            "headline": dict({"probes_filtered": 1000}, **(headline or {}))}


def _telemetry(hit=0.36, p50=288.0, p99=720.0):
    return {"kind": "telemetry", "schema": 1,
            "config": {"window": 32, "rounds": None},
            "sim": {"arch": "ata", "noc": "crossbar", "app": "cfd",
                    "l1_hit_rate": 0.28, "l1_latency": 33.0,
                    "p99_latency_bucket": 64.0},
            "serving": {"policy": "ata", "mix": "chat+rag", "shards": 8,
                        "hit_rate": hit, "hist_exact": True,
                        "p50_latency": p50, "p99_latency": p99}}


HISTORIES = {
    "sensitivity": [("2026-07-27.json", _report(20.0)),
                    ("2026-07-28.json", _report(20.2)),
                    ("2026-07-29.json", _report(21.0, ws=2.5, noc_ipc=10.1))],
    "simspeed": [("2026-08-01.json", _report(20.0)),
                 ("2026-08-02_simspeed.json", _simspeed(4400.0, 4000.0)),
                 ("2026-08-03_simspeed.json", _simspeed(4600.0, 4100.0))],
    "serving": [("2026-08-08_serving.json", _serving(0.41, 720.0, 50e3)),
                ("2026-08-09_serving.json", _serving(
                    0.41, 726.0, 61e3, slots=1,
                    headline={"batched_slots": 4,
                              "batched_model_speedup": 3.4,
                              "batched_wall_speedup": 0.9})),
                ("2026-08-09.json", _report(20.0))],
    "telemetry": [("2026-08-08.json", _report(20.0)),
                  ("2026-08-08_telemetry.json", _telemetry()),
                  ("2026-08-09_telemetry.json", _telemetry(p99=726.0))],
}


def _write(d, reports):
    d.mkdir()
    for name, rep in reports:
        (d / name).write_text(json.dumps(rep))
    (d / "junk.json").write_text("{not json")          # tolerated
    (d / "notes.txt").write_text("ignored")
    return str(d)


@pytest.mark.parametrize("kind", sorted(HISTORIES))
def test_series_rows_csv_and_markdown_equal_the_reference(kind, tmp_path):
    d = _write(tmp_path / "h", HISTORIES[kind])
    reports = bench_trend.load_history(d)
    ref_reports = ref_trend.load_history(d)
    assert [n for n, _ in reports] == [n for n, _ in ref_reports]
    series = bench_trend._cell_series(reports)
    ref_series = ref_trend._cell_series(ref_reports)
    assert series == {_port_key(k): v for k, v in ref_series.items()}
    for rtol in (0.05, 0.01, 0.5):
        rows = bench_trend.trend_rows(series, rtol)
        ref_rows = ref_trend.trend_rows(ref_series, rtol)
        assert sorted(((_port_key(r["key"]), r["flagged"], r["drift"])
                       for r in ref_rows), key=str) == sorted(
            ((r["key"], r["flagged"], r["drift"]) for r in rows), key=str)
        assert sorted(bench_trend.to_markdown(rows, rtol, 3).splitlines()) \
            == sorted(_port_text(ref_trend.to_markdown(
                ref_rows, rtol, 3)).splitlines())
    assert sorted(bench_trend.to_csv(series).splitlines()) \
        == sorted(_port_text(ref_trend.to_csv(ref_series)).splitlines())


def _run_port(argv, capsys):
    rc = bench_trend.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("case", ["drift", "strict", "one", "empty",
                                  "missing", "simspeed"])
def test_cli_equals_the_reference_script(case, tmp_path, capsys):
    if case in ("drift", "strict"):
        d = _write(tmp_path / "h", HISTORIES["sensitivity"])
    elif case == "simspeed":
        d = _write(tmp_path / "h", HISTORIES["simspeed"])
    elif case == "one":
        d = _write(tmp_path / "h", [("a.json", _report(20.0))])
    elif case == "empty":
        (tmp_path / "h").mkdir()
        d = str(tmp_path / "h")
    else:
        d = str(tmp_path / "never_made")
    outs = {}
    for who in ("ref", "port"):
        md, csv = tmp_path / f"{who}.md", tmp_path / f"{who}.csv"
        argv = [d, "--markdown", str(md), "--rtol", "0.05"]
        if case != "strict":
            argv += ["--csv", str(csv)]
        if case in ("strict", "one"):
            argv.append("--strict")
        if who == "ref":
            r = subprocess.run([sys.executable, SCRIPT] + argv,
                               capture_output=True, text=True)
            rc, out, err = r.returncode, r.stdout, r.stderr
        else:
            rc, out, err = _run_port(argv, capsys)
        outs[who] = (rc, out, err.splitlines()[-1],
                     md.read_text() if md.exists() else None,
                     csv.read_text() if csv.exists() else None)
    ref = outs["ref"]
    want = (ref[0], _port_text(ref[1]), ref[2],
            None if ref[3] is None else sorted(_port_text(ref[3])
                                               .splitlines()),
            None if ref[4] is None else sorted(_port_text(ref[4])
                                               .splitlines()))
    port = outs["port"]
    got = (port[0], port[1], port[2],
           None if port[3] is None else sorted(port[3].splitlines()),
           None if port[4] is None else sorted(port[4].splitlines()))
    assert got == want
    assert got[0] == (1 if case == "strict" else 0)


def test_baselines_and_port_reports_share_one_series_per_backend(tmp_path):
    """The committed baselines (reference names) and port-named reports in
    one history: each backend is one series, under the port's name."""
    d = tmp_path / "h"
    d.mkdir()
    for name in ("sensitivity_rounds96", "simspeed_rounds64",
                 "serving_rounds512"):
        shutil.copy(os.path.join(BASELINES, name + ".json"),
                    d / f"2026-01-01_{name}.json")
    (d / "2026-02-01_simspeed.json").write_text(json.dumps(_simspeed(
        300.0, 260.0, names=("torch", "torch_unfused"))))
    (d / "2026-02-01_zserving.json").write_text(json.dumps(json.load(open(
        os.path.join(BASELINES, "serving_rounds512.json")))))
    reports = bench_trend.load_history(str(d))
    assert len(reports) == 5                # the smoke trace is not here
    series = bench_trend._cell_series(reports)
    backends = {k[1] for k in series if k[0] == "simspeed"}
    assert backends == {"torch", "torch_unfused", "torch/torch_unfused"}
    assert len(series[("simspeed", "torch", "rounds_per_sec")]) == 2
    assert len(series[("simspeed", "torch/torch_unfused",
                       "fused_speedup")]) == 2
    assert all(len(v) == 2 for k, v in series.items() if k[0] == "serving")
    assert any(k[0] == "solo" for k in series)


# ---------------------------------------------------------------------------
# calibrate
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small_suite():
    return run_suite(kernels_per_app=1, rounds=32, device="cpu")


def test_calibrate_matches_the_reference_formulas(small_suite):
    """The reference script's lines over the same results (its own
    ``normalized_ipc`` and ``geomean`` read the port's ``AppResult``s),
    equal to the last bit."""
    suite = small_suite
    ipc = ref_metrics.normalized_ipc(suite)
    gm = ref_metrics.geomean
    hi_ata = gm([ipc[a]["ata"] for a in ref_trace.HIGH_LOCALITY])
    lo_ata = gm([ipc[a]["ata"] for a in ref_trace.LOW_LOCALITY])
    lo_dec = gm([ipc[a]["decoupled"] for a in ref_trace.LOW_LOCALITY])
    lat = {arch: [suite[a][arch].l1_latency / suite[a]["private"].l1_latency
                  for a in ref_trace.APPS] for arch in ("ata", "decoupled")}
    want = {"ata_gain_high": hi_ata - 1, "ata_gain_low": lo_ata - 1,
            "ata_vs_decoupled_low": lo_ata / lo_dec - 1,
            "lat_decoupled": np.mean(lat["decoupled"]) - 1,
            "lat_decoupled_max": max(lat["decoupled"]),
            "lat_ata": np.mean(lat["ata"]) - 1}
    assert calibrate.summary(suite) == pytest.approx(want, rel=0, abs=0)
    lines = calibrate.table(suite)
    assert len(lines) == 1 + 10 + 1 + 4
    assert lines[-4] == (f"ATA hi-loc IPC gain : {100 * (hi_ata - 1):+6.1f}%"
                         "   (paper +12.0%)")
    assert lines[-1].startswith(
        f"L1 lat: dec {100 * (np.mean(lat['decoupled']) - 1):+6.1f}% "
        f"(paper +67.2%, max {max(lat['decoupled']):.2f}x vs 2.74x)")


def test_calibrate_agrees_with_figures(small_suite):
    s = calibrate.summary(small_suite)
    rows = dict(figures.fig8(small_suite) + figures.fig10(small_suite))
    assert rows["fig8.ata_gain_high_locality_pct"] \
        == f"{100 * s['ata_gain_high']:.1f}"
    assert rows["fig8.ata_gain_low_locality_pct"] \
        == f"{100 * s['ata_gain_low']:.1f}"
    assert rows["fig10.decoupled_latency_increase_pct"] \
        == f"{100 * s['lat_decoupled']:.1f}"
    assert rows["fig10.ata_latency_increase_pct"] \
        == f"{100 * s['lat_ata']:.1f}"
