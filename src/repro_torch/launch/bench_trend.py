"""Benchmark trend tracking: drift across a history of reports.

The port of the reference's ``scripts/bench_trend.py`` (JSON only). It
reads a directory of report JSONs (one per run: the sensitivity report
of ``launch/sensitivity.py``, the ``kind="simspeed"`` report of
``launch/sim_speed.py``, the ``kind="serving"`` report of
``launch/serving_scale.py``, the ``kind="telemetry"`` capture of
``launch/telemetry_capture.py``) and

  * prints a per-cell time series as CSV (``--csv PATH`` or stdout):
    solo, mix and NoC IPC cells, per-backend rounds/sec and the fused
    speedup, serving hit rate / p99 / throughput per (shards x mix x
    policy x slots) cell and the batched headlines, telemetry quantiles
    and hit rates;
  * writes a markdown trend summary (``--markdown PATH``): latest value,
    trailing median, and relative drift per cell;
  * flags cells whose *latest* value drifts beyond ``--rtol`` from the
    trailing median of the earlier runs.

A report names its probe backends as the package that wrote it did: the
reference's ``lax``, ``lax_unfused`` and ``pallas``, the port's
``torch``, ``torch_unfused`` and ``cuda``. They are read through
``core.report.REFERENCE_BACKENDS``, so a history that mixes the
committed baselines (``benchmarks/baselines/``) with the port's reports
keeps one series per backend, under the port's names (the fused speedup
is ``torch/torch_unfused``).

Exit code is 0 unless ``--strict`` is passed and drift was flagged.
Reports are ordered by filename (ISO dates sort correctly); at least two
are needed for drift, one still produces the tables. A missing or empty
history directory produces a "no history yet" markdown and exit 0.

    PYTHONPATH=src python -m repro_torch.launch.bench_trend bench_history \
        [--markdown TREND.md] [--csv trend.csv] [--rtol 0.05] [--strict]
"""
import argparse
import json
import os
import statistics
import sys
from typing import Dict, List, Tuple

from repro_torch.core.report import REFERENCE_BACKENDS, _port_names

#: the fused-speedup series: the fused probe backend over the unfused one
FUSED_SERIES = (f"{REFERENCE_BACKENDS['lax']}/"
                f"{REFERENCE_BACKENDS['lax_unfused']}")


def _cell_series(reports: List[Tuple[str, dict]]
                 ) -> Dict[tuple, List[Tuple[str, float]]]:
    """{(section, *cell key, metric): [(run name, value), ...]}."""
    series: Dict[tuple, List[Tuple[str, float]]] = {}

    def add(run, section, key, metric, value):
        series.setdefault((section,) + key + (metric,), []) \
            .append((run, float(value)))

    for run, rep in reports:
        rep = _port_names(rep)
        if rep.get("kind") == "simspeed":
            # throughput reports: per-backend rounds/sec (absolute —
            # informative across comparable runners) + the
            # machine-portable fused speedup ratio
            for c in rep.get("cells", ()):
                add(run, "simspeed", (c["backend"],), "rounds_per_sec",
                    c["rounds_per_sec"])
            ratio = rep.get("headline", {}).get("fused_speedup")
            if ratio is not None:
                add(run, "simspeed", (FUSED_SERIES,),
                    "fused_speedup", ratio)
            continue
        if rep.get("kind") == "telemetry":
            # observability smoke captures: histogram-derived latency
            # quantiles (serving p99 is an *exact* quantile read; the
            # sim one is a log2-bucket upper edge) + hit rates, so the
            # latency story trends alongside the throughput one
            sim = rep.get("sim", {})
            for metric in ("l1_hit_rate", "p99_latency_bucket"):
                if sim.get(metric) is not None:
                    add(run, "telemetry",
                        (sim.get("arch"), sim.get("noc")), metric,
                        sim[metric])
            srv = rep.get("serving", {})
            for metric in ("hit_rate", "p50_latency", "p99_latency"):
                if srv.get(metric) is not None:
                    add(run, "telemetry",
                        (srv.get("policy"), srv.get("mix"),
                         srv.get("shards")), metric, srv[metric])
            continue
        if rep.get("kind") == "serving":
            # serving-engine reports: deterministic quality metrics
            # (hit rate, modeled p99) + host-dependent replay
            # throughput, per (shards x mix x policy x slots) cell
            # (pre-batching reports carry no "slots" key: B=1), plus
            # the machine-portable batched req/s-ratio headline
            for c in rep.get("cells", ()):
                key = (c["shards"], c["mix"], c["policy"],
                       c.get("slots", 1))
                add(run, "serving", key, "hit_rate", c["hit_rate"])
                add(run, "serving", key, "p99_latency",
                    c["p99_latency"])
                add(run, "serving", key, "throughput_rps",
                    c["throughput_rps"])
            head = rep.get("headline", {})
            b = head.get("batched_slots")
            for metric in ("batched_model_speedup",
                           "batched_wall_speedup"):
                if head.get(metric) is not None:
                    add(run, "serving", (f"B{b}/B1",), metric,
                        head[metric])
            continue
        for c in rep.get("cells", ()):
            add(run, "solo", (c["arch"], c["knob"], c["value"]), "ipc",
                c["ipc"])
        for c in rep.get("mix", {}).get("cells", ()):
            add(run, "mix", (c["mix"], c["arch"]), "weighted_speedup",
                c["weighted_speedup"])
        for c in rep.get("noc", {}).get("cells", ()):
            add(run, "noc", (c["arch"], c["noc"], c["noc_bw"]), "ipc",
                c["ipc"])
    return series


def load_history(directory: str) -> List[Tuple[str, dict]]:
    """Parse every report JSON under ``directory``, oldest first.

    A missing or not-yet-a-directory history (the first nightly run on
    a fresh cache) is an empty history, not a crash.
    """
    try:
        names = sorted(n for n in os.listdir(directory)
                       if n.endswith(".json"))
    except (FileNotFoundError, NotADirectoryError):
        print(f"no history directory at {directory}", file=sys.stderr)
        return []
    out = []
    for name in names:
        path = os.path.join(directory, name)
        try:
            with open(path) as f:
                rep = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"skipping unreadable report {path}: {e}",
                  file=sys.stderr)
            continue
        if "cells" not in rep and rep.get("kind") != "telemetry":
            print(f"skipping non-report JSON {path}", file=sys.stderr)
            continue
        out.append((os.path.splitext(name)[0], rep))
    return out


def trend_rows(series: Dict[tuple, List[Tuple[str, float]]],
               rtol: float) -> List[dict]:
    """One row per cell: latest, trailing median, drift, flagged."""
    rows = []
    for key in sorted(series, key=str):
        points = series[key]
        latest_run, latest = points[-1]
        earlier = [v for _, v in points[:-1]]
        if earlier:
            med = statistics.median(earlier)
            if med:
                drift = (latest - med) / abs(med)
            else:
                # zero median: no drift if still zero, else unbounded
                drift = 0.0 if latest == 0 else float("inf")
            flagged = abs(drift) > rtol
        else:
            med, drift, flagged = latest, 0.0, False
        rows.append({
            "key": key, "runs": len(points), "latest_run": latest_run,
            "latest": latest, "median": med, "drift": drift,
            "flagged": flagged,
        })
    return rows


def to_csv(series: Dict[tuple, List[Tuple[str, float]]]) -> str:
    lines = ["section,cell,metric,run,value"]
    for key in sorted(series, key=str):
        section, *cell, metric = key
        label = "/".join(str(c) for c in cell)
        for run, value in series[key]:
            lines.append(f"{section},{label},{metric},{run},{value!r}")
    return "\n".join(lines) + "\n"


def to_markdown(rows: List[dict], rtol: float, n_runs: int) -> str:
    flagged = [r for r in rows if r["flagged"]]
    lines = [
        "# Benchmark trend report",
        "",
        f"{n_runs} run(s), {len(rows)} tracked cells, drift tolerance "
        f"±{rtol:.0%} vs the trailing median.",
        "",
        (f"**{len(flagged)} cell(s) drifted beyond tolerance.**"
         if flagged else "No cell drifted beyond tolerance."),
        "",
        "| section | cell | metric | runs | median | latest | drift |",
        "|---|---|---|---|---|---|---|",
    ]
    # flagged rows first, then the rest, so regressions lead the table
    for r in flagged + [r for r in rows if not r["flagged"]]:
        section, *cell, metric = r["key"]
        label = "/".join(str(c) for c in cell)
        mark = " ⚠" if r["flagged"] else ""
        lines.append(
            f"| {section} | {label} | {metric} | {r['runs']} "
            f"| {r['median']:.3f} | {r['latest']:.3f} "
            f"| {r['drift']:+.1%}{mark} |")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("history", help="directory of dated report JSONs")
    ap.add_argument("--rtol", type=float, default=0.05,
                    help="flag |latest - median|/median beyond this "
                    "(default 5%%)")
    ap.add_argument("--markdown", metavar="PATH",
                    help="write the markdown trend summary here")
    ap.add_argument("--csv", metavar="PATH",
                    help="write the full time-series CSV here "
                    "(default: stdout)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 when any cell is flagged")
    args = ap.parse_args(argv)

    reports = load_history(args.history)
    if not reports:
        # first nightly on a fresh cache: emit valid (empty) outputs
        # and succeed — "no history yet" is a state, not a failure
        print(f"no reports found under {args.history}", file=sys.stderr)
        if args.markdown:
            with open(args.markdown, "w") as f:
                f.write("# Benchmark trend report\n\n"
                        "No history yet — this is the first tracked "
                        "run; trends appear once a report lands in "
                        f"`{args.history}`.\n")
        empty_csv = "section,cell,metric,run,value\n"
        if args.csv:
            with open(args.csv, "w") as f:
                f.write(empty_csv)
        else:
            sys.stdout.write(empty_csv)
        return 0
    series = _cell_series(reports)
    rows = trend_rows(series, args.rtol)

    csv = to_csv(series)
    if args.csv:
        with open(args.csv, "w") as f:
            f.write(csv)
    else:
        sys.stdout.write(csv)
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(to_markdown(rows, args.rtol, len(reports)))

    flagged = [r for r in rows if r["flagged"]]
    for r in flagged:
        section, *cell, metric = r["key"]
        print(f"drift ⚠ {section} {'/'.join(map(str, cell))} {metric}: "
              f"median {r['median']:.3f} -> latest {r['latest']:.3f} "
              f"({r['drift']:+.1%})", file=sys.stderr)
    print(f"trend: {len(reports)} runs, {len(rows)} cells, "
          f"{len(flagged)} flagged (rtol {args.rtol:.0%})",
          file=sys.stderr)
    return 1 if (flagged and args.strict) else 0


if __name__ == "__main__":
    sys.exit(main())
