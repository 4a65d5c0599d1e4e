"""Benchmark suite: the paper's figures and tables, the grid figures,
kernels, serving and the kernel roofline (the port of the reference's
driver ``benchmarks/run.py``). Prints ``name,us_per_call,derived`` CSV.

  PYTHONPATH=src python -m repro_torch.launch.bench [--full] [--rounds N] \\
      [--report-json PATH] [--serving-json PATH] [--serving-rounds N] \\
      [--telemetry OUT_DIR] [--device cuda|cpu]

In order: Figs. 8-10 and Table I from one ``run_suite`` of the paper's
four architectures (``launch/paper_repro.run_paper_suite``; Fig. 9 reads
3 kernels per app, the others the first, unless ``--full`` runs them
all); the geometry and NoC-topology figures
(``figures.sweep_geometry``/``noc_topology``, one grid run each); the
multi-tenant mix grid and its fairness rows; with ``--report-json`` the
sensitivity report on the same mix grid (``launch/sensitivity``);
``kernel_micro``; ``serving_ata``; with ``--serving-json`` the serving
scale grid (``launch/serving_scale``; ``--serving-rounds`` fixes its
rounds, 512 to match the committed baseline); with ``--telemetry`` the
observability capture (``launch/telemetry_capture``); and last the
kernel roofline (``launch/roofline``, device times on the card). Figure
rows carry 0.0 in ``us_per_call``: each figure's wall is its
``figure.<name>.wall_s`` line.

Every figure runs under a failure collector: one that raises prints its
traceback, the others still run, and the process exits 1 at the end
naming every figure that failed.

Runs on the card; ``--device cpu`` runs without one (the kernel rows are
then the plain versions and the roofline is the model alone).
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback
from typing import List, Optional

from repro_torch.core import figures
from repro_torch.core import report as sensitivity_report
from repro_torch.core.arch import PAPER_ARCHITECTURES
from repro_torch.core.metrics import AppResult
from repro_torch.core.simulator import resolve_device
from repro_torch.core.sweep import compile_count
from repro_torch.launch import (kernel_micro, paper_repro, roofline,
                                sensitivity, serving_ata, serving_scale,
                                telemetry_capture)
from repro_torch.launch.common import emit


def _figure(failures: List[str], name: str, fn, *args, **kwargs):
    """Run one figure: time it, survive it, account for it.

    A raising figure prints its traceback to stderr and is appended to
    ``failures``; returns the figure's value, or None on failure."""
    t0 = time.perf_counter()
    try:
        out = fn(*args, **kwargs)
    except Exception:                       # noqa: BLE001
        wall = time.perf_counter() - t0
        print(f"FIGURE FAILED: {name} after {wall:.2f}s", file=sys.stderr)
        traceback.print_exc()
        failures.append(name)
        emit(f"figure.{name}.wall_s", wall * 1e6, "FAILED")
        return None
    wall = time.perf_counter() - t0
    emit(f"figure.{name}.wall_s", wall * 1e6, f"{wall:.2f}")
    return out


def _print_rows(rows) -> None:
    for name, derived in rows:
        emit(name, 0.0, derived)


def _first_kernels(suite, k):
    """``suite`` cut to each app's first ``k`` kernels (all for k=0)."""
    if not k:
        return suite
    return {app: {arch: AppResult(r.app, r.arch, r.per_kernel[:k])
                  for arch, r in cells.items()}
            for app, cells in suite.items()}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="every kernel of every app (Fig. 9 fidelity)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="truncate every trace to N rounds")
    ap.add_argument("--report-json", default=None, metavar="PATH",
                    help="write the policy-zoo sensitivity report "
                    "(JSON + sibling .md) to PATH")
    ap.add_argument("--serving-json", default=None, metavar="PATH",
                    help="run the serving-engine scale grid and write "
                    "its kind=serving report to PATH")
    ap.add_argument("--serving-rounds", type=int, default=None,
                    help="fixed rounds per serving stream (the baseline:"
                    " 512); default calibrates to >= 1M requests")
    ap.add_argument("--telemetry", default=None, metavar="OUT_DIR",
                    help="run the observability capture and write "
                    "timelines/traces/manifest into OUT_DIR")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    failures: List[str] = []
    k = 0 if args.full else 1
    k9 = 0 if args.full else 3
    rounds = args.rounds

    print("name,us_per_call,derived")
    t0 = time.perf_counter()
    ran = _figure(failures, "run_suite", paper_repro.run_paper_suite,
                  PAPER_ARCHITECTURES, k9 or None, rounds, device)
    if ran is not None:
        suite = ran[0]
        head = _first_kernels(suite, k)
        for name, fn, s in (("fig8_ipc", figures.fig8, head),
                            ("fig9_kernels", figures.fig9, suite),
                            ("fig10_latency", figures.fig10, head),
                            ("table1_landscape", figures.table1, head)):
            _figure(failures, name, lambda fn=fn, s=s: _print_rows(fn(s)))
    _figure(failures, "fig_sweep_geometry", lambda: _print_rows(
        figures.sweep_geometry(figures.sweep_geometry_run(
            kernels_per_app=k, rounds=rounds, device=device))))
    _figure(failures, "fig_noc_topology", lambda: _print_rows(
        figures.noc_topology(figures.noc_topology_run(
            kernels_per_app=k, rounds=rounds, device=device))))
    # one fairness grid run serves both the figure and the report's mix
    # section: the mixes are never simulated twice
    t_mix = time.perf_counter()
    mix_run = _figure(failures, "mix_grid", sensitivity_report.mix_grid_run,
                      rounds=rounds, device=device)
    mix_s = time.perf_counter() - t_mix
    if mix_run is not None:
        _figure(failures, "fig_mix_fairness",
                lambda: _print_rows(figures.mix_fairness(mix_run)))
    wall = time.perf_counter() - t0
    emit("sweep.figures_total_s", wall * 1e6, f"{wall:.2f}")
    emit("sweep.executables_compiled", 0.0, compile_count())
    emit("sweep.devices", 0.0, 1)

    if args.report_json:
        def _sensitivity():
            t1 = time.perf_counter()
            rep, md_path = sensitivity.build_report(
                args.report_json, rounds=rounds, mix_run=mix_run,
                kernels_per_app=None if args.full else 1, device=device,
                mix_s=mix_s)
            emit("sensitivity.cells", (time.perf_counter() - t1) * 1e6,
                 len(rep["cells"]))
            emit("sensitivity.executables", 0.0,
                 rep["sweep"]["n_executables"])
            for sec in ("mix", "noc"):
                emit(f"sensitivity.{sec}_cells", 0.0,
                     len(rep[sec]["cells"]))
                emit(f"sensitivity.{sec}_executables", 0.0,
                     rep[sec]["sweep"]["n_executables"])
            print(f"sensitivity report: {args.report_json} + {md_path}",
                  file=sys.stderr)
        _figure(failures, "sensitivity_report", _sensitivity)

    _figure(failures, "kernel_micro", kernel_micro.run, device)
    _figure(failures, "serving_ata", serving_ata.run)

    if args.serving_json:
        def _serving_scale():
            t1 = time.perf_counter()
            srep = serving_scale.run(rounds=args.serving_rounds,
                                     out_json=args.serving_json,
                                     device=device)
            emit("serving.cells", (time.perf_counter() - t1) * 1e6,
                 len(srep["cells"]))
            emit("serving.requests_total", 0.0,
                 sum(c["requests"] for c in srep["cells"]))
            print(f"serving report: {args.serving_json}", file=sys.stderr)
        _figure(failures, "serving_scale", _serving_scale)

    if args.telemetry:
        def _telemetry():
            rep = telemetry_capture.capture(args.telemetry, rounds=rounds,
                                            device=device)
            emit("telemetry.sim_windows", 0.0, rep["sim"]["n_windows"])
            emit("telemetry.serving_p99", 0.0,
                 f"{rep['serving']['p99_latency']:.1f}cyc")
            print(f"telemetry capture: {args.telemetry}", file=sys.stderr)
        _figure(failures, "telemetry_capture", _telemetry)

    def _roofline():
        for name, _, _, ai, mem_s, comp_s, bound, meas in \
                roofline.kernel_table(device=device):
            emit(f"roofline.kernel.{name}",
                 meas if meas is not None else 0.0,
                 f"{bound};ai={ai:.1f};mem={mem_s * 1e6:.2f}us;"
                 f"comp={comp_s * 1e6:.2f}us")
    _figure(failures, "roofline", _roofline)

    if failures:
        print(f"{len(failures)} figure(s) failed: {', '.join(failures)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
