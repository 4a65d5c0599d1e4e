"""Write the sensitivity report and gate it against a baseline (the port
of ``benchmarks/run.py --report-json`` and the sensitivity kind of
``scripts/check_bench_regression.py``).

Runs the fairness grid once (``report.mix_grid_run``), prints its rows
(``figures.mix_fairness``), builds the schema-3 report (solo, mix and
NoC sections) on the same grid run, with its run ``manifest`` (the
card, its power limit, the kernel builds and the phases' wall times),
writes it as JSON with its markdown table beside it, and, with
``--check``, exits non-zero on any ``compare_reports`` failure against
the baseline.

Usage (on the CUDA card; ``--device cpu`` runs without one):
  PYTHONPATH=src python -m repro_torch.launch.sensitivity --rounds 96 \\
      --report-json sensitivity.json \\
      --check benchmarks/baselines/sensitivity_rounds96.json
  PYTHONPATH=src python -m repro_torch.launch.sensitivity --device cpu \\
      --rounds 96 --report-json /tmp/s.json \\
      --check benchmarks/baselines/sensitivity_rounds96.json
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

from repro_torch.core import figures, report
from repro_torch.core.noc import PAPER_NOCS
from repro_torch.core.simulator import resolve_device


def build_report(path: str, *, rounds, mix_run, mix_s, device,
                 kernels_per_app=1):
    """Build the schema-3 report on ``mix_run``, with ``mix_s`` (the mix
    grid's wall) and the report's own wall in its manifest, and write it
    to ``path`` (and its .md); returns (report, markdown path)."""
    t0 = time.perf_counter()
    rep = report.run_sensitivity(
        kernels_per_app=kernels_per_app, rounds=rounds,
        mix_pairings=report.MIX_PAIRINGS, mix_run=mix_run,
        noc_models=PAPER_NOCS, device=device)
    rep["manifest"]["phases_wall_s"].update(
        mix_grid=round(mix_s, 6), report=round(time.perf_counter() - t0, 6))
    return rep, report.write_report(path, rep)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=None,
                    help="truncate every trace (the baseline: 96)")
    ap.add_argument("--report-json", required=True,
                    help="where to write the report (and its .md)")
    ap.add_argument("--check", default=None, metavar="BASELINE",
                    help="committed baseline report to gate against")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.perf_counter()
    mix_run = report.mix_grid_run(rounds=args.rounds, device=device)
    mix_s = time.perf_counter() - t0
    for name, derived in figures.mix_fairness(mix_run):
        print(f"{name},{derived}")
    rep, md_path = build_report(args.report_json, rounds=args.rounds,
                                mix_run=mix_run, device=device, mix_s=mix_s)
    man = rep["manifest"]
    print(f"sensitivity report: {args.report_json} + {md_path} "
          f"(mix grid {mix_s:.2f} s, solo and NoC sections "
          f"{man['phases_wall_s']['report']:.2f} s, device {device})")
    print(f"manifest: {man['device_name']} ({man['power_limit']}), torch "
          f"{man['torch_version']}, git {man['git_sha']}")
    for section, sec in (("solo", rep), ("mix", rep["mix"]),
                         ("noc", rep["noc"])):
        sw = sec["sweep"]
        print(f"{section}: {len(sec['cells'])} cells, {sw['n_points']} "
              f"points, {sw['n_executables']} executables, "
              f"{sw['wall_s']} s")
    if args.check is None:
        return 0
    failures = report.compare_reports(report.load_report(args.check), rep)
    for f in failures:
        print(f"REGRESSION: {f}", file=sys.stderr)
    if failures:
        return 1
    print(f"gate: {len(rep['cells'])} solo cells within 10% of "
          f"{args.check}, no executable growth")
    return 0


if __name__ == "__main__":
    sys.exit(main())
