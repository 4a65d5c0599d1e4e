"""Benchmark-regression gate (the port of the reference's
``scripts/check_bench_regression.py``).

Compares a freshly produced report against a committed baseline and
exits 1 on any finding, 0 otherwise. It dispatches on the baseline's
``kind``:

* ``"serving"`` (``launch/serving_scale.py``): ``compare_serving``; per
  cell, probe-message and request counts exact, hit rate within
  ``--hit-rtol``; the batched modeled speedup one-sided against the
  absolute 1.5x floor and the baseline minus ``--batched-rtol``; p99
  latency (``--latency-rtol``) and the batched wall speedup
  (``--wall-rtol``) only when asked;
* ``"simspeed"`` (``launch/sim_speed.py``): ``compare_simspeed``; the
  fused-speedup ratio one-sided within ``--speedup-rtol``, no
  executable growth per backend; absolute rounds/sec only with
  ``--rps-rtol``;
* otherwise the sensitivity report (``launch/sensitivity.py``):
  ``compare_reports``, per-cell IPC within ``--ipc-rtol`` and no
  executable growth, forward-compatible across schemas.

The committed baselines name the reference's probe lowerings; the gates
read them through ``repro_torch.core.report.REFERENCE_BACKENDS``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.check_regression \\
      benchmarks/baselines/simspeed_rounds64.json simspeed.json
  PYTHONPATH=src python -m repro_torch.launch.check_regression \\
      benchmarks/baselines/serving_rounds512.json serving.json
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.core.report import (compare_reports, compare_serving,
                                     compare_simspeed, load_report)


def _failed(kind: str, failures: List[str]) -> int:
    print(f"{kind} regression gate FAILED ({len(failures)} finding(s)):",
          file=sys.stderr)
    for f in failures:
        print(f"  - {f}", file=sys.stderr)
    print("(intentional change? regenerate the baseline with the "
          "reference's benchmarks)", file=sys.stderr)
    return 1


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("baseline", help="committed baseline report JSON")
    ap.add_argument("candidate", help="freshly produced report JSON")
    ap.add_argument("--ipc-rtol", type=float, default=0.10,
                    help="allowed per-cell IPC drift (default 10%%)")
    ap.add_argument("--speedup-rtol", type=float, default=0.30,
                    help="allowed one-sided fused-speedup-ratio drop "
                    "for simspeed reports (default 30%%)")
    ap.add_argument("--rps-rtol", type=float, default=None,
                    help="gate absolute rounds/sec too (simspeed; "
                    "off by default: host-dependent)")
    ap.add_argument("--hit-rtol", type=float, default=0.005,
                    help="allowed per-cell hit-rate drift for serving "
                    "reports (default 0.5%%; probe counts gate exactly)")
    ap.add_argument("--latency-rtol", type=float, default=None,
                    help="gate modeled p99 latency too (serving; off by "
                    "default)")
    ap.add_argument("--batched-rtol", type=float, default=0.15,
                    help="allowed one-sided batched modeled-speedup "
                    "drop vs baseline (serving; the absolute 1.5x floor "
                    "always applies; default 15%%)")
    ap.add_argument("--wall-rtol", type=float, default=None,
                    help="gate the batched wall-clock speedup ratio too "
                    "(serving; off by default: host-dependent)")
    args = ap.parse_args(argv)

    baseline = load_report(args.baseline)
    candidate = load_report(args.candidate)
    if baseline.get("kind") == "serving":
        failures = compare_serving(baseline, candidate,
                                   hit_rtol=args.hit_rtol,
                                   latency_rtol=args.latency_rtol,
                                   batched_rtol=args.batched_rtol,
                                   wall_rtol=args.wall_rtol)
        if failures:
            return _failed("serving", failures)
        ratio = candidate.get("headline", {}).get("batched_model_speedup")
        batched = (f", batched speedup {ratio:.2f}x"
                   if ratio is not None else "")
        print(f"serving regression gate OK: {len(baseline['cells'])} "
              f"cells, probe messages exact, hit rate within "
              f"±{args.hit_rtol:.1%}{batched}")
        return 0
    if baseline.get("kind") == "simspeed":
        failures = compare_simspeed(baseline, candidate,
                                    speedup_rtol=args.speedup_rtol,
                                    rps_rtol=args.rps_rtol)
        if failures:
            return _failed("simspeed", failures)
        ratio = candidate.get("headline", {}).get("fused_speedup")
        floor = baseline["headline"]["fused_speedup"] * (
            1 - args.speedup_rtol)
        print(f"simspeed regression gate OK: {len(baseline['cells'])} "
              f"backends present, fused speedup {ratio:.3f}x (floor "
              f"{floor:.3f}x)")
        return 0
    if candidate.get("schema") != baseline.get("schema"):
        print(f"note: forward-compatible compare — baseline schema "
              f"{baseline.get('schema')}, candidate schema "
              f"{candidate.get('schema')}; gating on the baseline's "
              "sections only", file=sys.stderr)
    failures = compare_reports(baseline, candidate, ipc_rtol=args.ipc_rtol)
    if failures:
        return _failed("benchmark", failures)
    print(f"benchmark regression gate OK: {len(baseline['cells'])} cells "
          f"within ±{args.ipc_rtol:.0%} IPC, executables "
          f"{candidate['sweep']['n_executables']} <= "
          f"{baseline['sweep']['n_executables']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
