"""Simulator throughput per probe backend: rounds per second over the
geometry-sweep grid (the port of the reference's
``benchmarks/sim_speed.py``).

It times a full :class:`repro_torch.core.sweep.SweepGrid` run (the 13
distinct geometries of the six ``figures.KNOBS`` x the ``ata`` policy x
``cfd`` kernel 0) once per probe backend, and reports rounds simulated per
wall-clock second: the best of ``reps`` timed runs after one warm run.
The warm run's :class:`~repro_torch.core.sweep.SweepReport` gives
``n_executables``, the grid's batched passes (7 per backend: one per
geometry structure).

``torch`` against ``torch_unfused`` is the headline, ``fused_speedup``:
the same sweep with and without the fused probe chain (the reference's
``lax`` and ``lax_unfused``), on one device. ``--backends`` may add
``cuda``, the ``ata_probe_rank`` kernel, as the reference's ``run`` may
add ``pallas``. The reference's ``--interpret`` (a Pallas interpreter
cell) has no counterpart: the port's CPU route is the plain version.

``--json`` writes the ``kind="simspeed"`` schema-1 report with its run
``manifest``; ``--check BASELINE`` gates it with
``repro_torch.core.report.compare_simspeed`` (the ratio is gated, not the
host-dependent rounds/sec) and exits non-zero on any failure.

Usage (on the CUDA card; ``--device cpu`` runs without one):
  PYTHONPATH=src python -m repro_torch.launch.sim_speed --rounds 64 \\
      --backends torch torch_unfused cuda --json simspeed.json \\
      --check benchmarks/baselines/simspeed_rounds64.json
  PYTHONPATH=src python -m repro_torch.launch.sim_speed --device cpu \\
      --rounds 64 --reps 1
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from repro_torch.core.figures import KNOBS, knob_geometry
from repro_torch.core.metrics import app_traces
from repro_torch.core.probe import PROBE_BACKENDS
from repro_torch.core.simulator import resolve_device
from repro_torch.core.sweep import SweepGrid, SweepPoint
from repro_torch.launch.common import emit
from repro_torch.obs.manifest import run_manifest

APP = "cfd"
KERNEL = 0
ARCH = "ata"
SCHEMA = 1
#: headline = the fused torch chain vs the historical unfused chain
DEFAULT_BACKENDS = ("torch", "torch_unfused")


def unique_geometries():
    """The deduplicated geometry set of the six figure knobs."""
    geoms = []
    for knob, values in KNOBS.items():
        for v in values:
            g = knob_geometry(knob, v)
            if g not in geoms:
                geoms.append(g)
    return geoms


def _grid(geoms, traces, backend):
    return SweepGrid.from_points(
        [SweepPoint(ARCH, g, traces[g.n_cores], "ideal", backend)
         for g in geoms])


def _time_backend(geoms, traces, backend, rounds, reps, device):
    grid = _grid(geoms, traces, backend)
    warm = grid.run(device=device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        grid.run(device=device)      # results come back to the host
        best = min(best, time.perf_counter() - t0)
    sim_rounds = len(geoms) * rounds
    return {
        "backend": backend,
        "n_points": len(geoms),
        "rounds": rounds,
        "wall_s": best,
        "rounds_per_sec": sim_rounds / best,
        "n_executables": warm.report.n_executables,
    }


def run(rounds=64, reps=3, backends=DEFAULT_BACKENDS, out_json=None,
        geoms=None, device=None):
    """Time every backend; returns the simspeed report (and writes it to
    ``out_json``). Runs on ``device`` (default ``"cuda"``)."""
    device = resolve_device(device)
    geoms = list(geoms) if geoms is not None else unique_geometries()
    traces = {}
    for g in geoms:
        if g.n_cores not in traces:
            traces[g.n_cores] = app_traces(APP, g, [KERNEL],
                                           rounds=rounds)[0]
    cells = []
    for backend in backends:
        cell = _time_backend(geoms, traces, backend, rounds, reps, device)
        cells.append(cell)
        emit(f"sim_speed.{backend}", cell["wall_s"] * 1e6,
             f"{cell['rounds_per_sec']:.0f} rounds/s")

    rps = {c["backend"]: c["rounds_per_sec"] for c in cells}
    headline = {}
    if "torch" in rps and "torch_unfused" in rps:
        headline["fused_speedup"] = rps["torch"] / rps["torch_unfused"]
        emit("sim_speed.fused_speedup", 0.0,
             f"{headline['fused_speedup']:.3f}x")
    report = {
        "kind": "simspeed",
        "schema": SCHEMA,
        "config": {"app": APP, "kernel": KERNEL, "arch": ARCH,
                   "rounds": rounds, "n_geoms": len(geoms)},
        "sweep": {"n_executables": sum(c["n_executables"]
                                       for c in cells)},
        "cells": cells,
        "headline": headline,
        "manifest": run_manifest(
            phases={f"backend.{c['backend']}": c["wall_s"]
                    for c in cells},
            extra={"device": str(device)}),
    }
    if out_json:
        with open(out_json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
    return report


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=64,
                    help="trace rounds per point (default 64)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed repetitions, best taken (default 3)")
    ap.add_argument("--backends", nargs="+", default=list(DEFAULT_BACKENDS),
                    choices=PROBE_BACKENDS,
                    help="probe backends to time (default torch "
                    "torch_unfused)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the simspeed report JSON here")
    ap.add_argument("--check", default=None, metavar="BASELINE",
                    help="committed simspeed baseline to gate against")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    rep = run(rounds=args.rounds, reps=args.reps,
              backends=tuple(args.backends), out_json=args.json,
              device=args.device)
    if args.check is None:
        return 0
    from repro_torch.core.report import compare_simspeed, load_report
    failures = compare_simspeed(load_report(args.check), rep)
    for f in failures:
        print(f"REGRESSION: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
