"""Calibration harness: the paper suite against the paper's targets.

The port of the reference's ``scripts/calibrate.py``. From a
``run_suite`` result (``{app: {arch: AppResult}}`` over the paper's four
architectures) it prints, per app, ``ata``'s, ``decoupled``'s and
``remote``'s IPC normalized to ``private``, their L1 latency against
``private`` and the L1 hit rates, then four lines against the paper:
``ata``'s geomean IPC gain on the high- and low-locality apps (+12.0%,
~0%), ``ata`` over ``decoupled`` on the low-locality apps (+22.9%), and
the mean L1 latency increase of ``decoupled`` (+67.2%, max 2.74x) and of
``ata`` (+6.0%). :func:`summary` takes a suite already run, so a caller
that holds one (``chip_smoke.py``'s paper suite) runs no simulation.

Usage (on the CUDA card; ``--device cpu`` runs without one):
  PYTHONPATH=src python -m repro_torch.launch.calibrate [KERNELS_PER_APP]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np

from repro_torch.core import (APPS, HIGH_LOCALITY, LOW_LOCALITY, geomean,
                              normalized_ipc)

def _apps(suite, apps) -> List[str]:
    return [a for a in apps if a in suite]


def summary(suite) -> Dict[str, float]:
    """The four comparisons as fractions (``lat_decoupled_max`` as a
    ratio): geomean IPC gains over ``private`` on the suite's high- and
    low-locality apps, ``ata`` over ``decoupled`` on the low-locality
    ones, and the mean (max) L1 latency ratio to ``private`` minus 1."""
    ipc = normalized_ipc(suite)
    hi = _apps(suite, HIGH_LOCALITY)
    lo = _apps(suite, LOW_LOCALITY)
    hi_ata = geomean([ipc[a]["ata"] for a in hi])
    lo_ata = geomean([ipc[a]["ata"] for a in lo])
    lo_dec = geomean([ipc[a]["decoupled"] for a in lo])
    lat = {arch: [suite[a][arch].l1_latency / suite[a]["private"].l1_latency
                  for a in _apps(suite, APPS)]
           for arch in ("ata", "decoupled")}
    return {"ata_gain_high": hi_ata - 1, "ata_gain_low": lo_ata - 1,
            "ata_vs_decoupled_low": lo_ata / lo_dec - 1,
            "lat_decoupled": float(np.mean(lat["decoupled"])) - 1,
            "lat_decoupled_max": max(lat["decoupled"]),
            "lat_ata": float(np.mean(lat["ata"])) - 1}


def table(suite) -> List[str]:
    """The per-app table and the four summary lines, as printed."""
    ipc = normalized_ipc(suite)
    lines = [f"{'app':10s} {'cls':4s} | {'ATA':>6s} {'dec':>6s} {'rem':>6s} "
             f"| {'L1lat A':>8s} {'L1lat D':>8s} | {'HR p':>5s} {'HR a':>5s} "
             f"{'HR d':>5s}"]
    for app in _apps(suite, list(HIGH_LOCALITY) + list(LOW_LOCALITY)):
        r = suite[app]
        lat = {a: r[a].l1_latency / r["private"].l1_latency for a in r}
        lines.append(
            f"{app:10s} {'HI' if APPS[app].high_locality else 'LO':4s} | "
            f"{ipc[app]['ata']:6.3f} {ipc[app]['decoupled']:6.3f} "
            f"{ipc[app]['remote']:6.3f} | {lat['ata']:8.3f} "
            f"{lat['decoupled']:8.3f} | {r['private'].l1_hit_rate:5.2f} "
            f"{r['ata'].l1_hit_rate:5.2f} {r['decoupled'].l1_hit_rate:5.2f}")
    s = summary(suite)
    lines += [
        "",
        f"ATA hi-loc IPC gain : {100 * s['ata_gain_high']:+6.1f}%   "
        "(paper +12.0%)",
        f"ATA lo-loc IPC gain : {100 * s['ata_gain_low']:+6.1f}%   "
        "(paper ~0%, no impairment)",
        f"ATA/dec lo-loc      : {100 * s['ata_vs_decoupled_low']:+6.1f}%   "
        "(paper +22.9%)",
        f"L1 lat: dec {100 * s['lat_decoupled']:+6.1f}% (paper +67.2%, max "
        f"{s['lat_decoupled_max']:.2f}x vs 2.74x) | ata "
        f"{100 * s['lat_ata']:+6.1f}% (paper +6.0%)"]
    return lines


def main(argv=None) -> None:
    from repro_torch.core import run_suite
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernels_per_app", nargs="?", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    t0 = time.time()
    suite = run_suite(kernels_per_app=args.kernels_per_app,
                      device=args.device)
    print("\n".join(table(suite)))
    print(f"[{time.time() - t0:.0f}s]")


if __name__ == "__main__":
    main()
