"""Reproduce the paper's figures end to end (the port of
``examples/paper_repro.py``).

Runs ``run_suite`` over the ten calibrated apps under the chosen
architectures and prints Fig. 8, Fig. 9, Fig. 10 and Table I as
``name,derived`` rows (``repro_torch.core.figures``), the per-
architecture zoo table when more than the paper's four run, and the
headline numbers beside the paper's claims.

Usage (on the CUDA card; ``--device cpu`` runs without one):
  PYTHONPATH=src python -m repro_torch.launch.paper_repro
  PYTHONPATH=src python -m repro_torch.launch.paper_repro --archs all
  PYTHONPATH=src python -m repro_torch.launch.paper_repro --device cpu \\
      --rounds 64 --kernels 1
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import (APPS, HIGH_LOCALITY, LOW_LOCALITY,
                              PAPER_ARCHITECTURES, geomean, normalized_ipc,
                              registered_archs, run_suite)
from repro_torch.core import figures
from repro_torch.core.simulator import resolve_device


def parse_archs(spec: str) -> tuple:
    """``"paper"`` (the four), ``"all"`` (every registered architecture)
    or a comma-separated list; the paper's four always run, since the
    figures compare against them."""
    if spec == "all":
        return registered_archs()
    extra = [] if spec == "paper" else [a for a in spec.split(",") if a]
    for a in extra:
        if a not in registered_archs():
            raise SystemExit(f"unknown architecture {a!r}; registered: "
                             f"{registered_archs()}")
    return tuple(dict.fromkeys(list(PAPER_ARCHITECTURES) + extra))


def run_paper_suite(archs, kernels_per_app=None, rounds=None, device=None):
    """``run_suite`` one architecture at a time; returns the merged
    ``{app: {arch: AppResult}}`` suite and each architecture's wall (s)."""
    suite, walls = {}, {}
    for arch in archs:
        t0 = time.perf_counter()
        part = run_suite(archs=(arch,), kernels_per_app=kernels_per_app,
                         rounds=rounds, device=device)
        walls[arch] = time.perf_counter() - t0
        for app, cells in part.items():
            suite.setdefault(app, {}).update(cells)
    return suite, walls


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", type=int, default=0,
                    help="kernels per app (0 = all 53, as in Fig. 9)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="truncate every trace (default: full length)")
    ap.add_argument("--archs", default="paper",
                    help="'paper' (default), 'all', or a comma list of "
                         "architectures to add to the paper's four")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    archs = parse_archs(args.archs)

    suite, walls = run_paper_suite(archs, args.kernels or None, args.rounds,
                                   device)
    rows = figures.paper_rows(suite)
    if len(archs) > len(PAPER_ARCHITECTURES):
        rows += figures.zoo_table(suite)
    for name, derived in rows:
        print(f"{name},{derived}")

    ipc = normalized_ipc(suite)
    hi = geomean([ipc[a]["ata"] for a in HIGH_LOCALITY])
    lo = geomean([ipc[a]["ata"] for a in LOW_LOCALITY])
    lat = {arch: np.mean([suite[a][arch].l1_latency
                          / suite[a]["private"].l1_latency for a in APPS])
           for arch in ("decoupled", "ata")}
    print(f"\nATA IPC gain, high-locality: {100 * (hi - 1):+.2f}%  "
          "(paper +12.0%)")
    print(f"ATA IPC gain, low-locality : {100 * (lo - 1):+.2f}%  "
          "(paper: no loss)")
    print(f"L1 latency: decoupled {100 * (lat['decoupled'] - 1):+.1f}% "
          f"(paper +67.2%), ATA {100 * (lat['ata'] - 1):+.1f}% "
          "(paper +6.0%)")
    print("suite wall per architecture (s, device "
          f"{device}): " + ", ".join(f"{a}={w:.2f}" for a, w in walls.items()))
    return {"suite": suite, "rows": rows, "walls": walls}


if __name__ == "__main__":
    main()
