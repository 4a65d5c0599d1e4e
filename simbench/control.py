"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place and computed one precision below
the configuration's (bfloat16 timing arithmetic and counters for its
float32), on every point a run of the cell compares, at the cell's own
traces and rounds. Its numbers have to fail the cell's limits.

    python3 simbench/control.py --workload ata.timing-sweep \
        --seeds 11 22 33 [--device cpu]

prints one JSON line per seed with the control's numbers beside the
limits. The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def control_numbers(config: dict, traffic: dict, seed: int, device) -> dict:
    """The control's numbers for one seed of a cell of ``config`` under
    ``traffic``, beside the configuration's limits."""
    import torch
    from simbench import check
    from simbench.runners import sweep
    frozen = sweep.traces(config, traffic, seed)
    geoms = sweep.geometries(config, traffic)
    points = range(len(frozen) * len(geoms))
    want = sweep.reference_results(config, frozen, geoms, points, device)
    lower = sweep.reference_results(config, frozen, geoms, points, device,
                                    timing_dtype=torch.bfloat16)
    numbers = check.compare([lower], want)
    return check.verdict(numbers, config["check"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from simbench import harness
    _, config, traffic, _ = harness.load_cell(args.workload)
    device = torch.device(args.device)
    for seed in args.seeds:
        v = control_numbers(config, traffic, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_passes": v["ok"], **v["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    root = Path(__file__).resolve().parents[1]
    sys.path[0] = str(root)     # not simbench/: its modules are a package
    sys.exit(main())
