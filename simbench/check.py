"""The comparison that decides ``correct``: the program's per-point
results against the plain reference's, value by value.

Two numbers are compared, each against a limit the configuration's file
states (``check``), set from measured readings (``PERF.md``):

* ``mismatched_counters``: the integer counters (accesses, hits, flits,
  served loads) that differ at all, summed over points and sweeps;
* ``max_rel_gap``: the widest relative gap of any value, the derived
  rates and the float32 cycle counts with them.

A point whose result is missing, or lacks a value, counts as one
mismatch per counter and a gap of 2, the widest two values can have.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

from simbench.reference.cachesim import COUNTERS, VALUES

#: the relative gap of a missing value (no two values lie further apart)
WIDEST = 2.0


def flatten(result) -> Optional[Dict[str, float]]:
    """A program result (``repro_torch``'s ``SimResult`` of one app) as
    {name: value} over the reference's names, None where it has none; a
    result of the reference, already such a dict, as it is."""
    if isinstance(result, dict):
        return result
    if result is None or len(getattr(result, "per_app", ())) != 1:
        return None
    out = {}
    for name in VALUES:
        part, _, field = name.rpartition(".")
        holder = {"": result, "app": result.per_app[0],
                  "noc": result.noc}[part]
        out[name] = float(getattr(holder, field))
    return out


def rel_gap(a: float, b: float) -> float:
    if math.isnan(a) or math.isnan(b):
        return 0.0 if math.isnan(a) and math.isnan(b) else WIDEST
    if a == b:
        return 0.0
    return abs(a - b) / max(abs(a), abs(b))


def compare(runs: Sequence[Sequence], reference: List[Dict[str, float]]
            ) -> Dict[str, float]:
    """``runs``: per sweep, the program's results of every point,
    aligned with ``reference``."""
    mismatched, gap = 0, 0.0
    for results in runs:
        for got, want in zip(results, reference):
            got = flatten(got)
            if got is None:
                mismatched += len(COUNTERS)
                gap = WIDEST
                continue
            mismatched += sum(got[k] != want[k] for k in COUNTERS)
            gap = max([gap] + [rel_gap(got[k], want[k]) for k in VALUES])
    return {"mismatched_counters": mismatched, "max_rel_gap": gap}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """{name: {"value", "limit"}} and whether every value is within its
    limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(numbers[k] <= limits[k] for k in limits)
    return {"checks": checks, "ok": ok}
