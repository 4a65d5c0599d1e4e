"""What the program's own host spans say of a traced sweep.

``repro_torch`` opens host spans named ``repro_torch.*`` around its
sweep's work (``repro_torch.core.telemetry.SWEEP_SPANS``): the bucketing,
each pass's stacking, upload and state set-up, its rounds and each
round's six stages, and its wait, read-back, fold and summaries. They
are function-scope profiler ranges: they lie on the host thread of the
profile, on its clock, and have no events of their own on the device.
:func:`simbench.devtrace.capture` keeps the device's events and the
host's ATen operators; this module reads the spans from the same profile
and puts each device operation down to the span its launching operator
ran in (the device event's ``linked_correlation_id`` is the correlation
id of the host operator that launched it).

Run from the root of a checkout, on the card:

    python3 simbench/spantrace.py --workload ata.timing-sweep --seed 7

It runs the cell's set-up and one profiled sweep as a ``--trace 1`` run
of ``simbench/run.py`` does (no reference after it) and prints one JSON
line: the per-layer metrics of ``BENCHMARK.json`` read from the same
capture, the span walls, the metrics these spans are for
(:func:`readings`), a round's device time by stage, the sweep's report
counters and the breakdown with the gaps and operations named by span
(:func:`breakdown`). ``--draws`` and ``--rounds`` cut the cell for a
first check.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from simbench import devtrace  # noqa: E402

#: the prefix of every span the program opens
PREFIX = "repro_torch."
#: the prefix of a round's stage spans
STAGE = PREFIX + "round."

Interval = devtrace.Interval


class Spans(NamedTuple):
    """The program's spans on the window's thread, sorted by start (an
    enclosing span before the spans it holds), each span's enclosing
    span (an index into ``host``, -1 for none), and every device
    operation as (name, start_ns, end_ns, launch_ns), where
    ``launch_ns`` is the host start of the operator that launched it
    (None where the profile links it to none)."""
    host: List[Interval]
    parent: List[int]
    ops: List[Tuple[str, int, int, Optional[int]]]


def nest(host: List[Interval], ops=()) -> Spans:
    """:class:`Spans` of nested ``host`` spans (in any order) and
    ``ops``."""
    host = sorted(host, key=lambda s: (s[1], -s[2]))
    parent, stack = [], []
    for i, (_, s, _) in enumerate(host):
        while stack and host[stack[-1]][2] <= s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    return Spans(host, parent, sorted(ops, key=lambda o: o[1]))


def spans_of(events, thread: int) -> Spans:
    """The :class:`Spans` of a profile's kineto events (each with
    ``name()``, ``device_type()``, ``start_ns()``, ``duration_ns()``,
    ``start_thread_id()``, ``correlation_id()`` and
    ``linked_correlation_id()``), the host spans taken from ``thread``.
    A device event named by a span (a user annotation's mirror) is not
    an operation."""
    from torch.autograd import DeviceType
    host, launched, device = [], {}, []
    for ev in events:
        name, start = ev.name(), ev.start_ns()
        if ev.device_type() == DeviceType.CUDA:
            if not name.startswith(PREFIX) and name != devtrace.WINDOW:
                device.append((name, start, start + ev.duration_ns(),
                               ev.linked_correlation_id()))
        else:
            launched[ev.correlation_id()] = start
            if name.startswith(PREFIX) and ev.start_thread_id() == thread:
                host.append((name, start, start + ev.duration_ns()))
    return nest(host, [(n, s, e, launched.get(c) if c else None)
                       for n, s, e, c in device])


def innermost(sp: Spans, t: int) -> Optional[str]:
    """The name of the innermost span that holds ``t``, or None."""
    i = bisect.bisect_right(sp.host, t, key=lambda s: s[1]) - 1
    while i >= 0 and not sp.host[i][1] <= t < sp.host[i][2]:
        i = sp.parent[i]
    return sp.host[i][0] if i >= 0 else None


def walls_ms(sp: Spans) -> Dict[str, float]:
    """Each span name's summed wall in ms (its occurrences added)."""
    out: Dict[str, float] = defaultdict(float)
    for name, s, e in sp.host:
        out[name[len(PREFIX):]] += (e - s) / 1e6
    return dict(out)


def readings(sp: Spans, report=None) -> Dict[str, float]:
    """The numbers the spans and the report's counters are for, as the
    metrics a later reader would give: ``sweep_prepare_ms`` (walls of
    ``sweep.bucket`` and every ``pass.prepare``), ``sweep_finish_ms``
    (walls of every ``pass.finish`` less their ``pass.wait``), and from
    the :class:`~repro_torch.core.sweep.SweepReport`
    ``upload_mb_per_sweep`` and ``readback_mb_per_sweep``. A number
    with nothing to read is left out."""
    w = walls_ms(sp)
    out = {}
    if "pass.prepare" in w:
        out["sweep_prepare_ms"] = w.get("sweep.bucket", 0.0) \
            + w["pass.prepare"]
    if "pass.finish" in w:
        out["sweep_finish_ms"] = w["pass.finish"] - w.get("pass.wait", 0.0)
    for key, name in (("upload_bytes", "upload_mb_per_sweep"),
                      ("readback_bytes", "readback_mb_per_sweep")):
        if getattr(report, key, None):
            out[name] = getattr(report, key) / 1e6
    return out


def stage_of(sp: Spans, op) -> Optional[str]:
    """The ``round.*`` stage an operation was launched in, or None (a
    stage holds no other span)."""
    name = None if op[3] is None else innermost(sp, op[3])
    return name if name is not None and name.startswith(STAGE) else None


def stage_ms_per_round(sp: Spans, rounds: int) -> Dict[str, float]:
    """The device time of the operations launched in each round stage
    (their durations summed, overlaps counted twice), per round."""
    out: Dict[str, float] = defaultdict(float)
    for op in sp.ops:
        stage = stage_of(sp, op)
        if stage is not None:
            out[stage[len(STAGE):]] += (op[2] - op[1]) / 1e6 / rounds
    return dict(out)


def breakdown(cap: devtrace.Capture, sp: Spans, top: int = 10
              ) -> Dict[str, list]:
    """:func:`simbench.devtrace.breakdown` with the program's spans: an
    idle gap outside the rounds is cut at every span boundary inside it
    and each piece takes the name of the innermost program span at its
    middle, and a device operation launched in a round stage is keyed
    ``<stage> · <name>`` (cut to 100 characters). Where no span covers a
    piece or an operation, it keeps the plain label, so a capture
    without spans reads exactly as ``devtrace.breakdown``."""
    lo, hi = cap.window
    stages = {(n, s, e): stage_of(sp, (n, s, e, t))
              for n, s, e, t in sp.ops}
    ops: Dict[str, float] = defaultdict(float)
    for name, s, e in cap.device:
        if lo <= s <= hi:
            stage = stages.get((name, s, e))
            key = name if stage is None else \
                f"{stage[len(PREFIX):]} · {name}"
            ops[key[:100]] += (e - s) / 1e9
    gaps: Dict[str, float] = defaultdict(float)
    rounds = devtrace.rounds_span(cap) or (lo, hi)
    starts = [s for _, s, _ in cap.host]
    cuts = sorted({t for _, s, e in sp.host for t in (s, e)})
    bounds = [lo] + [x for s, e in devtrace.busy(cap.device, lo, hi)
                     for x in (s, e)] + [hi]
    for a, b in zip(bounds[::2], bounds[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        if rounds[0] <= mid <= rounds[1]:
            i = bisect.bisect_right(starts, mid) - 1
            name = (cap.host[i][0] if i >= 0 and cap.host[i][2] >= mid
                    else "Python between torch ops")
            gaps[name] += (b - a) / 1e9
            continue
        edges = [a] + cuts[bisect.bisect_right(cuts, a):
                           bisect.bisect_left(cuts, b)] + [b]
        for x, y in zip(edges, edges[1:]):
            name = innermost(sp, (x + y) // 2)
            if name is not None:
                name = name[len(PREFIX):]
            elif mid < rounds[0]:
                name = "host before the rounds (stacking, upload, set-up)"
            else:
                name = "host after the rounds (read-back, fold, summaries)"
            gaps[name] += (y - x) / 1e9

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                if v > 0][:top]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--draws", type=int, help="cut the mix's draws")
    ap.add_argument("--rounds", type=int, help="cut the traces' rounds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from simbench import harness
    from simbench.runners import sweep

    work, config, traffic, bench = harness.load_cell(args.workload)
    device = harness.device_of(args.device, work["chips"])
    if args.draws:
        traffic = dict(traffic, draws=args.draws)
    if args.rounds:
        config = dict(config, rounds=args.rounds)
    frozen = sweep.traces(config, traffic, args.seed)
    geoms = sweep.geometries(config, traffic)
    rounds = config["rounds"]
    grid = sweep._grid(config, geoms, frozen, rounds, device)
    sweep.warm(config, traffic, geoms, frozen, device)
    sweep._sync(device)
    setup_s = time.perf_counter() - t0
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function(devtrace.WINDOW):
            run = grid.run(device=device)
            sweep._sync(device)
    cap = devtrace.capture(prof, {
        "rounds": rounds, "points": len(grid.points), "traces": frozen,
        "geometry": config["geometry"]})
    events = prof.profiler.kineto_results.events()
    thread = next(ev.start_thread_id() for ev in events
                  if ev.name() == devtrace.WINDOW
                  and ev.device_type() != torch.autograd.DeviceType.CUDA)
    sp = spans_of(events, thread)
    accepted = {}
    for m in bench["per_layer"]:
        if harness._applies(m, args.workload):
            value = harness.reader(m["name"]).read(cap)
            if value is not None:
                accepted[m["name"]] = value
    lo, hi = cap.window
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "points": len(grid.points), "rounds": rounds,
        "setup_s": setup_s, "window_s": (hi - lo) / 1e9,
        "busy_s": devtrace.busy_ns(cap, lo, hi) / 1e9,
        "per_layer": accepted,
        "readings": readings(sp, run.report),
        "span_walls_ms": walls_ms(sp),
        "span_counts": dict(Counter(n for n, _, _ in sp.host)),
        "stage_ms_per_round": stage_ms_per_round(sp, rounds),
        "device_mirrors": sum(1 for ev in events
                              if ev.name().startswith(PREFIX)
                              and ev.device_type()
                              == torch.autograd.DeviceType.CUDA),
        "report": dataclasses.asdict(run.report),
        "breakdown": breakdown(cap, sp, top=24),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
