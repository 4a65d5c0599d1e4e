"""Chrome-trace-event export of telemetry timelines.

The port of the reference's ``repro.obs.perfetto``, numpy only.

Emits the JSON object format (``{"traceEvents": [...]}``) that
Perfetto and ``chrome://tracing`` load directly:

* one **thread track per core** (simulator) or **per shard** (serving
  engine) carrying one complete-event span per window, whose duration
  is that lane's accumulated work in the window (per-core round cost /
  per-shard latency sum) — lanes that fall behind the global clock
  show idle gaps;
* one **thread track per active link** under a ``noc`` process with
  per-window flit spans (simulator captures with a non-ideal NoC);
* **counter tracks** (``"ph": "C"``) for hit rate, queue depth,
  L2/DRAM traffic, and probe messages, sampled at window boundaries.

The global timebase is the run's modeled clock in cycles (mapped 1:1
onto trace microseconds): window ``w`` spans
``[cum_cycles[w-1], cum_cycles[w])`` where ``cum_cycles`` is the
cumulative max-over-lanes cycle counter — so wall layout matches the
model's own notion of time, not the host's.

:func:`validate_trace` is the schema check the tests run against
generated and committed traces.
"""
from __future__ import annotations

import json
from typing import List, Optional

import numpy as np

from repro_torch.obs.timeline import ServeTimeline, SimTimeline

_PHASES = {"M", "C", "X"}


def _meta(pid: int, name: str, tid: Optional[int] = None,
          tname: Optional[str] = None) -> List[dict]:
    evs = [{"ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": name}}]
    if tid is not None:
        evs.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": tname}})
    return evs


def _counter(name: str, pid: int, ts: float, value: float) -> dict:
    return {"ph": "C", "name": name, "pid": pid, "ts": float(ts),
            "args": {"value": float(value)}}


def _span(name: str, pid: int, tid: int, ts: float, dur: float) -> dict:
    return {"ph": "X", "name": name, "pid": pid, "tid": tid,
            "ts": float(ts), "dur": float(max(dur, 0.0))}


def _lane_spans(events, pid, lane_work, window_starts, label):
    """One span per (lane, window): duration = the lane's work."""
    n_w, n_lanes = lane_work.shape
    for lane in range(n_lanes):
        for w in range(n_w):
            dur = float(lane_work[w, lane])
            if dur > 0.0:
                events.append(_span(f"{label} w{w}", pid, lane,
                                    window_starts[w], dur))


def sim_trace_events(tl: SimTimeline) -> dict:
    """Trace-event JSON for one simulator timeline."""
    events: List[dict] = []
    cycles = tl.series("cycles")                       # (nW, C)
    n_w, n_cores = cycles.shape
    clock = np.concatenate([[0.0],
                            np.cumsum(cycles.max(axis=1))])  # (nW+1,)
    starts, ends = clock[:-1], clock[1:]

    pid_cores, pid_counters, pid_links = 1, 2, 3
    events += _meta(pid_cores, "cores")
    for c in range(n_cores):
        events += _meta(pid_cores, "cores", c, f"core {c}")[1:]
    _lane_spans(events, pid_cores, cycles, starts, "rounds")

    events += _meta(pid_counters, "counters")
    req = tl.series("requests")
    local, remote = tl.series("local_hits"), tl.series("remote_hits")
    l2, dram = tl.series("l2_accesses"), tl.series("dram")
    queue = (tl.series("noc.queue") if "noc.queue" in tl.cumulative
             else None)
    for w in range(n_w):
        r = float(req[w])
        hit = (float(local[w] + remote[w]) / r) if r else 0.0
        events.append(_counter("l1_hit_rate", pid_counters, ends[w], hit))
        events.append(_counter("l2_accesses", pid_counters, ends[w],
                               float(l2[w])))
        events.append(_counter("dram", pid_counters, ends[w],
                               float(dram[w])))
        if queue is not None:
            events.append(_counter("noc_queue_depth", pid_counters,
                                   ends[w], float(queue[w].sum())))

    link_flits = tl.series("noc.link_flits")           # (nW, L)
    active = np.flatnonzero(link_flits.sum(axis=0) > 0)
    if active.size:
        events += _meta(pid_links, "noc")
        for li in active:
            events += _meta(pid_links, "noc", int(li),
                            f"link {int(li)}")[1:]
        _lane_spans(events, pid_links, link_flits[:, active],
                    starts, "flits")

    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"kind": tl.kind, "window": tl.window,
                          "rounds": tl.rounds, **{
                              k: v for k, v in tl.meta.items()
                              if isinstance(v, (str, int, float))}}}


def serve_trace_events(tl: ServeTimeline) -> dict:
    """Trace-event JSON for one serving-engine timeline."""
    events: List[dict] = []
    cycles = tl.series("cycles")                       # (nW,)
    lat = tl.series("latency_sum")                     # (nW, C)
    n_w = cycles.shape[0]
    clock = np.concatenate([[0.0], np.cumsum(cycles)])
    starts, ends = clock[:-1], clock[1:]

    pid_shards, pid_counters = 1, 2
    events += _meta(pid_shards, "shards")
    for c in range(lat.shape[1]):
        events += _meta(pid_shards, "shards", c, f"shard {c}")[1:]
    _lane_spans(events, pid_shards, lat, starts, "serve")

    events += _meta(pid_counters, "counters")
    adm = tl.series("admitted").sum(axis=1)
    hits = (tl.series("local_hits") + tl.series("remote_hits")) \
        .sum(axis=1)
    blocks = hits + tl.series("recomputed").sum(axis=1)
    pm = tl.series("probe_messages")
    for w in range(n_w):
        rate = float(hits[w]) / float(blocks[w]) if blocks[w] else 0.0
        events.append(_counter("hit_rate", pid_counters, ends[w], rate))
        events.append(_counter("admitted", pid_counters, ends[w],
                               float(adm[w])))
        events.append(_counter("probe_messages", pid_counters, ends[w],
                               float(pm[w])))

    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"kind": tl.kind, "window": tl.window,
                          "rounds": tl.rounds, **{
                              k: v for k, v in tl.meta.items()
                              if isinstance(v, (str, int, float))}}}


def trace_events(tl) -> dict:
    """Dispatch on timeline kind."""
    if isinstance(tl, SimTimeline):
        return sim_trace_events(tl)
    if isinstance(tl, ServeTimeline):
        return serve_trace_events(tl)
    raise TypeError(f"not a telemetry timeline: {type(tl).__name__}")


def write_trace(path: str, tl, manifest: Optional[dict] = None) -> dict:
    """Export ``tl`` as Chrome-trace-event JSON at ``path``.

    Validates the object before writing; attaches the run manifest
    under ``otherData.manifest`` when given. Returns the trace dict.
    """
    obj = trace_events(tl)
    if manifest is not None:
        obj["otherData"]["manifest"] = manifest
    validate_trace(obj)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
    return obj


def validate_trace(obj) -> None:
    """Raise ``ValueError`` unless ``obj`` is valid Chrome-trace-event
    JSON (object format, known phases, well-typed fields)."""
    problems: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError(
            "not a Chrome-trace-event object: missing 'traceEvents'")
    events = obj["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("'traceEvents' must be a non-empty list")
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            problems.append(f"{where}: unknown phase {ph!r}")
            continue
        if not isinstance(ev.get("name"), str):
            problems.append(f"{where}: 'name' must be a string")
        if not isinstance(ev.get("pid"), int):
            problems.append(f"{where}: 'pid' must be an int")
        if ph in ("C", "X") and not isinstance(
                ev.get("ts"), (int, float)):
            problems.append(f"{where}: '{ph}' needs numeric 'ts'")
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) \
                    or ev["dur"] < 0:
                problems.append(
                    f"{where}: 'X' needs non-negative numeric 'dur'")
            if not isinstance(ev.get("tid"), int):
                problems.append(f"{where}: 'X' needs int 'tid'")
        if ph in ("C", "M"):
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                problems.append(
                    f"{where}: '{ph}' needs a non-empty 'args' object")
            elif ph == "C" and not all(
                    isinstance(v, (int, float)) for v in args.values()):
                problems.append(
                    f"{where}: 'C' args values must be numeric")
    try:
        json.dumps(obj)
    except (TypeError, ValueError) as e:
        problems.append(f"not JSON-serializable: {e}")
    if problems:
        raise ValueError("invalid trace-event JSON:\n  "
                         + "\n  ".join(problems[:20]))
