"""What a ``--trace 1`` run reads from ``torch.profiler``: the device's
busy intervals, the host's top-level operators and the traced window,
reduced to plain tuples, and the reductions the per-layer readers share.

Times are nanoseconds on the profiler's clock, which places host and
device events on one time base.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

#: the name of the span the harness records around each traced call
WINDOW = "simbench.window"

Interval = Tuple[str, int, int]          # (name, start_ns, end_ns)


class Capture(NamedTuple):
    """One traced window: ``device`` holds every kernel, copy and set
    on the card, ``host`` the top-level ATen operators of the thread that
    drove the window, both sorted by start; ``window`` is the span the
    harness recorded; ``context`` is what the runner knows of the work
    (rounds, points, traces) for readers that model it."""
    device: List[Interval]
    host: List[Interval]
    window: Tuple[int, int]
    context: Dict


def capture(prof, context: Dict) -> Capture:
    """Reduce a finished ``torch.profiler.profile`` to a :class:`Capture`."""
    from torch.autograd import DeviceType
    device, host, window, thread = [], [], None, None
    events = prof.profiler.kineto_results.events()
    for ev in events:
        if ev.name() == WINDOW and ev.device_type() == DeviceType.CPU:
            start = ev.start_ns()
            window = (start, start + ev.duration_ns())
            thread = ev.start_thread_id()
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW!r} span")
    for ev in events:
        name = ev.name()
        start = ev.start_ns()
        span = (name, start, start + ev.duration_ns())
        if ev.device_type() == DeviceType.CUDA:
            if name != WINDOW:          # the span's mirror on the device
                device.append(span)
        elif name.startswith("aten::") and ev.start_thread_id() == thread:
            host.append(span)
    device.sort(key=lambda s: s[1])
    host.sort(key=lambda s: s[1])
    return Capture(device, _outermost(host), window, context)


def _outermost(spans: List[Interval]) -> List[Interval]:
    """The spans not nested in another (``spans`` sorted by start)."""
    out, end = [], None
    for s in spans:
        if end is None or s[1] >= end:
            out.append(s)
            end = s[2]
    return out


def busy(spans: List[Interval], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of ``spans`` clipped to [lo, hi], as sorted disjoint
    (start, end) pairs."""
    merged: List[List[int]] = []
    for _, s, e in spans:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_ns(cap: Capture, lo: int, hi: int) -> int:
    return sum(e - s for s, e in busy(cap.device, lo, hi))


def rounds_span(cap: Capture) -> Optional[Tuple[int, int]]:
    """The device's span of the rounds of one pass: from the first device
    operation after the pass's last upload (host-to-device copy) to the
    last one before its first read-back (device-to-host copy). A pass
    uploads its traces and state before its first round and reads its
    counters back after its last; nothing between copies to or from the
    host. None where the window holds no such pair."""
    lo, hi = cap.window
    ups = [e for n, s, e in cap.device if "HtoD" in n and lo <= s <= hi]
    if not ups:
        return None
    after = max(ups)
    downs = [s for n, s, e in cap.device if "DtoH" in n and s >= after]
    if not downs:
        return None
    before = min(downs)
    inside = [(s, e) for n, s, e in cap.device
              if s >= after and e <= before]
    if not inside:
        return None
    return inside[0][0], max(e for _, e in inside)


def breakdown(cap: Capture, top: int = 10) -> Dict[str, list]:
    """The device operations that took the most time, and the device's
    idle gaps in the window summed by what the host was doing: in the
    rounds, the top-level operator running at the gap's middle, else
    Python between operators; before and after the rounds, the sweep's
    edges. A window with no rounds span is named as rounds throughout."""
    lo, hi = cap.window
    ops: Dict[str, float] = defaultdict(float)
    for name, s, e in cap.device:
        if lo <= s <= hi:
            ops[name[:100]] += (e - s) / 1e9
    gaps: Dict[str, float] = defaultdict(float)
    rounds = rounds_span(cap) or (lo, hi)
    starts = [s for _, s, _ in cap.host]
    bounds = [lo] + [x for s, e in busy(cap.device, lo, hi)
                     for x in (s, e)] + [hi]
    for a, b in zip(bounds[::2], bounds[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        if mid < rounds[0]:
            name = "host before the rounds (stacking, upload, set-up)"
        elif mid > rounds[1]:
            name = "host after the rounds (read-back, fold, summaries)"
        else:
            i = bisect.bisect_right(starts, mid) - 1
            name = (cap.host[i][0] if i >= 0 and cap.host[i][2] >= mid
                    else "Python between torch ops")
        gaps[name] += (b - a) / 1e9

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                if v > 0][:top]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}
