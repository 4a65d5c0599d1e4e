"""The program's spans read from a made-up profile of known numbers: one
pass of two rounds between an upload and a read-back, as in
``test_simbench_devtrace.py``, with the spans the program opens around
it and the launches that link each device operation to its operator."""
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from simbench import devtrace, spantrace  # noqa: E402

MS = 1_000_000
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
P = "repro_torch."
THREAD = 7

# (name, start, end) of the program's spans on the host
SPANS = [
    (P + "sweep.run", 1 * MS, 99 * MS),
    (P + "sweep.bucket", 1 * MS, 2 * MS),
    (P + "pass.prepare", 2 * MS, 13 * MS),
    (P + "pass.stack", 2 * MS, 9 * MS),
    (P + "pass.upload", 9 * MS, 12 * MS),
    (P + "pass.state", 12 * MS, 13 * MS),
    (P + "pass.rounds", 14 * MS, 30 * MS),
    (P + "pass.round", 14 * MS, 22 * MS),
    (P + "round.l1", 14 * MS, 18 * MS),
    (P + "round.fill", 18 * MS, 22 * MS),
    (P + "pass.round", 22 * MS, 30 * MS),
    (P + "round.l1", 22 * MS, 26 * MS),
    (P + "round.fill", 26 * MS, 30 * MS),
    (P + "pass.finish", 31 * MS, 98 * MS),
    (P + "pass.wait", 31 * MS, 40 * MS),
    (P + "pass.readback", 40 * MS, 43 * MS),
    (P + "pass.fold", 43 * MS, 70 * MS),
    (P + "pass.summarize", 70 * MS, 98 * MS),
]
# (name, start, end, launch time on the host) of the device operations
DEVICE = [
    ("Memcpy HtoD (Pageable -> Device)", 10 * MS, 12 * MS, 10 * MS),
    ("fill_kernel", 13 * MS, 14 * MS, 12 * MS + MS // 2),
    ("ata_probe_rank_kernel<true>", 20 * MS, 24 * MS, 15 * MS),
    ("gather", 23 * MS, 30 * MS, 19 * MS),
    ("ata_probe_rank_kernel<true>", 32 * MS, 36 * MS, 23 * MS),
    ("Memcpy DtoD (Device -> Device)", 36 * MS, 40 * MS, 27 * MS),
    ("Memcpy DtoH (Device -> Pageable)", 41 * MS, 42 * MS, 41 * MS),
]
HOST = [("aten::where", 30 * MS, 33 * MS), ("aten::add", 50 * MS, 60 * MS)]


class Event:
    def __init__(self, name, device, start, end, thread=THREAD, corr=0,
                 linked=0):
        self._v = (name, device, start, end - start, thread, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]


def events(spans=True, mirrors=False):
    """The made-up profile's events: the window, the host operators, one
    launching operator per device operation, and the device operations;
    with ``spans`` the program's host spans, with ``mirrors`` a device
    mirror of each (what a user annotation would add)."""
    out = [Event(devtrace.WINDOW, CPU, 0, 100 * MS),
           Event(devtrace.WINDOW, CUDA, 10 * MS, 42 * MS)]
    out += [Event(n, CPU, s, e, corr=100 + i)
            for i, (n, s, e) in enumerate(HOST)]
    for i, (n, s, e, t) in enumerate(DEVICE):
        out.append(Event("cudaLaunchKernel", CPU, t, t + 1000,
                         corr=200 + i))
        out.append(Event(n, CUDA, s, e, linked=200 + i))
    if spans:
        out += [Event(n, CPU, s, e, corr=300 + i)
                for i, (n, s, e) in enumerate(SPANS)]
    if mirrors:
        out += [Event(n, CUDA, s + MS // 2, e - MS // 2)
                for n, s, e in SPANS if "round." in n]
    return out


def profile_of(evs):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))


def capture(evs):
    return devtrace.capture(profile_of(evs), {"rounds": 2, "points": 1})


def test_the_programs_spans_leave_the_capture_as_it_was():
    without, with_spans = capture(events(spans=False)), capture(events())
    assert with_spans.device == without.device
    assert with_spans.host == without.host
    assert with_spans.window == without.window
    assert [n for n, _, _ in without.device] == [d[0] for d in DEVICE]


def test_spans_are_read_and_mirrors_are_no_operations():
    sp = spantrace.spans_of(events(mirrors=True), THREAD)
    assert sorted(sp.host) == sorted(SPANS)
    assert [o[0] for o in sp.ops] == [d[0] for d in DEVICE]
    assert [o[3] for o in sp.ops] == [d[3] for d in DEVICE]
    assert sp.parent[:3] == [-1, 0, 0]      # run, bucket, prepare


@pytest.mark.parametrize("t,name", [
    (0, None), (5 * MS, "pass.stack"), (13 * MS + 1, "sweep.run"),
    (15 * MS, "round.l1"), (26 * MS, "round.fill"), (30 * MS, "sweep.run"),
    (45 * MS, "pass.fold"), (99 * MS, None)])
def test_innermost_span(t, name):
    sp = spantrace.nest(SPANS)
    got = spantrace.innermost(sp, t)
    assert got == (None if name is None else P + name)


def test_readings_of_known_numbers():
    sp = spantrace.spans_of(events(), THREAD)
    report = SimpleNamespace(upload_bytes=2_295_000_000,
                             readback_bytes=460_000_000)
    assert spantrace.readings(sp, report) == pytest.approx({
        "sweep_prepare_ms": 1 + 11, "sweep_finish_ms": 67 - 9,
        "upload_mb_per_sweep": 2295.0, "readback_mb_per_sweep": 460.0})
    # the parent's program: no spans, no counters, nothing read
    assert spantrace.readings(spantrace.nest([]), SimpleNamespace()) == {}


def test_stage_device_time_per_round():
    sp = spantrace.spans_of(events(), THREAD)
    assert spantrace.stage_ms_per_round(sp, 2) == pytest.approx(
        {"l1": (4 + 4) / 2, "fill": (7 + 4) / 2})


def test_breakdown_without_spans_reads_as_devtrace():
    evs = events(spans=False)
    cap = capture(evs)
    assert spantrace.breakdown(cap, spantrace.spans_of(evs, THREAD)) == \
        devtrace.breakdown(cap)


def test_breakdown_names_gaps_and_operations_by_span():
    evs = events()
    cap = capture(evs)
    b = spantrace.breakdown(cap, spantrace.spans_of(evs, THREAD), top=20)
    ops = dict(b["device_ops"])
    assert ops["round.fill · Memcpy DtoD (Device -> Device)"] == \
        pytest.approx(0.004)
    assert ops["round.fill · gather"] == pytest.approx(0.007)
    assert ops["round.l1 · ata_probe_rank_kernel<true>"] == \
        pytest.approx(0.008)
    assert ops["Memcpy HtoD (Pageable -> Device)"] == pytest.approx(0.002)
    # the gaps outside the rounds cut at the spans' boundaries: 0-10 ms,
    # 12-13, 40-41 and 42-100; inside them, 14-20 and 30-32 as before
    assert dict(b["idle_gaps"]) == pytest.approx({
        "host before the rounds (stacking, upload, set-up)": 0.001,
        "sweep.bucket": 0.001, "pass.stack": 0.007, "pass.upload": 0.001,
        "pass.state": 0.001, "Python between torch ops": 0.006,
        "aten::where": 0.002, "pass.readback": 0.002, "pass.fold": 0.027,
        "pass.summarize": 0.028, "sweep.run": 0.001,
        "host after the rounds (read-back, fold, summaries)": 0.001})


def test_the_command_reads_a_tiny_sweep_on_the_cpu(tmp_path):
    """``spantrace.py`` end to end on a tiny cell of a copy of the
    benchmark: the cell's set-up, one profiled sweep, and its line."""
    import json
    import os
    import subprocess
    import sys

    from simbench.tests.test_simbench_harness import tiny_copy
    checkout = tiny_copy(tmp_path)
    proc = subprocess.run(
        [sys.executable, "simbench/spantrace.py", "--workload", "ata.tiny",
         "--seed", "3000000019", "--rounds", "8", "--device", "cpu"],
        cwd=checkout, env=dict(os.environ, PYTHONPATH=""),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (line["points"], line["rounds"]) == (168, 8)
    counts = {k[len(P):]: v for k, v in line["span_counts"].items()}
    passes = counts["pass.prepare"]
    assert counts["sweep.run"] == counts["sweep.bucket"] == 1
    assert counts["pass.stack"] == counts["pass.upload"] == 4 * passes
    assert counts["pass.round"] == 8 * passes
    for stage in ("l1", "l2", "fill", "noc", "timing", "stats"):
        assert counts[f"round.{stage}"] == counts["pass.round"], stage
    walls, readings = line["span_walls_ms"], line["readings"]
    assert readings["sweep_prepare_ms"] == pytest.approx(
        walls["sweep.bucket"] + walls["pass.prepare"])
    assert readings["sweep_finish_ms"] == pytest.approx(
        walls["pass.finish"] - walls["pass.wait"])
    report = line["report"]
    assert report["n_points"] == 168
    assert readings["upload_mb_per_sweep"] == report["upload_bytes"] / 1e6
    assert readings["readback_mb_per_sweep"] == \
        report["readback_bytes"] / 1e6
    # the tiny copy's metric, read from the same capture as the spans
    assert line["per_layer"]["window_ms"] > 0
    # the CPU has no device events: no mirrors and no stage time
    assert line["device_mirrors"] == 0 and line["stage_ms_per_round"] == {}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
