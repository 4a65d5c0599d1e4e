"""The sweep's host spans and copy counters (``repro_torch.core.telemetry.
span``, ``SWEEP_SPANS``; ``SweepReport.upload_bytes``,
``readback_bytes``) on a tiny grid on the CPU: 2 traces x 2 geometries at
8 rounds.

* under a ``torch.profiler`` profile a sweep opens only the registered
  spans, nested as the registry says;
* with no profile it never opens a profiler range, and its results do
  not depend on whether one records;
* the counters equal their formulas from the traces' shapes, and a
  split over two devices doubles the passes and keeps the requests and
  the bytes;
* a torch without the profiler range the spans open fails at the first
  profiled span, with a message that names it, and ``chip_smoke``'s
  kernel table skips the program's spans.
"""
import dataclasses
import importlib.util
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core import (PAPER_GEOMETRY, SweepGrid,  # noqa: E402
                              app_traces)
from repro_torch.core import telemetry as ptel  # noqa: E402
from repro_torch.core.geometry import GEOM_SCALAR_FIELDS  # noqa: E402

ROUNDS = 8
P = "repro_torch."


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny tensors: one intra-op thread keeps the xdist workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grid():
    traces = app_traces("cfd", rounds=ROUNDS)[:2]
    geoms = [PAPER_GEOMETRY, dataclasses.replace(PAPER_GEOMETRY, svc_l2=4.0)]
    return SweepGrid(["ata"], geoms, traces)


def profiled(fn):
    """``fn()``'s result and the program's spans it opened, as (name,
    start_ns, end_ns) sorted by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((ev.name(), ev.start_ns(),
                     ev.start_ns() + ev.duration_ns())
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name().startswith(P)), key=lambda s: s[1])
    return out, spans


def within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def passes(spans):
    """The number of passes a sweep ran: one ``pass.prepare`` each."""
    return sum(n == P + "pass.prepare" for n, _, _ in spans)


@pytest.fixture(scope="module")
def traced(grid):
    return profiled(lambda: grid.run(device="cpu"))


def test_a_profiled_sweep_opens_the_registered_spans_nested(traced):
    run, spans = traced
    names = Counter(n for n, _, _ in spans)
    assert set(names) <= set(ptel.SWEEP_SPANS)
    assert all(n.startswith(ptel.SPAN_PREFIX) for n in ptel.SWEEP_SPANS)
    assert names[P + "sweep.run"] == 1
    assert passes(spans) == 1
    assert names[P + "pass.round"] == ROUNDS * passes(spans)
    rounds = [s for s in spans if s[0] == P + "pass.round"]
    stages = [s for s in spans if s[0].startswith(P + "round.")]
    assert len(stages) == 6 * len(rounds)
    assert all(any(within(s, r) for r in rounds) for s in stages)
    (whole,) = [s for s in spans if s[0] == P + "sweep.run"]
    assert all(within(s, whole) for s in spans)
    first = {}
    last = {}
    for n, s, e in spans:
        first.setdefault(n, s)
        last[n] = e
    assert last[P + "pass.prepare"] <= first[P + "pass.rounds"]
    assert last[P + "pass.rounds"] <= first[P + "pass.finish"]
    # trace arrays, each stacked and then uploaded
    assert names[P + "pass.stack"] == names[P + "pass.upload"] == 4
    for child, parent in (("pass.stack", "pass.prepare"),
                          ("pass.upload", "pass.prepare"),
                          ("pass.state", "pass.prepare"),
                          ("pass.wait", "pass.finish"),
                          ("pass.readback", "pass.finish"),
                          ("pass.fold", "pass.finish"),
                          ("pass.summarize", "pass.finish")):
        (p,) = [s for s in spans if s[0] == P + parent]
        assert all(within(c, p) for c in spans if c[0] == P + child), child


def test_telemetry_adds_the_timelines_span(grid):
    _, spans = profiled(lambda: grid.run(
        device="cpu", telemetry=ptel.TelemetryConfig(window=4)))
    names = Counter(n for n, _, _ in spans)
    assert names[P + "pass.timelines"] == 1
    assert set(names) <= set(ptel.SWEEP_SPANS)


def test_no_profiler_opens_no_range(grid, monkeypatch):
    assert ptel.span("sweep.run") is ptel.span("pass.round")

    def refuse(*a, **k):
        raise AssertionError("a profiler range opened with no profiler")

    monkeypatch.setattr(ptel, "_RANGE", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert grid.run(device="cpu").report.n_points == 4


def test_results_do_not_depend_on_the_profiler(grid, traced):
    assert grid.run(device="cpu").results == traced[0].results


def test_counters_equal_their_formulas(grid):
    report = grid.run(device="cpu").report
    traces = [p.trace for p in grid.points]
    T, C, m = traces[0].addr.shape
    n_apps = traces[0].n_apps
    n = len(traces)
    # addr, is_write, insn_per_req as float32, core-app ids as int64,
    # and a column of the geometry table
    per_point = (traces[0].addr.nbytes + traces[0].is_write.nbytes
                 + 4 * np.size(traces[0].insn_per_req) + 8 * C
                 + 4 * len(GEOM_SCALAR_FIELDS))
    assert report.upload_bytes == n * per_point
    # stats: 8 per-point floats, per-core cycles, 3 per-app counters;
    # served latencies (T, C); the ideal NoC's 4 scalars and no links
    assert report.readback_bytes == n * 4 * (8 + C + 3 * n_apps + T * C
                                             + 4)


def test_a_split_doubles_the_passes_and_keeps_the_requests(grid):
    one, one_spans = profiled(lambda: grid.run(device="cpu"))
    two, two_spans = profiled(lambda: grid.run(devices=["cpu", "cpu"]))
    assert two.report.n_devices == 2
    assert passes(two_spans) == 2 * passes(one_spans)
    T, C, m = grid.points[0].trace.addr.shape
    assert ([sum(a.requests for a in r.per_app) for r in two.results]
            == [T * C * m] * len(grid.points))
    assert two.results == one.results
    assert ((two.report.upload_bytes, two.report.readback_bytes)
            == (one.report.upload_bytes, one.report.readback_bytes))


def test_a_torch_without_the_range_fails_at_the_first_profiled_span(
        monkeypatch):
    monkeypatch.setattr(ptel, "_RANGE", None)
    assert ptel.span("sweep.run") is ptel.span("pass.round")
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="_RecordFunctionFast"):
            ptel.span("sweep.run")


def test_chip_smoke_kernel_table_skips_the_programs_spans():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cuda = torch.autograd.DeviceType.CUDA

    class Avg:
        def __init__(self, key, us, device_type=cuda):
            self.key, self.self_device_time_total = key, us
            self.count, self.device_type = 3, device_type

    class Prof:
        def key_averages(self):
            return [Avg("gather", 5.0), Avg(P + "round.l1", 7.0),
                    Avg("aten::add", 2.0, torch.autograd.DeviceType.CPU)]

    assert smoke.device_kernels(Prof()) == [(5.0, 3, "gather")]
