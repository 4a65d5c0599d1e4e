"""Port parity: the serving engine's telemetry and the exporters
(``serve_stream(telemetry=)``, ``repro_torch.obs``).

* ``serve_stream(telemetry=)`` for ``private``, ``ata`` and
  ``broadcast`` at B in {1, 4}: the ``ServeResult`` equal to the replay
  without telemetry and to the reference's (``lat_hist`` and
  ``hist_exact`` included), the ``ServeTimeline`` equal to the
  reference's (a ragged final window included), conservation, and a
  tampered total raising ``ConservationError``; fractional costs give
  ``hist_exact`` False;
* Perfetto: ``trace_events`` of both timeline kinds equal the
  reference's, ``validate_trace`` accepts and rejects what the
  reference's does, and the committed
  ``benchmarks/baselines/telemetry_smoke_trace.json`` regenerates from
  the port event for event;
* manifests and the capture: ``run_manifest``'s keys,
  ``python -m repro_torch.launch.telemetry_capture`` writing its files
  on the CPU, and ``repro_torch.obs`` importing without JAX.

Telemetry counters have zero tolerance.
"""
import copy
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import APPS as REF_APPS  # noqa: E402
from repro.core import make_trace as ref_make_trace  # noqa: E402
from repro.core import simulate as ref_simulate  # noqa: E402
from repro.core.telemetry import TelemetryConfig as RefTelemetry  # noqa: E402
from repro.core.trace.serving import ServingMix as RefMix  # noqa: E402
from repro.obs import perfetto as rperf  # noqa: E402
from repro.serving import ServingConfig as RefConfig  # noqa: E402
from repro.serving import serve_stream as ref_serve  # noqa: E402
from repro_torch.core import (APPS, TelemetryConfig, make_trace,  # noqa: E402
                              simulate)
from repro_torch.core.trace.serving import ServingMix  # noqa: E402
from repro_torch.obs import (ConservationError, run_manifest,  # noqa: E402
                             trace_events, validate_trace, write_trace)
from repro_torch.serving import ServingConfig, serve_stream  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SMOKE_TRACE = os.path.join(ROOT, "benchmarks", "baselines",
                           "telemetry_smoke_trace.json")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: 40 admission rounds at each B, window 16: a ragged last window of 8
ROUNDS, WINDOW = 40, 16


def _streams(b: int):
    kw = dict(n_shards=4, rounds=ROUNDS * b, seed=1)
    return (ServingMix(("chat", "batch")).make_stream(**kw).batched(b),
            RefMix(("chat", "batch")).make_stream(**kw).batched(b))


def assert_serve_results_equal(got, want):
    assert got._fields == want._fields
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, (f, g, w)


def assert_timelines_equal(got, want):
    assert (got.window, got.rounds, got.meta) == \
        (want.window, want.rounds, want.meta)
    assert got.counter_names == want.counter_names
    for name in want.counter_names:
        g, w = got.cumulative[name], want.cumulative[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got.hist is None) == (want.hist is None)
    if want.hist is not None:
        assert got.hist.dtype == want.hist.dtype
        np.testing.assert_array_equal(got.hist, want.hist)
    assert got.hist_exact == want.hist_exact


@pytest.fixture(scope="module")
def captures():
    """{(policy, B): (port result, port timeline, reference result,
    reference timeline, port result without telemetry)}."""
    out = {}
    for b in (1, 4):
        stream, ref_stream = _streams(b)
        for policy in ("private", "ata", "broadcast"):
            res, tl = serve_stream(policy, stream, ServingConfig(),
                                   telemetry=TelemetryConfig(window=WINDOW),
                                   device="cpu")
            want_res, want_tl = ref_serve(
                policy, ref_stream, RefConfig(),
                telemetry=RefTelemetry(window=WINDOW))
            plain = serve_stream(policy, stream, ServingConfig(),
                                 device="cpu")
            out[(policy, b)] = (res, tl, want_res, want_tl, plain)
    return out


# ---------------------------------------------------------------------------
# serve_stream(telemetry=)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("policy", ["private", "ata", "broadcast"])
def test_serving_telemetry_equals_reference(captures, policy, b):
    res, tl, want_res, want_tl, plain = captures[(policy, b)]
    assert_serve_results_equal(res, want_res)
    assert res.hist_exact and res.lat_hist is not None
    # the replay without telemetry: every field but the histogram's
    assert_serve_results_equal(
        res._replace(lat_hist=None, hist_exact=False), plain)
    assert_timelines_equal(tl, want_tl)
    assert tl.check(res) is tl
    for q in (50.0, 99.0, 99.9):
        assert res.latency_percentile(q) == \
            float(np.percentile(res.request_latencies, q))
        assert tl.hist_percentile(q) == res.latency_percentile(q)
    if policy == "broadcast":
        assert tl.total("probe_messages") == res.probe_messages > 0
        assert tl.series("probe_messages").min() >= 0


def test_ragged_last_window_and_rebin(captures):
    _, tl, _, want, _ = captures[("ata", 1)]
    assert tl.rounds == ROUNDS and tl.n_windows == 3     # 16 + 16 + 8
    assert tl.series("admitted").sum() == want.total("admitted").sum()
    _, tl4, _, _, _ = captures[("ata", 4)]
    assert (tl4.rounds, tl4.window, tl4.n_windows) == (ROUNDS, WINDOW, 3)
    with pytest.raises(ValueError, match="must divide the window count"):
        tl.rebin(2)


@pytest.mark.parametrize("counter", ["admitted", "probe_messages",
                                     "latency_sum", "tenant_blocks"])
def test_tampered_total_raises_conservation_error(captures, counter):
    res, tl, _, _, _ = captures[("broadcast", 1)]
    bad = copy.deepcopy(tl)
    bad.cumulative[counter][-1] += 1
    with pytest.raises(ConservationError, match=counter):
        bad.check(res)
    bad = copy.deepcopy(tl)
    bad.hist[0] += 1
    with pytest.raises(ConservationError, match="lat_hist"):
        bad.check(res)


@pytest.mark.parametrize("cfg", [dict(noc="ring"), dict(lat_fetch=4.5)])
def test_fractional_costs_give_an_inexact_histogram(cfg):
    stream, ref_stream = _streams(2)
    res, tl = serve_stream("ata", stream, ServingConfig(**cfg),
                           telemetry=TelemetryConfig(window=WINDOW),
                           device="cpu")
    want_res, want_tl = ref_serve("ata", ref_stream, RefConfig(**cfg),
                                  telemetry=RefTelemetry(window=WINDOW))
    assert not res.hist_exact and not tl.hist_exact
    assert_serve_results_equal(res, want_res)
    assert_timelines_equal(tl, want_tl)
    assert res.latency_percentile(99) == \
        float(np.percentile(res.request_latencies, 99))
    tl.check(res)


def test_histograms_off_keeps_the_timeline():
    stream, _ = _streams(1)
    res, tl = serve_stream("ata", stream, ServingConfig(),
                           telemetry=TelemetryConfig(window=WINDOW,
                                                     histograms=False),
                           device="cpu")
    assert res.lat_hist is None and not res.hist_exact and tl.hist is None
    tl.check(res)


# ---------------------------------------------------------------------------
# Perfetto export
# ---------------------------------------------------------------------------
def test_serve_trace_events_equal_reference(captures):
    for res, tl, _, want_tl, _ in captures.values():
        got = trace_events(tl)
        validate_trace(got)
        assert json.dumps(got) == json.dumps(rperf.trace_events(want_tl))


@pytest.mark.parametrize("noc", ["ideal", "crossbar", "ring"])
def test_sim_trace_events_equal_reference(noc):
    tc = TelemetryConfig(window=32)
    _, tl = simulate("ata", make_trace(dataclasses.replace(
        APPS["cfd"], rounds=96), kernel=0), noc=noc, telemetry=tc,
        device="cpu")
    _, want = ref_simulate("ata", ref_make_trace(dataclasses.replace(
        REF_APPS["cfd"], rounds=96), kernel=0), noc=noc,
        telemetry=RefTelemetry(window=32))
    got = trace_events(tl)
    assert json.dumps(got) == json.dumps(rperf.trace_events(want))
    phases = {e["ph"] for e in got["traceEvents"]}
    assert phases == {"M", "C", "X"}
    with pytest.raises(TypeError):
        trace_events(object())


def _malformed():
    good = {"traceEvents": [{"ph": "M", "name": "process_name", "pid": 1,
                             "args": {"name": "x"}}]}
    yield good
    yield {}
    yield {"traceEvents": []}
    yield {"traceEvents": ["not an event"]}
    yield {"traceEvents": [{"ph": "Q", "name": "x", "pid": 1}]}
    yield {"traceEvents": [{"ph": "X", "name": "x", "pid": 1, "tid": 0,
                            "ts": 0.0, "dur": -1.0}]}
    yield {"traceEvents": [{"ph": "X", "name": "x", "pid": 1, "ts": 0.0,
                            "dur": 1.0}]}
    yield {"traceEvents": [{"ph": "C", "name": "x", "pid": 1, "ts": 0.0,
                            "args": {"value": "high"}}]}
    yield {"traceEvents": [{"ph": "C", "name": 3, "pid": "1", "ts": 0.0,
                            "args": {}}]}
    yield {"traceEvents": [{"ph": "M", "name": "x", "pid": 1,
                            "args": {"v": object()}}]}


@pytest.mark.parametrize("obj", list(_malformed()))
def test_validate_trace_accepts_and_rejects_what_the_reference_does(obj):
    def verdict(fn):
        try:
            fn(obj)
        except ValueError as e:
            return str(e)
        return None
    assert verdict(validate_trace) == verdict(rperf.validate_trace)


def test_committed_smoke_trace_regenerates_event_for_event(tmp_path):
    """``ata``, chat+rag, 8 shards, 64 rounds, B=1, window 32: the trace
    is in model cycles, so the port must give it exactly."""
    with open(SMOKE_TRACE) as f:
        want = json.load(f)
    validate_trace(want)
    stream = ServingMix(("chat", "rag"), name="chat+rag").make_stream(
        n_shards=8, rounds=64, seed=0)
    res, tl = serve_stream("ata", stream, ServingConfig(),
                           telemetry=TelemetryConfig(window=32),
                           device="cpu")
    tl.check(res)
    got = json.loads(json.dumps(trace_events(tl)))
    assert len(got["traceEvents"]) == len(want["traceEvents"]) == 32
    assert got == want
    path = tmp_path / "trace.json"
    written = write_trace(str(path), tl, manifest={"git_sha": None})
    assert written["otherData"]["manifest"] == {"git_sha": None}
    assert json.loads(path.read_text())["traceEvents"] == want["traceEvents"]


# ---------------------------------------------------------------------------
# manifest and the capture
# ---------------------------------------------------------------------------
MANIFEST_KEYS = {"git_sha", "python", "platform", "argv", "timestamp",
                 "compile_counts", "torch_version", "cuda_version",
                 "backend", "device_count", "device_name", "power_limit",
                 "kernel_builds"}


def test_run_manifest_keys():
    from repro_torch.kernels import build
    man = run_manifest(phases={"a": 1.23456789}, extra={"note": "x"})
    assert MANIFEST_KEYS | {"phases_wall_s", "note"} == set(man)
    assert man["phases_wall_s"] == {"a": 1.234568}
    assert man["torch_version"] == torch.__version__
    assert set(man["compile_counts"]) == {"sweep"}
    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    assert sorted(man["kernel_builds"]) == sources == [
        "ata_probe_rank", "ata_tag_probe", "flash_attention", "wkv6"]
    for name, kb in man["kernel_builds"].items():
        assert kb["source_sha256_16"] == build.source_digest(name)
        assert kb["library"] == str(build.library_path(name))
        assert kb["built_by_this_process"] is False
    if not torch.cuda.is_available():
        assert man["backend"] == "cpu" and man["power_limit"] is None
    json.dumps(man)


def test_telemetry_capture_writes_every_artifact(tmp_path):
    from repro_torch.launch import telemetry_capture
    out = tmp_path / "cap"
    rc = telemetry_capture.main([str(out), "--device", "cpu", "--rounds",
                                 "64", "--json", str(tmp_path / "r.json")])
    assert rc == 0
    assert sorted(os.listdir(out)) == sorted([
        "sim_timeline.json", "sim_timeline.csv", "sim_trace.json",
        "serve_timeline.json", "serve_timeline.csv", "serve_trace.json",
        "manifest.json", "telemetry_report.json"])
    report = json.loads((out / "telemetry_report.json").read_text())
    assert report["kind"] == "telemetry" and report["schema"] == 1
    assert report["sim"]["n_windows"] == 2 and report["serving"]["hist_exact"]
    assert report == json.loads((tmp_path / "r.json").read_text())
    assert MANIFEST_KEYS <= set(report["manifest"])
    for name in ("sim_trace.json", "serve_trace.json"):
        validate_trace(json.loads((out / name).read_text()))
    sim = json.loads((out / "sim_timeline.json").read_text())
    assert sim["kind"] == "sim" and sim["n_windows"] == 2
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            telemetry_capture.capture(str(tmp_path / "x"))


def test_obs_imports_without_jax():
    code = ("import sys; import repro_torch.obs, repro_torch.core.telemetry,"
            " repro_torch.launch.telemetry_capture; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro'); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
