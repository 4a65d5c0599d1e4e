"""Port parity: telemetry in the simulator and the sweep grid
(``repro_torch.core.telemetry``, ``simulate(telemetry=)``,
``SweepGrid.run(telemetry=)``).

* the counter registries and ``TelemetryConfig``'s validation equal the
  reference's;
* ``log2_bucket`` equals the reference's bucket on every float32 within
  4096 ulps of each of its thresholds and of each power of two, on 10**6
  random values, and on 0, subnormals, negatives and values past 2**31;
* the histogram reads equal the reference's and ``np.percentile``;
* ``simulate(telemetry=)`` for ``private``, ``ata``, ``ciao`` and
  ``victim`` under ``ideal`` and ``crossbar``: the result bit-equal to
  the run without telemetry, every cumulative array equal to the
  reference ``SimTimeline``'s, conservation, re-binning, bad windows;
* the per-app latency sum's window snapshots equal the reference's
  float32 carry past 2**20;
* ``SweepGrid.run(telemetry=)``: one timeline per point, in point order,
  each equal to the point's own capture and the reference's;
* dispatch: a round with telemetry dispatches the ops of a round without
  it plus the histogram's, and snapshots copy only at window ends.

Telemetry counters have zero tolerance.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.core import APPS as REF_APPS  # noqa: E402
from repro.core import make_trace as ref_make_trace  # noqa: E402
from repro.core import simulate as ref_simulate  # noqa: E402
from repro.core import telemetry as rtel  # noqa: E402
from repro_torch.core import (APPS, SweepGrid, TelemetryConfig,  # noqa: E402
                              make_trace, simulate)
from repro_torch.core import simulator as psim  # noqa: E402
from repro_torch.core import telemetry as ptel  # noqa: E402
from repro_torch.obs import ConservationError  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROUNDS, WINDOW = 96, 32


def _port_trace(rounds=ROUNDS, kernel=0, app="cfd"):
    return make_trace(dataclasses.replace(APPS[app], rounds=rounds),
                      kernel=kernel)


def _ref_trace(rounds=ROUNDS, kernel=0, app="cfd"):
    return ref_make_trace(dataclasses.replace(REF_APPS[app], rounds=rounds),
                          kernel=kernel)


def assert_timelines_equal(got, want):
    """Same window, rounds and counters; every cumulative array of the
    same dtype and shape, equal element for element."""
    assert (got.window, got.rounds) == (want.window, want.rounds)
    assert got.counter_names == want.counter_names
    for name in want.counter_names:
        g, w = got.cumulative[name], want.cumulative[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


# ---------------------------------------------------------------------------
# registry and config
# ---------------------------------------------------------------------------
def test_counter_registries_equal_the_reference():
    for port, ref in ((ptel.SIM_COUNTERS, rtel.SIM_COUNTERS),
                      (ptel.SERVE_COUNTERS, rtel.SERVE_COUNTERS)):
        assert [dataclasses.astuple(c) for c in port] == \
            [dataclasses.astuple(c) for c in ref]
        assert [f.name for f in dataclasses.fields(port[0])] == \
            [f.name for f in dataclasses.fields(ref[0])]


@pytest.mark.parametrize("kwargs", [dict(window=0), dict(sim_hist_bins=1),
                                    dict(window=-3)])
def test_config_validation_raises_the_reference_errors(kwargs):
    with pytest.raises(ValueError) as want:
        rtel.TelemetryConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        TelemetryConfig(**kwargs)
    assert str(got.value) == str(want.value)


def test_window_for_suggests_the_reference_divisor():
    for window, rounds in ((40, 96), (7, 100), (32, 96), (5, 5)):
        ref, port = rtel.TelemetryConfig(window=window), \
            TelemetryConfig(window=window)
        try:
            want = ref.window_for(rounds)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                port.window_for(rounds)
            assert str(got.value) == str(e)
        else:
            assert port.window_for(rounds) == want
    assert hash(TelemetryConfig()) == hash(TelemetryConfig(window=32))


# ---------------------------------------------------------------------------
# log2_bucket: the reference's step function over float32
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_bucket():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def of_bits(bits, bins):
        return rtel.log2_bucket(
            jax.lax.bitcast_convert_type(bits, jnp.float32), bins)

    def bucket(x: np.ndarray, bins: int) -> np.ndarray:
        x = np.ascontiguousarray(x, np.float32)
        return np.asarray(of_bits(x.view(np.int32), bins))
    return bucket


def _port_bucket(x: np.ndarray, bins: int) -> np.ndarray:
    return ptel.log2_bucket(torch.from_numpy(
        np.ascontiguousarray(x, np.float32)), bins).numpy()


def _ulp_windows(centers: np.ndarray, half: int = 4096) -> np.ndarray:
    """Every float32 within ``half`` ulps of each positive center (finite
    values only)."""
    bits = centers.astype(np.float32).view(np.int32).astype(np.int64)
    w = (bits[:, None] + np.arange(-half, half + 1)[None, :]).ravel()
    w = w[(w >= 0) & (w <= np.float32(np.finfo(np.float32).max)
                      .view(np.int32))]
    return np.unique(w).astype(np.int32).view(np.float32)


def test_threshold_table_is_the_reference_step_function(ref_bucket):
    thr = ptel.LOG2_THRESHOLDS
    assert thr.dtype == np.float32 and thr.size == 128
    assert np.all(np.diff(thr) > 0)
    # the reference quirks the table reproduces
    assert thr[2] == np.float32(7.9999995) and thr[12] > 8192.0
    big = 1 << 20
    np.testing.assert_array_equal(ref_bucket(thr, big), np.arange(1, 129))
    below = np.nextafter(thr, np.float32(0))
    np.testing.assert_array_equal(ref_bucket(below, big), np.arange(128))


@pytest.mark.parametrize("bins", [32, 2, 200])
def test_log2_bucket_equals_reference_around_every_edge(ref_bucket, bins):
    powers = np.ldexp(np.float32(1), np.arange(-149, 128)).astype(np.float32)
    x = _ulp_windows(np.concatenate([ptel.LOG2_THRESHOLDS, powers]))
    np.testing.assert_array_equal(_port_bucket(x, bins), ref_bucket(x, bins))


def test_log2_bucket_equals_reference_on_random_and_odd_values(ref_bucket):
    rng = np.random.default_rng(7)
    # 10**6 values: random finite bit patterns and latency-like values
    bits = rng.integers(0, 0x7f800000, 500_000, dtype=np.int64)
    lat = rng.exponential(60.0, 500_000) * rng.choice([1, 16, 4096], 500_000)
    odd = np.array([0.0, -0.0, -1.0, -1e30, 1e-45, 1e-40, 1.17e-38, 0.5,
                    0.99999994, 1.0, 1.0000001, 2 ** 31, 2 ** 31 + 256,
                    2 ** 32, 3.0e9, 1e12, 1e38,
                    float(np.finfo(np.float32).max)])
    x = np.concatenate([bits.astype(np.int32).view(np.float32), lat, odd]
                       ).astype(np.float32)
    for bins in (32, 64):
        np.testing.assert_array_equal(_port_bucket(x, bins),
                                      ref_bucket(x, bins))


# ---------------------------------------------------------------------------
# histogram reads
# ---------------------------------------------------------------------------
def test_hist_quantile_reads_equal_reference_and_numpy():
    rng = np.random.default_rng(3)
    for trial in range(60):
        nb = int(rng.integers(1, 90))
        counts = rng.integers(0, 5, nb) * (rng.random(nb) < 0.6)
        if trial % 7 == 0:
            counts[:] = 0
        values = np.repeat(np.arange(nb), counts)
        for q in (0.0, 1.0, 25.0, 50.0, 90.0, 99.0, 99.9, 100.0):
            got = ptel.hist_quantile(counts, q)
            assert got == rtel.hist_quantile(counts, q)
            if values.size:
                assert got == float(np.percentile(values, q))
            assert ptel.hist_quantile_edges(counts, q) == \
                rtel.hist_quantile_edges(counts, q)
    np.testing.assert_array_equal(ptel.log2_edges(32), rtel.log2_edges(32))
    assert ptel.serving_hist_bins(726.0) == rtel.serving_hist_bins(726.0)


# ---------------------------------------------------------------------------
# simulate(telemetry=)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("noc", ["ideal", "crossbar"])
@pytest.mark.parametrize("arch", ["private", "ata", "ciao", "victim"])
def test_simulate_timeline_equals_reference(arch, noc):
    tc = TelemetryConfig(window=WINDOW)
    got_res, got = simulate(arch, _port_trace(), noc=noc, telemetry=tc,
                            device="cpu")
    assert tuple(got_res) == tuple(simulate(arch, _port_trace(), noc=noc,
                                            device="cpu"))
    want_res, want = ref_simulate(arch, _ref_trace(), noc=noc,
                                  telemetry=rtel.TelemetryConfig(WINDOW))
    assert_timelines_equal(got, want)
    assert got.meta == want.meta
    assert got.check(got_res) is got
    assert got.hist.sum() == sum(a.l1_lat_n for a in got_res.per_app)
    assert got.hist_percentile(99) == want.hist_percentile(99)
    if noc == "crossbar" and arch in ("ata", "victim"):
        assert got.total("noc.link_flits").sum() > 0


def test_rebin_equals_a_coarser_capture_and_bad_windows_raise():
    trace = _port_trace()
    res, fine = simulate("ata", trace, noc="crossbar",
                         telemetry=TelemetryConfig(window=16), device="cpu")
    _, coarse = simulate("ata", trace, noc="crossbar",
                         telemetry=TelemetryConfig(window=48), device="cpu")
    assert_timelines_equal(fine.rebin(3), coarse)
    coarse.check(res)
    with pytest.raises(ValueError, match="must divide the window count"):
        fine.rebin(4)
    with pytest.raises(ValueError, match=r"must divide the run length 96 "
                                         r"\(nearest divisor: 32\)"):
        simulate("ata", trace, telemetry=TelemetryConfig(window=40),
                 device="cpu")
    # a tampered total breaks conservation
    fine.cumulative["l2_accesses"][-1] += 1.0
    with pytest.raises(ConservationError, match="l2_accesses"):
        fine.check(res)


def test_app_latency_window_snapshots_equal_reference_carry():
    """The reference snapshots its float32 per-app carry at each window
    end; past 2**20 only the running sum at that point reproduces it
    (summing each window apart and adding up would round otherwise)."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    T, C, W = 320, 30, 32
    vals = (rng.integers(0, 12800, (T, 1, C)) / 16).astype(np.float32)
    vals[rng.random((T, 1, C)) < 0.3] = 0.0
    core_app = np.zeros((1, C), np.int64)
    core_app[0, ::3] = 1
    step = jax.jit(lambda acc, v: acc.at[jnp.asarray(core_app[0])].add(v))
    acc, want = jnp.zeros((2,), jnp.float32), []
    for t in range(T):
        acc = step(acc, jnp.asarray(vals[t, 0]))
        if (t + 1) % W == 0:
            want.append(np.asarray(acc))
    want = np.stack(want)
    got = psim._fold_app_lat(vals, core_app, 2, W)[:, 0]
    assert want.max() > 2 ** 20
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(psim._fold_app_lat(vals, core_app, 2)[0],
                                  want[-1])
    per_window = np.cumsum(np.stack([
        np.array([vals[w * W:(w + 1) * W, 0][:, core_app[0] == a].sum()
                  for a in range(2)], np.float32)
        for w in range(T // W)]), axis=0, dtype=np.float32)
    assert not np.array_equal(per_window, want)   # the order matters here


# ---------------------------------------------------------------------------
# SweepGrid.run(telemetry=)
# ---------------------------------------------------------------------------
def test_sweep_timelines_follow_points_and_equal_per_point_captures():
    """One stacked pass (ata and victim x ideal and crossbar, two
    kernels): each point's timeline equals its own capture and the
    reference's per-point ``simulate(telemetry=)``; the ideal points'
    link lanes are their own model's (none), not the pass's."""
    tc = TelemetryConfig(window=WINDOW)
    traces = [_port_trace(kernel=k) for k in (0, 1)]
    grid = SweepGrid(("victim", "ata"), None, traces,
                     nocs=("crossbar", "ideal"))
    run = grid.run(telemetry=tc, device="cpu")
    assert run.report.n_executables == 1
    assert len(run.timelines) == len(grid.points) == 8
    plain = grid.run(device="cpu")
    assert plain.timelines is None
    ref_traces = [_ref_trace(kernel=k) for k in (0, 1)]
    for p, r, tl, r0 in zip(grid.points, run.results, run.timelines,
                            plain.results):
        assert tuple(r) == tuple(r0)
        assert (tl.meta["arch"], tl.meta["noc"]) == (p.arch, p.noc)
        k = next(i for i, t in enumerate(traces) if t is p.trace)
        own_res, own = simulate(p.arch, p.trace, noc=p.noc, telemetry=tc,
                                device="cpu")
        assert tuple(own_res) == tuple(r)
        assert_timelines_equal(tl, own)
        _, want = ref_simulate(p.arch, ref_traces[k], noc=p.noc,
                               telemetry=rtel.TelemetryConfig(WINDOW))
        assert_timelines_equal(tl, want)
        tl.check(r)
    with pytest.raises(ValueError, match="must divide the run length"):
        grid.run(telemetry=TelemetryConfig(window=64), device="cpu")


def test_noc_family_pass_timelines_equal_reference():
    """A NoC pass of one architecture over ideal, crossbar and ring."""
    tc = TelemetryConfig(window=48)
    trace = _port_trace(app="HS3D")
    grid = SweepGrid(("ata",), None, [trace],
                     nocs=("ring", "ideal", "crossbar"))
    run = grid.run(telemetry=tc, device="cpu")
    for p, r, tl in zip(grid.points, run.results, run.timelines):
        _, want = ref_simulate("ata", _ref_trace(app="HS3D"), noc=p.noc,
                               telemetry=rtel.TelemetryConfig(48))
        assert_timelines_equal(tl, want)
        tl.check(r)


# ---------------------------------------------------------------------------
# dispatch: what telemetry adds to the round loop
# ---------------------------------------------------------------------------
class _OpRecorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


HISTOGRAM_OPS = ["aten.bucketize.Tensor", "aten._to_copy.default",
                 "aten.scatter_add_.default"]


@pytest.mark.parametrize("arch,noc", [("ata", "ideal"), ("victim", "ring")])
def test_telemetry_adds_only_histogram_ops_and_window_end_copies(
        arch, noc, monkeypatch):
    plain_round, plain_snapshot = psim._round, psim._snapshot

    def recorded(telemetry):
        rounds, snapshots, rec = [0], [], _OpRecorder()

        def round_(*args, **kwargs):
            rounds[0] += 1
            if rounds[0] != 6:
                return plain_round(*args, **kwargs)
            with rec:
                return plain_round(*args, **kwargs)

        def snapshot(*args):
            snap_rec = _OpRecorder()
            with snap_rec:
                plain_snapshot(*args)
            snapshots.append((rounds[0], snap_rec.ops))

        monkeypatch.setattr(psim, "_round", round_)
        monkeypatch.setattr(psim, "_snapshot", snapshot)
        simulate(arch, _port_trace(rounds=48), noc=noc, telemetry=telemetry,
                 device="cpu")
        return rec.ops, snapshots

    off, no_snaps = recorded(None)
    on, snaps = recorded(TelemetryConfig(window=16))
    assert no_snaps == []
    assert on == off + HISTOGRAM_OPS
    assert [r for r, _ in snaps] == [16, 32, 48]
    for _, ops in snaps:
        # the 13 stats (lat_hist included) and the 7 NoC state tensors,
        # each copied into its window's row of the buffer
        assert ops == ["aten.select.int", "aten.copy_.default"] * 20
    nohist, _ = recorded(TelemetryConfig(window=16, histograms=False))
    assert nohist == off
