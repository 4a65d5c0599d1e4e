"""Opt-in telemetry: counter registry, windows, exact histograms.

The port of the reference's ``repro.core.telemetry``. The simulator's
round loop (``repro_torch.core.simulator``) and the serving engine
(``repro_torch.serving.engine``) fold every per-round signal — hits,
remote probes, per-app latency sums, NoC queue depth, link flits — into
their carried counters and keep only end-of-run totals. This module is
the shared vocabulary for *keeping* the time axis:

* :class:`TelemetryConfig` — a frozen, hashable config passed as the
  ``telemetry=`` argument of ``simulate`` / ``SweepGrid.run`` /
  ``serve_stream``. ``None`` (the default) dispatches exactly the ops of
  a run without telemetry. A config makes the runs additionally keep
  per-*window* cumulative counter snapshots (window-strided: memory is
  ``rounds/window x counters``, never ``rounds x counters``).
* :class:`Counter` + :data:`SIM_COUNTERS` / :data:`SERVE_COUNTERS` —
  the declarative registry naming every counter (unit, axis,
  description) and the carried field it rides in. The exporters
  (``repro_torch.obs``) iterate the registry instead of hard-coding
  field names.
* Exact latency histograms. The serving engine's cost model is integral
  by default, so its histogram is value-resolved (one bucket per modeled
  cycle) and quantiles reconstruct ``np.percentile`` **exactly**
  (:func:`hist_quantile` replicates numpy's linear interpolation bit for
  bit); the simulator's L1-complete latencies are fractional, so its
  histogram is log-2-bucketed (:func:`log2_bucket`) and quantile reads
  are exact at bucket granularity (:func:`hist_quantile_edges` returns
  the conservative upper edge).

The window contract: ``rounds % window == 0`` (checked with a
divisor-suggesting error). Snapshots are *cumulative*, so the final
snapshot equals the run total by construction and per-window deltas
telescope back to it exactly (the conservation guarantee
``repro_torch.obs.timeline`` checks).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "TelemetryConfig", "Counter", "SIM_COUNTERS", "SERVE_COUNTERS",
    "log2_bucket", "log2_edges", "hist_quantile", "hist_quantile_edges",
    "serving_hist_bins",
]


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Telemetry knob (frozen and hashable).

    ``window`` is the snapshot stride in *rounds* (simulator) or
    *admission rounds* (serving engine). ``histograms`` adds the
    latency-histogram counter to the carry; ``sim_hist_bins`` sizes the
    simulator's log-2 bucket array (bucket ``i`` covers about
    ``[2^i, 2^(i+1))`` cycles, bucket 0 also absorbs sub-cycle
    latencies, the last bucket absorbs overflow).
    """
    window: int = 32
    histograms: bool = True
    sim_hist_bins: int = 32

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.sim_hist_bins < 2:
            raise ValueError(
                f"sim_hist_bins must be >= 2, got {self.sim_hist_bins}")

    def window_for(self, rounds: int) -> int:
        """Validate the window against a run length and return it."""
        if rounds % self.window:
            divisors = [d for d in range(1, rounds + 1)
                        if rounds % d == 0]
            near = min(divisors, key=lambda d: abs(d - self.window))
            raise ValueError(
                f"telemetry window {self.window} must divide the run "
                f"length {rounds} (nearest divisor: {near})")
        return self.window


@dataclasses.dataclass(frozen=True)
class Counter:
    """One registered telemetry counter.

    ``field`` names the carried field the counter maps onto —
    ``"noc.<key>"`` reaches into the carried NoC state dict. ``axis``
    is the trailing shape semantic: ``scalar`` (0-d), ``core`` /
    ``app`` / ``link`` (simulator), ``shard`` / ``tenant`` (serving),
    ``bucket`` (histograms). ``cumulative`` counters snapshot a
    monotone running sum (per-window series are deltas); gauges
    (``cumulative=False``) snapshot an instantaneous value (per-window
    series are samples).
    """
    name: str
    unit: str
    axis: str
    field: str
    description: str
    cumulative: bool = True


#: Simulator counters, mapped onto the carried state of
#: ``repro_torch.core.simulator._round`` (the ``stats`` dict + carried
#: NoC state). Window snapshots expose exactly these.
SIM_COUNTERS: Tuple[Counter, ...] = (
    Counter("cycles", "cycles", "core", "cycles",
            "per-core accumulated round cost (completion clock)"),
    Counter("requests", "requests", "scalar", "requests",
            "memory requests issued"),
    Counter("local_hits", "requests", "scalar", "local_hits",
            "requests served by the issuing core's own L1"),
    Counter("remote_hits", "requests", "scalar", "remote_hits",
            "requests served by a peer L1 in the cluster"),
    Counter("l2_accesses", "requests", "scalar", "l2_accesses",
            "requests escalated to the shared L2"),
    Counter("dram", "requests", "scalar", "dram",
            "L2 misses that went to DRAM"),
    Counter("noc_flits", "flits", "scalar", "noc_flits",
            "interconnect flits injected by the L1 complex"),
    Counter("l1_lat_sum", "cycles", "scalar", "l1_lat_sum",
            "sum of L1-complex completion times over served loads"),
    Counter("l1_lat_n", "loads", "scalar", "l1_lat_n",
            "loads fully served inside the L1 complex"),
    Counter("app_local", "requests", "app", "app_local",
            "per-app local L1 hits (mix attribution)"),
    Counter("app_remote", "requests", "app", "app_remote",
            "per-app remote L1 hits (mix attribution)"),
    Counter("app_lat_sum", "cycles", "app", "app_lat_sum",
            "per-app L1-complete latency sum"),
    Counter("app_lat_n", "loads", "app", "app_lat_n",
            "per-app loads fully served in the L1 complex"),
    Counter("noc.injected", "flits", "scalar", "noc.injected",
            "flits injected into the interconnect model"),
    Counter("noc.delivered", "flits", "scalar", "noc.delivered",
            "flits delivered by the interconnect model"),
    Counter("noc.delay_sum", "cycles", "scalar", "noc.delay_sum",
            "summed NoC queueing delay over crossing requests"),
    Counter("noc.delay_n", "requests", "scalar", "noc.delay_n",
            "requests that crossed the interconnect"),
    Counter("noc.link_flits", "flits", "link", "noc.link_flits",
            "per-link flits carried"),
    Counter("noc.link_busy", "cycles", "link", "noc.link_busy",
            "per-link busy cycles"),
    Counter("noc.queue", "flits", "link", "noc.queue",
            "per-port queue depth at window end (backpressure gauge)",
            cumulative=False),
    Counter("lat_hist", "loads", "bucket", "lat_hist",
            "log2-bucketed L1-complete latency histogram"),
)

#: Serving-engine counters, derived from the per-sub-round grids
#: ``serve_stream`` already streams to the host.
SERVE_COUNTERS: Tuple[Counter, ...] = (
    Counter("admitted", "requests", "shard", "admitted",
            "requests admitted (valid slots) per shard"),
    Counter("local_hits", "blocks", "shard", "nl",
            "prefix blocks reused from the local pool"),
    Counter("remote_hits", "blocks", "shard", "nr",
            "prefix blocks fetched from a peer shard"),
    Counter("recomputed", "blocks", "shard", "nc",
            "prefix blocks recomputed (prefill)"),
    Counter("latency_sum", "cycles", "shard", "lat",
            "summed modeled request latency per shard"),
    Counter("cycles", "cycles", "scalar", "cycles",
            "summed per-admission-round critical paths"),
    Counter("probe_messages", "messages", "scalar", "pm",
            "broadcast directory probes sent"),
    Counter("tenant_requests", "requests", "tenant", "tenant_requests",
            "requests admitted per tenant"),
    Counter("tenant_blocks", "blocks", "tenant", "tenant_blocks",
            "prefix blocks walked per tenant"),
    Counter("lat_hist", "requests", "bucket", "lat_hist",
            "value-resolved modeled-latency histogram (1 cycle/bucket)"),
)


# ---------------------------------------------------------------------------
# histogram helpers
# ---------------------------------------------------------------------------

#: The reference's log-2 bucket as a step function over float32: entry
#: ``i`` is the float32 bit pattern of the smallest value the reference
#: puts in bucket ``i + 1``, one entry for every bucket a finite float32
#: reaches (1 .. 128). The reference computes
#: ``floor(jnp.log2(jnp.maximum(x, 1.0)))`` in float32, and its ``log2``
#: misses the powers of two: bucket 3 starts at 7.9999995 and 8192.0
#: falls in bucket 12 (bucket 13 starts at 8192.001). A ``log2`` or
#: ``frexp`` of another library disagrees next to the powers of two, so
#: :func:`log2_bucket` counts thresholds instead. The table was found by
#: a bisection over float32 bit patterns in [1.0, FLT_MAX], the jitted
#: reference ``repro.core.telemetry.log2_bucket`` evaluated on the CPU
#: for each bucket; every float32 within 4096 ulps of each threshold
#: lands on the threshold's side (the bucket is monotone).
_LOG2_THRESHOLD_BITS = (
    0x40000000, 0x40800000, 0x40ffffff, 0x417fffff, 0x41ffffff, 0x427ffffd,
    0x42fffffd, 0x437ffffd, 0x43fffffd, 0x447ffffd, 0x44fffffd, 0x457ffff9,
    0x46000001, 0x467ffff9, 0x47000001, 0x477ffff9, 0x47fffff1, 0x487ffff9,
    0x48fffff1, 0x497ffff9, 0x49fffff1, 0x4a7ffff9, 0x4afffff1, 0x4b7ffff1,
    0x4bfffff9, 0x4c800001, 0x4d000005, 0x4d7ffff1, 0x4dfffff9, 0x4e800001,
    0x4f000005, 0x4f7ffff2, 0x4ffffffa, 0x507fffe2, 0x50ffffea, 0x517ffff2,
    0x51fffffa, 0x527fffe2, 0x52ffffea, 0x537ffff2, 0x53fffffa, 0x547fffe2,
    0x54ffffea, 0x557ffff2, 0x55fffffa, 0x567fffe2, 0x56fffffa, 0x577fffe2,
    0x58000005, 0x587ffff2, 0x58ffffda, 0x59800001, 0x59ffffea, 0x5a800009,
    0x5afffffa, 0x5b7fffe2, 0x5c000005, 0x5c7ffff2, 0x5cffffda, 0x5d800001,
    0x5dffffea, 0x5e800009, 0x5efffffb, 0x5f7fffe3, 0x5fffffcb, 0x607ffff3,
    0x60ffffdb, 0x617fffc3, 0x61ffffeb, 0x627fffd3, 0x62fffffb, 0x637fffe3,
    0x63ffffcb, 0x647ffff3, 0x64ffffdb, 0x657fffc3, 0x65ffffeb, 0x667fffd3,
    0x66fffffb, 0x677fffe3, 0x67ffffcb, 0x687ffff3, 0x68ffffdb, 0x697fffc3,
    0x69ffffeb, 0x6a7fffd3, 0x6afffffb, 0x6b7fffe3, 0x6bffffcb, 0x6c7ffff3,
    0x6cffffdb, 0x6d7fffc3, 0x6e000006, 0x6e7ffff3, 0x6effffdc, 0x6f7fffc4,
    0x6fffffac, 0x7080000a, 0x70fffffc, 0x717fffe4, 0x71ffffcc, 0x727fffb4,
    0x7300000e, 0x73800002, 0x73ffffec, 0x747fffd4, 0x74ffffbc, 0x75800012,
    0x76000006, 0x767ffff4, 0x76ffffdc, 0x777fffc4, 0x77ffffac, 0x7880000a,
    0x78fffffc, 0x797fffe4, 0x79ffffcc, 0x7a7fffb4, 0x7b00000e, 0x7b800002,
    0x7bffffec, 0x7c7fffd4, 0x7cffffbc, 0x7d800012, 0x7e000006, 0x7e7ffff5,
    0x7effffdd, 0x7f7fffc5,
)

#: The thresholds as float32 values (exact: built from the bit patterns).
LOG2_THRESHOLDS = np.array(_LOG2_THRESHOLD_BITS, np.uint32).view(np.float32)


def log2_edges_tensor(bins: int, device) -> torch.Tensor:
    """The first ``bins - 1`` thresholds as a float32 tensor on
    ``device``: what :func:`log2_bucket` compares against (a value
    reaching all of them is in the last bucket, the reference's clip)."""
    return torch.from_numpy(LOG2_THRESHOLDS[:bins - 1].copy()).to(device)


def log2_bucket(x: torch.Tensor, bins: int,
                edges: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's log-2 bucket of float32 latencies, as int64.

    Bucket ``i`` covers about ``[2^i, 2^(i+1))`` (exactly: from
    threshold ``i - 1`` of :data:`LOG2_THRESHOLDS` to threshold ``i``);
    values below 2 land in bucket 0 and values past the last threshold
    clip into bucket ``bins - 1``. One ``bucketize`` — a count of the
    thresholds ``<= x`` — with no transcendental, so every device gives
    the reference's bucket. ``edges`` is :func:`log2_edges_tensor`,
    passed in by callers that bucket every round.
    """
    if edges is None:
        edges = log2_edges_tensor(bins, x.device)
    return torch.bucketize(x, edges, right=True)


def log2_edges(bins: int) -> np.ndarray:
    """(bins,) float64 upper edges of the log2 buckets (2^(i+1))."""
    return 2.0 ** (np.arange(bins, dtype=np.float64) + 1.0)


def serving_hist_bins(max_lat: float) -> int:
    """Bucket count for a value-resolved serving histogram.

    One bucket per modeled cycle up to the engine's per-request latency
    bound (``_check_headroom``'s ``max_lat``), plus an overflow bucket
    for non-ideal NoC delay beyond the base-cost bound.
    """
    return int(math.ceil(max_lat)) + 2


def _np_lerp(a: float, b: float, t: float) -> float:
    """numpy's percentile interpolation, replicated bit for bit."""
    diff = b - a
    if t >= 0.5:
        return b - diff * (1.0 - t)
    return a + diff * t


def hist_quantile(counts, q: float) -> float:
    """Exact ``np.percentile(values, q)`` from a value-resolved histogram.

    ``counts[v]`` is the number of observations with value exactly
    ``v`` (the serving engine's integral cost model quantized at one
    modeled cycle per bucket). Reconstructs numpy's default linear
    interpolation between order statistics, including its asymmetric
    lerp, so the result is bit-identical to materializing the array.
    """
    counts = np.asarray(counts, np.int64)
    n = int(counts.sum())
    if n == 0:
        return 0.0
    pos = (q / 100.0) * (n - 1)
    i = int(np.floor(pos))
    t = pos - i
    cum = np.cumsum(counts)
    lo = int(np.searchsorted(cum, i, side="right"))
    if t == 0.0:
        return float(lo)
    hi = int(np.searchsorted(cum, i + 1, side="right"))
    return _np_lerp(float(lo), float(hi), t)


def hist_quantile_edges(counts, q: float,
                        edges: Optional[np.ndarray] = None) -> float:
    """Conservative quantile from a bucketed histogram (upper edge).

    For log2-bucketed histograms the order statistic's bucket is exact
    but the value inside it is not; return the bucket's upper edge so
    the reported pXX is a guaranteed upper bound. ``edges`` defaults to
    the log2 edges sized to ``counts``.
    """
    counts = np.asarray(counts, np.int64)
    n = int(counts.sum())
    if n == 0:
        return 0.0
    if edges is None:
        edges = log2_edges(counts.size)
    # order statistic at ceil(q/100 * (n-1)): the conservative side
    pos = int(math.ceil((q / 100.0) * (n - 1)))
    cum = np.cumsum(counts)
    b = int(np.searchsorted(cum, pos, side="right"))
    return float(edges[min(b, counts.size - 1)])
