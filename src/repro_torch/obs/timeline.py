"""Windowed counter timelines with exact conservation checks.

The port of the reference's ``repro.obs.timeline``, numpy only. Both
timelines store *cumulative* per-window snapshots in float64 /
int64 (leading axis = windows). Cumulative storage is what makes the
two guarantees exact rather than approximate:

* **conservation** — the final snapshot *is* the run total, and the
  per-window delta series telescopes back to it with no float rounding
  (every f32 counter value is exactly f64-representable, consecutive
  snapshot differences are exact, and summing them reproduces the
  final snapshot bit for bit — see :mod:`repro_torch.core.telemetry`);
* **window invariance** — a timeline captured at window ``W`` re-binned
  by ``k`` (:meth:`SimTimeline.rebin`) equals the timeline captured at
  ``k*W`` exactly, because cumulative snapshots at shared round
  boundaries are identical regardless of stride (property-tested).

:meth:`SimTimeline.check` / :meth:`ServeTimeline.check` assert the
window sums against the corresponding ``SimResult`` / ``ServeResult``
totals and raise :class:`ConservationError` on any drift — the
telemetry capture (``repro_torch.launch.telemetry_capture``) and
``chip_smoke.py`` run these.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.telemetry import (Counter, SERVE_COUNTERS,
                                        SIM_COUNTERS, TelemetryConfig,
                                        hist_quantile, hist_quantile_edges,
                                        log2_edges)


class ConservationError(AssertionError):
    """A windowed counter series does not sum to its run total."""


def _registry(counters: Tuple[Counter, ...]) -> Dict[str, Counter]:
    return {c.name: c for c in counters}


_SIM_BY_NAME = _registry(SIM_COUNTERS)
_SERVE_BY_NAME = _registry(SERVE_COUNTERS)


def _widen(a: np.ndarray) -> np.ndarray:
    """Snapshot dtype widening: ints -> int64, floats -> float64."""
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer) or a.dtype == np.bool_:
        return a.astype(np.int64)
    return a.astype(np.float64)


def _check_eq(failures, name: str, got, want, atol: float = 0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.all(
            np.abs(got - want) <= atol):
        failures.append(f"{name}: window sum {got} != total {want}")


@dataclasses.dataclass
class _TimelineBase:
    """Shared mechanics; see :class:`SimTimeline` / :class:`ServeTimeline`."""
    window: int                        # rounds per window
    rounds: int                        # rounds covered
    cumulative: Dict[str, np.ndarray]  # {name: (n_windows, ...) snapshots}
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    _by_name: Dict[str, Counter] = dataclasses.field(
        default=None, repr=False, compare=False)  # set by subclass

    @property
    def n_windows(self) -> int:
        first = next(iter(self.cumulative.values()))
        return first.shape[0]

    @property
    def counter_names(self) -> Tuple[str, ...]:
        return tuple(self.cumulative)

    def counter(self, name: str) -> Counter:
        return self._by_name[name]

    def total(self, name: str) -> np.ndarray:
        """End-of-run total: the final cumulative snapshot."""
        return self.cumulative[name][-1]

    def series(self, name: str) -> np.ndarray:
        """Per-window values: deltas for cumulative counters, samples
        for gauges (leading axis = windows)."""
        snaps = self.cumulative[name]
        if not self._by_name[name].cumulative:
            return snaps
        zero = np.zeros_like(snaps[:1])
        return np.diff(np.concatenate([zero, snaps], axis=0), axis=0)

    def rebin(self, k: int) -> "_TimelineBase":
        """Coarsen to window ``k*W`` by subsampling cumulative snapshots.

        Exactly equals a capture taken at the coarser window (the
        snapshots at shared boundaries are identical), which is the
        invariance property the telemetry tests pin.
        """
        n = self.n_windows
        if k < 1 or n % k:
            raise ValueError(
                f"rebin factor {k} must divide the window count {n}")
        return dataclasses.replace(
            self, window=self.window * k,
            cumulative={name: snaps[k - 1::k]
                        for name, snaps in self.cumulative.items()})

    # ---- export ----------------------------------------------------
    def to_json_dict(self) -> dict:
        return {
            "kind": self.kind,
            "window": self.window,
            "rounds": self.rounds,
            "n_windows": self.n_windows,
            "meta": dict(self.meta),
            "counters": {
                name: {
                    "unit": c.unit, "axis": c.axis,
                    "cumulative": c.cumulative,
                    "series": self.series(name).tolist(),
                    "total": np.asarray(self.total(name)).tolist(),
                }
                for name, c in ((n, self._by_name[n])
                                for n in self.cumulative)
            },
        }

    def to_csv(self) -> str:
        """Long-form per-window series: one row per (window, counter,
        lane)."""
        lines = ["window,counter,axis,lane,value"]
        for name in self.cumulative:
            c = self._by_name[name]
            ser = self.series(name)
            flat = ser.reshape(ser.shape[0], -1)
            for w in range(flat.shape[0]):
                for lane in range(flat.shape[1]):
                    lines.append(f"{w},{name},{c.axis},{lane},"
                                 f"{flat[w, lane]!r}")
        return "\n".join(lines) + "\n"

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json_dict(), f, indent=1, sort_keys=True)

    def write_csv(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_csv())


@dataclasses.dataclass
class SimTimeline(_TimelineBase):
    """Windowed counter timeline of one simulator run.

    Built from the cumulative snapshot stack the telemetry-enabled
    round loop keeps (``repro_torch.core.simulator._simulate_points``);
    counters follow :data:`repro_torch.core.telemetry.SIM_COUNTERS`.
    """
    kind = "sim"

    def __post_init__(self):
        if self._by_name is None:
            self._by_name = _SIM_BY_NAME

    @classmethod
    def from_snapshots(cls, snaps, telemetry: TelemetryConfig, *,
                       rounds: int, meta: Optional[dict] = None
                       ) -> "SimTimeline":
        """``snaps = {"stats": {...}, "noc": {...}}``, each leaf with a
        leading window axis (host copies of the round loop's window-end
        snapshots)."""
        cumulative: Dict[str, np.ndarray] = {}
        for c in SIM_COUNTERS:
            if c.field.startswith("noc."):
                leaf = snaps["noc"][c.field[len("noc."):]]
            elif c.field in snaps["stats"]:
                leaf = snaps["stats"][c.field]
            else:            # lat_hist with histograms off
                continue
            cumulative[c.name] = _widen(leaf)
        return cls(window=telemetry.window, rounds=rounds,
                   cumulative=cumulative, meta=dict(meta or {}))

    # ---- histogram -------------------------------------------------
    @property
    def hist(self) -> Optional[np.ndarray]:
        """Final log2-bucketed L1-complete latency histogram."""
        if "lat_hist" not in self.cumulative:
            return None
        return self.total("lat_hist")

    @property
    def hist_edges(self) -> Optional[np.ndarray]:
        return None if self.hist is None else log2_edges(self.hist.size)

    def hist_percentile(self, q: float) -> float:
        """Bucket-exact quantile (conservative upper edge) of the
        L1-complete latency distribution."""
        if self.hist is None:
            raise ValueError("telemetry was captured without histograms")
        return hist_quantile_edges(self.hist, q, self.hist_edges)

    # ---- conservation ----------------------------------------------
    def check(self, result) -> "SimTimeline":
        """Assert window sums == ``SimResult`` totals (exact).

        Raises :class:`ConservationError` naming every violated
        counter; returns ``self`` so captures can be checked inline.
        """
        failures: list = []
        sums = {name: self.series(name).sum(axis=0)
                for name in self.cumulative
                if self._by_name[name].cumulative}
        # telescoping: window sums must equal the final snapshot
        for name, s in sums.items():
            _check_eq(failures, f"{name} (telescoping)", s,
                      self.total(name))
        _check_eq(failures, "l2_accesses", sums["l2_accesses"],
                  result.l2_accesses)
        _check_eq(failures, "dram", sums["dram"], result.dram_accesses)
        _check_eq(failures, "noc_flits", sums["noc_flits"],
                  result.noc_flits)
        _check_eq(failures, "cycles(max)", sums["cycles"].max(),
                  result.cycles)
        req = float(sums["requests"])
        if req:
            _check_eq(failures, "local_hit_rate",
                      float(sums["local_hits"]) / req,
                      result.local_hit_rate)
            _check_eq(failures, "remote_hit_rate",
                      float(sums["remote_hits"]) / req,
                      result.remote_hit_rate)
        latn = float(sums["l1_lat_n"])
        if latn:
            _check_eq(failures, "l1_latency",
                      float(sums["l1_lat_sum"]) / latn,
                      result.l1_latency)
        _check_eq(failures, "noc.injected", sums["noc.injected"],
                  result.noc.flits_injected)
        _check_eq(failures, "noc.delivered", sums["noc.delivered"],
                  result.noc.flits_delivered)
        for a, app in enumerate(result.per_app):
            _check_eq(failures, f"app_local[{a}]",
                      sums["app_local"][a], app.local_hits)
            _check_eq(failures, f"app_remote[{a}]",
                      sums["app_remote"][a], app.remote_hits)
            _check_eq(failures, f"app_lat_sum[{a}]",
                      sums["app_lat_sum"][a], app.l1_lat_sum)
        if self.hist is not None:
            _check_eq(failures, "lat_hist(sum)",
                      int(self.hist.sum()), latn)
        if failures:
            raise ConservationError(
                "sim timeline conservation violated:\n  "
                + "\n  ".join(failures))
        return self


@dataclasses.dataclass
class ServeTimeline(_TimelineBase):
    """Windowed counter timeline of one serving-engine replay.

    Window unit is *admission rounds* (``B`` slots per shard each);
    counters follow :data:`repro_torch.core.telemetry.SERVE_COUNTERS`.
    Built host-side from the per-sub-round grids the engine already
    streams back, plus the latency bincount (``hist``).
    A ragged final window is allowed (host aggregation has no static
    shape constraint).
    """
    kind = "serve"
    hist: Optional[np.ndarray] = None   # (bins,) int64, 1 cycle/bucket
    hist_exact: bool = False            # quantiles == np.percentile

    def __post_init__(self):
        if self._by_name is None:
            self._by_name = _SERVE_BY_NAME

    @classmethod
    def from_grids(cls, *, window: int, slots: int,
                   served: np.ndarray, nl: np.ndarray, nr: np.ndarray,
                   nc: np.ndarray, lat: np.ndarray,
                   pm_rounds: np.ndarray, cycles_rounds: np.ndarray,
                   tenant: np.ndarray, n_tenants: int,
                   hist: Optional[np.ndarray] = None,
                   hist_exact: bool = False,
                   meta: Optional[dict] = None) -> "ServeTimeline":
        """Aggregate (T, C) sub-round grids into per-window cumulative
        snapshots. ``pm_rounds`` / ``cycles_rounds`` are per-admission-
        round scalars (length ``T // slots``)."""
        T, C = served.shape
        n_adm = T // slots
        W = min(window, n_adm)
        bounds = np.arange(0, n_adm, W)          # ragged tail allowed
        sub_bounds = bounds * slots

        def win_sum(grid, dtype):
            g = np.asarray(grid, dtype)
            return np.add.reduceat(g, sub_bounds, axis=0)

        def win_sum_rounds(per_round, dtype):
            g = np.asarray(per_round, dtype)
            return np.add.reduceat(g, bounds, axis=0)

        widx = np.repeat(np.arange(bounds.size),
                         np.diff(np.append(sub_bounds, T)))  # (T,)

        def per_tenant(weights, dtype=np.int64):
            out = np.zeros((bounds.size, n_tenants), dtype)
            w2 = np.broadcast_to(widx[:, None], served.shape)[served]
            np.add.at(out, (w2, np.asarray(tenant)[served]),
                      np.asarray(weights, dtype)[served])
            return out

        deltas = {
            "admitted": win_sum(served, np.int64),
            "local_hits": win_sum(nl, np.int64),
            "remote_hits": win_sum(nr, np.int64),
            "recomputed": win_sum(nc, np.int64),
            "latency_sum": win_sum(lat, np.float64),
            "cycles": win_sum_rounds(cycles_rounds, np.float64),
            "probe_messages": win_sum_rounds(pm_rounds, np.int64),
            "tenant_requests": per_tenant(np.ones_like(served, np.int64)),
            "tenant_blocks": per_tenant(
                np.asarray(nl, np.int64) + np.asarray(nr, np.int64)
                + np.asarray(nc, np.int64)),
        }
        cumulative = {name: np.cumsum(d, axis=0)
                      for name, d in deltas.items()}
        return cls(window=W, rounds=n_adm, cumulative=cumulative,
                   meta=dict(meta or {}),
                   hist=None if hist is None else _widen(hist),
                   hist_exact=hist_exact)

    def hist_percentile(self, q: float) -> float:
        """Quantile from the value-resolved latency histogram —
        bit-identical to ``np.percentile`` when ``hist_exact``."""
        if self.hist is None:
            raise ValueError("telemetry was captured without histograms")
        return hist_quantile(self.hist, q)

    def check(self, result) -> "ServeTimeline":
        """Assert window sums == ``ServeResult`` totals (exact)."""
        failures: list = []
        sums = {name: self.series(name).sum(axis=0)
                for name in self.cumulative}
        for name, s in sums.items():
            _check_eq(failures, f"{name} (telescoping)", s,
                      self.total(name))
        _check_eq(failures, "admitted", sums["admitted"].sum(),
                  result.n_requests)
        _check_eq(failures, "local_hits", sums["local_hits"].sum(),
                  result.local_hits)
        _check_eq(failures, "remote_hits", sums["remote_hits"].sum(),
                  result.remote_hits)
        _check_eq(failures, "recomputed", sums["recomputed"].sum(),
                  result.recomputed_blocks)
        _check_eq(failures, "probe_messages", sums["probe_messages"],
                  result.probe_messages)
        _check_eq(failures, "cycles", sums["cycles"], result.cycles)
        _check_eq(failures, "latency_sum", sums["latency_sum"].sum(),
                  result.tenant_latency_sum.sum())
        _check_eq(failures, "tenant_requests", sums["tenant_requests"],
                  result.tenant_requests)
        _check_eq(failures, "tenant_blocks", sums["tenant_blocks"],
                  result.tenant_blocks)
        if self.hist is not None:
            _check_eq(failures, "lat_hist(sum)", int(self.hist.sum()),
                      int(np.asarray(result.served).sum()))
        if failures:
            raise ConservationError(
                "serving timeline conservation violated:\n  "
                + "\n  ".join(failures))
        return self
