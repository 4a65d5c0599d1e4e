"""Experiment driver + paper-figure summaries over the simulator.

``run_app``/``run_suite`` run straight on :func:`simulate_batch`: every
requested (app, kernel) trace of one architecture is grouped by
:func:`trace_kind` (same shape, one batch), so the paper suite is two
batched passes per architecture (the m=2 and the m=4 apps).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch.core.arch import PAPER_ARCHITECTURES
from repro_torch.core.geometry import GpuGeometry, PAPER_GEOMETRY
from repro_torch.core.simulator import (SimResult, Trace, simulate_batch,
                                        trace_kind)
from repro_torch.core.trace import APPS, AppParams, make_trace


def _nanmean(values: Iterable[float]) -> float:
    """Mean over non-NaN entries; NaN only if *every* entry is NaN
    (``SimResult.l1_latency`` is NaN for a kernel where no load was ever
    fully served inside the L1 complex)."""
    vals = [v for v in values if not np.isnan(v)]
    return float(np.mean(vals)) if vals else float("nan")


@dataclasses.dataclass
class AppResult:
    app: str
    arch: str
    per_kernel: List[SimResult]

    @property
    def ipc(self) -> float:
        # whole-app IPC = total instructions / total cycles across kernels
        insns = sum(r.instructions for r in self.per_kernel)
        cycles = sum(r.cycles for r in self.per_kernel)
        return insns / cycles

    @property
    def l1_latency(self) -> float:
        return _nanmean(r.l1_latency for r in self.per_kernel)

    @property
    def l1_hit_rate(self) -> float:
        return _nanmean(r.l1_hit_rate for r in self.per_kernel)

    @property
    def remote_hit_rate(self) -> float:
        return _nanmean(r.remote_hit_rate for r in self.per_kernel)

    @property
    def noc_flits(self) -> float:
        return float(sum(r.noc_flits for r in self.per_kernel))

    @property
    def noc_flits_injected(self) -> float:
        # traffic routed by the modeled interconnect (core.noc) — unlike
        # `noc_flits`, which also counts the memory-side L2/write-back
        # flits the NoC layer excludes
        return float(sum(r.noc.flits_injected for r in self.per_kernel))

    @property
    def noc_mean_queue_delay(self) -> float:
        # interconnect queueing (core.noc): 0.0 under `ideal`
        return _nanmean(r.noc.mean_queue_delay for r in self.per_kernel)

    @property
    def noc_max_link_util(self) -> float:
        # hotspot link utilization, worst kernel
        return float(max(r.noc.max_link_util for r in self.per_kernel))

    @property
    def l2_accesses(self) -> float:
        return float(sum(r.l2_accesses for r in self.per_kernel))


def kernel_range(app: str,
                 kernels_per_app: Optional[int]) -> Optional[range]:
    """The kernel subset a ``kernels_per_app`` budget selects for ``app``
    (None = all kernels)."""
    if not kernels_per_app:
        return None
    return range(min(kernels_per_app, APPS[app].n_kernels))


def app_traces(app: str, geom: GpuGeometry = PAPER_GEOMETRY,
               kernels: Optional[Iterable[int]] = None,
               params: Optional[AppParams] = None,
               rounds: Optional[int] = None) -> List[Trace]:
    """The per-kernel traces one ``run_app`` call simulates; ``rounds``
    truncates every kernel."""
    p = params if params is not None else APPS[app]
    if rounds is not None:
        p = dataclasses.replace(p, rounds=rounds)
    ks = list(kernels) if kernels is not None else range(p.n_kernels)
    return [make_trace(p, n_cores=geom.n_cores, kernel=k) for k in ks]


def _simulate_grouped(arch: str, traces: List[Trace], geom: GpuGeometry,
                      **kw) -> List[SimResult]:
    """``simulate_batch`` over traces of any kinds: one batch per kind,
    results in input order."""
    groups: Dict[tuple, List[int]] = {}
    for i, t in enumerate(traces):
        groups.setdefault(trace_kind(t), []).append(i)
    out: List[Optional[SimResult]] = [None] * len(traces)
    for idxs in groups.values():
        results = simulate_batch(arch, [traces[i] for i in idxs], geom, **kw)
        for i, r in zip(idxs, results):
            out[i] = r
    return out


def run_app(app: str, arch: str, geom: GpuGeometry = PAPER_GEOMETRY,
            kernels: Optional[Iterable[int]] = None,
            params: Optional[AppParams] = None,
            rounds: Optional[int] = None, *,
            probe_backend: Optional[str] = None,
            device=None) -> AppResult:
    """All kernels of one app through one architecture — one batch."""
    traces = app_traces(app, geom, kernels, params, rounds)
    return AppResult(app, arch, simulate_batch(
        arch, traces, geom, probe_backend=probe_backend, device=device))


def run_suite(apps: Optional[Iterable[str]] = None,
              archs: Iterable[str] = PAPER_ARCHITECTURES,
              geom: GpuGeometry = PAPER_GEOMETRY,
              kernels_per_app: Optional[int] = None,
              rounds: Optional[int] = None, *,
              probe_backend: Optional[str] = None,
              device=None) -> Dict[str, Dict[str, AppResult]]:
    """{app: {arch: AppResult}} over the benchmark suite.

    For each architecture, every (app, kernel) trace goes through
    :func:`simulate_batch`, one batch per trace shape.
    """
    apps = list(apps or APPS)
    traces = {app: app_traces(app, geom,
                              kernel_range(app, kernels_per_app),
                              rounds=rounds)
              for app in apps}
    flat = [(app, tr) for app in apps for tr in traces[app]]
    out: Dict[str, Dict[str, AppResult]] = {app: {} for app in apps}
    for arch in archs:
        results = _simulate_grouped(arch, [tr for _, tr in flat], geom,
                                    probe_backend=probe_backend,
                                    device=device)
        for app in apps:
            out[app][arch] = AppResult(
                app, arch, [r for (a, _), r in zip(flat, results)
                            if a == app])
    return out


def normalized_ipc(suite: Dict[str, Dict[str, AppResult]],
                   base: str = "private") -> Dict[str, Dict[str, float]]:
    return {app: {arch: r[arch].ipc / r[base].ipc for arch in r}
            for app, r in suite.items()}


def geomean(xs: Iterable[float]) -> float:
    """Geometric mean; rejects NaN/inf/non-positive inputs loudly."""
    arr = np.asarray(list(xs), dtype=float)
    if arr.size == 0:
        raise ValueError("geomean of an empty sequence")
    if not np.all(np.isfinite(arr)) or np.any(arr <= 0):
        raise ValueError(
            f"geomean needs finite positive inputs, got {arr.tolist()}")
    return float(np.exp(np.mean(np.log(arr))))
