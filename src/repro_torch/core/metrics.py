"""Experiment driver + paper-figure summaries over the simulator.

``run_app``/``run_suite`` sweep through
:class:`repro_torch.core.sweep.SweepGrid`: every requested (arch,
kernel) point goes into one grid, which stacks same-family
architectures and batches the trace axis, one pass per (family, trace
shape) — the paper suite under one architecture is two passes (the m=2
and the m=4 apps).

``run_mixes`` extends the same pattern to multi-tenant co-scheduling:
every composed :class:`~repro_torch.core.trace.WorkloadMix` trace plus
every per-slot solo baseline goes into one grid run, and
:class:`MixResult` turns the per-app attribution into the fairness
metrics (weighted speedup, unfairness).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.core.arch import PAPER_ARCHITECTURES
from repro_torch.core.geometry import GpuGeometry, PAPER_GEOMETRY
from repro_torch.core.simulator import SimResult, Trace
from repro_torch.core.sweep import SweepGrid, SweepPoint, SweepReport
from repro_torch.core.trace import APPS, AppParams, WorkloadMix, make_trace


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


def sweep_cells(cells: Iterable[tuple], *, probe_backend: Optional[str] = None,
                device=None) -> Dict[object, List[SimResult]]:
    """Sweep many (key, arch, geom, traces) cells in one grid run.

    Every cell's traces become grid points, one :class:`SweepGrid` run
    sweeps them all (same-family architectures share passes), and the
    per-point results regroup into ``{key: [SimResult per trace, in
    order]}``.
    """
    points: List[SweepPoint] = []
    owners: List[object] = []
    for key, arch, geom, traces in cells:
        for tr in traces:
            points.append(SweepPoint(arch, geom, tr,
                                     probe_backend=probe_backend))
            owners.append(key)
    if not points:
        return {}
    run = SweepGrid.from_points(points).run(device=device)
    out: Dict[object, List[SimResult]] = {}
    for key, r in zip(owners, run.results):
        out.setdefault(key, []).append(r)
    return out


def grid_app_results(grid: SweepGrid, results: Sequence[SimResult],
                     app: str) -> Dict[tuple, "AppResult"]:
    """{(arch, geom, noc): AppResult} over one grid's aligned results,
    keyed off ``grid.points``; a cell's traces fold into one
    :class:`AppResult`, in point order."""
    grouped: Dict[tuple, List[SimResult]] = {}
    for pt, r in zip(grid.points, results):
        grouped.setdefault((pt.arch, pt.geom, pt.noc), []).append(r)
    return {key: AppResult(app, key[0], rs)
            for key, rs in grouped.items()}


def run_app(app: str, arch: str, geom: GpuGeometry = PAPER_GEOMETRY,
            kernels: Optional[Iterable[int]] = None,
            params: Optional[AppParams] = None,
            rounds: Optional[int] = None, *,
            probe_backend: Optional[str] = None,
            device=None) -> AppResult:
    """All kernels of one app through one architecture — one grid run."""
    traces = app_traces(app, geom, kernels, params, rounds)
    grid = SweepGrid([arch], [geom], traces, probe_backends=[probe_backend])
    return AppResult(app, arch, grid.run(device=device).results)


def run_suite(apps: Optional[Iterable[str]] = None,
              archs: Iterable[str] = PAPER_ARCHITECTURES,
              geom: GpuGeometry = PAPER_GEOMETRY,
              kernels_per_app: Optional[int] = None,
              rounds: Optional[int] = None, *,
              probe_backend: Optional[str] = None,
              device=None) -> Dict[str, Dict[str, AppResult]]:
    """{app: {arch: AppResult}} over the benchmark suite.

    The whole (app-kernel x arch) product goes into *one*
    :class:`SweepGrid` run via :func:`sweep_cells`.
    """
    apps = list(apps or APPS)
    archs = tuple(archs)
    traces = {app: app_traces(app, geom,
                              kernel_range(app, kernels_per_app),
                              rounds=rounds)
              for app in apps}
    results = sweep_cells((((app, arch), arch, geom, traces[app])
                           for app in apps for arch in archs),
                          probe_backend=probe_backend, device=device)
    return {app: {arch: AppResult(app, arch, results[(app, arch)])
                  for arch in archs}
            for app in apps}


@dataclasses.dataclass
class MixResult:
    """Fairness summary of one (mix, arch) co-scheduling run.

    ``shared`` is the composed-trace run (its ``per_app`` block carries
    the attribution); ``solo`` holds one full-machine baseline run per
    mix slot over the *same* sliced/staggered addresses
    (:meth:`WorkloadMix.component_traces`), so the slowdowns below
    measure interference, not address-map artifacts.

    A slot owns ``k_i`` of the machine's ``C`` cores while its solo
    baseline runs on all ``C``, so speedups compare *per-core* IPC:
    ``slowdown_i = (solo_ipc_i / C) / (shared_ipc_i / k_i)``.
    ``weighted_speedup`` is ``sum 1/slowdown_i`` (ideal = n_apps) and
    ``unfairness`` is ``max slowdown / min slowdown`` (ideal = 1)
    [MASK, arXiv 1708.04911].
    """
    mix: WorkloadMix
    arch: str
    shared: SimResult
    solo: List[SimResult]

    @property
    def n_cores(self) -> int:
        return sum(a.cores for a in self.shared.per_app)

    @property
    def per_app_ipc(self) -> List[float]:
        return [a.ipc for a in self.shared.per_app]

    @property
    def per_app_l1_hit_rate(self) -> List[float]:
        return [a.l1_hit_rate for a in self.shared.per_app]

    @property
    def slowdowns(self) -> List[float]:
        C = self.n_cores
        out = []
        for a, s in zip(self.shared.per_app, self.solo):
            shared_per_core = a.ipc / a.cores
            solo_per_core = s.ipc / C
            out.append(solo_per_core / shared_per_core)
        return out

    @property
    def weighted_speedup(self) -> float:
        return float(sum(1.0 / s for s in self.slowdowns))

    @property
    def unfairness(self) -> float:
        sd = self.slowdowns
        return float(max(sd) / min(sd))


class MixRun(NamedTuple):
    """``run_mixes`` output: results plus the grid's accounting."""
    results: Dict[str, Dict[str, MixResult]]   # {mix_id: {arch: ...}}
    report: SweepReport


def run_mixes(mixes: Sequence[WorkloadMix],
              archs: Iterable[str] = PAPER_ARCHITECTURES,
              geom: GpuGeometry = PAPER_GEOMETRY,
              rounds: Optional[int] = None,
              seed: int = 0,
              n_devices: Optional[int] = None, *,
              probe_backend: Optional[str] = None,
              device=None) -> MixRun:
    """Sweep (mix x arch) with solo baselines in *one* grid run.

    Every composed mix trace and every per-slot solo baseline trace of
    every architecture goes into a single :class:`SweepGrid` run: solo
    points share the ordinary single-app passes, mix points bucket by
    (family, trace kind).
    """
    archs = tuple(archs)
    if rounds is not None:
        mixes = [dataclasses.replace(m, rounds=rounds) for m in mixes]
    mixes = list(mixes)
    ids = [m.mix_id for m in mixes]
    if len(set(ids)) != len(ids):
        raise ValueError(f"duplicate mix ids in {ids}")

    points: List[SweepPoint] = []
    owners: List[tuple] = []
    for mix, mid in zip(mixes, ids):
        shared = mix.compose(geom.n_cores, seed=seed)
        comps = mix.component_traces(geom.n_cores, seed=seed)
        for arch in archs:
            points.append(SweepPoint(arch, geom, shared,
                                     probe_backend=probe_backend))
            owners.append(("shared", mid, arch))
            for tr in comps:
                points.append(SweepPoint(arch, geom, tr,
                                         probe_backend=probe_backend))
                owners.append(("solo", mid, arch))
    run = SweepGrid.from_points(points).run(n_devices, device=device)

    grouped: Dict[tuple, List[SimResult]] = {}
    for key, r in zip(owners, run.results):
        grouped.setdefault(key, []).append(r)
    results = {
        mid: {arch: MixResult(mix, arch,
                              shared=grouped[("shared", mid, arch)][0],
                              solo=grouped[("solo", mid, arch)])
              for arch in archs}
        for mix, mid in zip(mixes, ids)}
    return MixRun(results=results, report=run.report)


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
