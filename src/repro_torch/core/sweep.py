"""Multi-axis parameter-grid sweeps over the batched simulator.

:class:`SweepGrid` takes a cartesian grid over five axes —

    archs          : architecture-policy names (``repro_torch.core.arch``)
    geoms          : :class:`GpuGeometry` points
    traces         : :class:`Trace` points (e.g. all kernels of an app)
    nocs           : interconnect-model names (``repro_torch.core.noc``;
                     default the ``ideal`` model)
    probe_backends : ATA probe lowerings (``repro_torch.core.probe``;
                     default the device's own, bit-identical either way)

— and runs every point through the round-pipeline simulator in as few
batched passes as it can:

* **policy stacking** — architectures whose policies share a
  ``stack_key`` (one tag-state layout and round dataflow, e.g. ``ata``,
  ``ata_fifo``, ``ata_bypass``, ``victim``) run in *one* pass. Each
  member's L1 stage runs on its own contiguous run of the pass's points
  and every shared stage (L2, fill, NoC, timing) runs once over them
  all (``simulator._simulate_points``). The reference selects the
  member per point with ``lax.switch``, which under ``vmap`` computes
  every member's branch; here a point pays only its own policy's ops,
  plus the concatenations that rejoin the runs.
* **geometry batching** — timing scalars are per-point tensors
  (:class:`~repro_torch.core.geometry.DeviceGeometry`), so geometries
  that differ only in scalars share a pass; structure fields (core,
  set and way counts) fix tensor shapes and split passes.
* **NoC stacking** — NoC models stack the same way
  (``NocModel.stack_key``; the built-ins share one family).

A pass — a *bucket* — is keyed (arch family, NoC family, geometry
structure, trace kind = (addr shape, insn shape, app count), probe
backend): the reference's executable key without its padded batch and
device count. :class:`SweepReport` keeps the reference's names:
``n_executables`` counts the distinct bucket keys a run used,
``n_compiles`` the keys new to the process, so the committed report
baselines gate them. Results are bit-identical to per-point
:func:`repro_torch.core.simulate`.

``SweepGrid.run(telemetry=...)`` keeps one windowed
:class:`~repro_torch.obs.SimTimeline` per point, each equal to the one
the point's own ``simulate(telemetry=...)`` keeps.

Every bucket runs on the one device given to :meth:`SweepGrid.run`;
``n_devices`` is accepted for the reference's signature and the report
says 1.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.arch import get_arch, registered_archs
from repro_torch.core.geometry import (GpuGeometry, PAPER_GEOMETRY,
                                       geom_structure)
from repro_torch.core.noc import get_noc, registered_nocs
from repro_torch.core.probe import PROBE_BACKENDS, resolve_probe_backend
from repro_torch.core.telemetry import TelemetryConfig
from repro_torch.core.simulator import (SimResult, Trace, _check_arch,
                                        _check_noc, _simulate_points,
                                        resolve_device, round_signature,
                                        trace_kind)


class SweepPoint(NamedTuple):
    """One (arch, geometry, trace[, noc[, probe_backend]]) grid point.

    ``probe_backend`` ``None`` takes the device's default lowering.
    """
    arch: str
    geom: GpuGeometry
    trace: Trace
    noc: str = "ideal"
    probe_backend: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class SweepReport:
    """Pass accounting for one :meth:`SweepGrid.run`: ``n_executables``
    distinct bucket keys (batched passes) dispatched, ``n_compiles`` of
    them new to this process."""
    n_points: int
    n_executables: int
    n_compiles: int
    n_devices: int
    wall_s: float


class SweepRun(NamedTuple):
    results: List[SimResult]     # aligned with SweepGrid.points
    report: SweepReport
    #: per-point ``repro_torch.obs.SimTimeline`` (aligned with
    #: ``SweepGrid.points``) when run with ``telemetry``, else None
    timelines: Optional[list] = None


#: Process-wide set of bucket keys already run. Eager PyTorch compiles
#: nothing: ``n_compiles`` and :func:`compile_count` count bucket keys
#: new to the process, under the reference's names, because its report
#: schema carries the field. No gate reads it.
_COMPILED_KEYS: set = set()


def compile_count() -> int:
    """Distinct bucket keys this process has run so far (see above)."""
    return len(_COMPILED_KEYS)


def _validate_geom(geom: GpuGeometry) -> None:
    if geom.n_cores % geom.cluster_size:
        raise ValueError(
            f"cluster_size={geom.cluster_size} must divide "
            f"n_cores={geom.n_cores}")


def _canonical_group(archs: Iterable[str]) -> Tuple[str, ...]:
    """A stacking family as an order-independent key: members in
    registry order."""
    order = {name: i for i, name in enumerate(registered_archs())}
    return tuple(sorted(archs, key=lambda a: order[a]))


def _canonical_noc_group(nocs: Iterable[str]) -> Tuple[str, ...]:
    """NoC stacking family, in registry order (see above)."""
    order = {name: i for i, name in enumerate(registered_nocs())}
    return tuple(sorted(nocs, key=lambda n: order[n]))


def _stack_groups(names: Iterable[str], stack_key_of, canonical
                  ) -> Dict[str, Tuple[str, ...]]:
    """{name: canonical stacked group} over names sharing a stack_key."""
    by_key: Dict[str, List[str]] = {}
    for name in names:
        fam = by_key.setdefault(stack_key_of(name), [])
        if name not in fam:
            fam.append(name)
    out: Dict[str, Tuple[str, ...]] = {}
    for fam in by_key.values():
        group = canonical(fam)
        for name in fam:
            out[name] = group
    return out


#: Memoized round signatures (one meta-device round each).
_SIG_MEMO: Dict[tuple, tuple] = {}


def _signature(*key) -> tuple:
    if key not in _SIG_MEMO:
        _SIG_MEMO[key] = round_signature(*key)
    return _SIG_MEMO[key]


class SweepGrid:
    """A cartesian (arch x geometry x noc x probe backend x trace) grid.

    ``SweepGrid(archs, geoms, traces, nocs, probe_backends)`` enumerates
    the full product with the trace axis fastest and the arch axis
    slowest; :meth:`from_points` takes an arbitrary point list instead.
    :meth:`run` returns the per-point :class:`SimResult` list aligned
    with :attr:`points`, plus a :class:`SweepReport`.
    """

    def __init__(self, archs: Sequence[str],
                 geoms: Optional[Sequence[GpuGeometry]] = None,
                 traces: Sequence[Trace] = (),
                 nocs: Sequence[str] = ("ideal",),
                 probe_backends: Sequence[Optional[str]] = (None,)):
        geoms = list(geoms) if geoms is not None else [PAPER_GEOMETRY]
        traces = list(traces)   # tolerate one-shot iterables
        self.points: List[SweepPoint] = [
            SweepPoint(a, g, t, n, pb)
            for a in archs for g in geoms for n in nocs
            for pb in probe_backends for t in traces]
        self._validate()

    @classmethod
    def from_points(cls, points: Iterable[SweepPoint]) -> "SweepGrid":
        grid = cls.__new__(cls)
        grid.points = [SweepPoint(*p) for p in points]
        grid._validate()
        return grid

    def _validate(self) -> None:
        for arch in {p.arch for p in self.points}:
            _check_arch(arch)
        for noc in {p.noc for p in self.points}:
            _check_noc(noc)
        for backend in {p.probe_backend for p in self.points}:
            if backend is not None and backend not in PROBE_BACKENDS:
                raise ValueError(f"probe_backend must be one of "
                                 f"{PROBE_BACKENDS}, got {backend!r}")
        seen = set()
        for p in self.points:
            if id(p.geom) not in seen:
                seen.add(id(p.geom))
                _validate_geom(p.geom)
            if p.trace.n_cores != p.geom.n_cores:
                raise ValueError(f"trace has {p.trace.n_cores} cores, "
                                 f"geometry {p.geom.n_cores}")
        self._validate_stacking()

    def _arch_group_of(self) -> Dict[str, Tuple[str, ...]]:
        """{arch: canonical stacked group} over this grid."""
        return _stack_groups(dict.fromkeys(p.arch for p in self.points),
                             lambda a: get_arch(a).stack_key,
                             _canonical_group)

    def _noc_group_of(self) -> Dict[str, Tuple[str, ...]]:
        """{noc: canonical stacked NoC group} over this grid."""
        return _stack_groups(dict.fromkeys(p.noc for p in self.points),
                             lambda n: get_noc(n).stack_key,
                             _canonical_noc_group)

    def _validate_stacking(self) -> None:
        """Reject stack_key families whose members' state diverges.

        Members of one family run their stage on their own runs of a
        pass's points, and the runs' states are concatenated back into
        one; a policy (or NoC model) that claims a family's key but
        carries, say, an extra state tensor would fail inside the pass
        with an opaque error. Check it here, per (family, geometry
        structure, trace kind) swept together, with a message that
        names the offender.
        """
        group_of = self._arch_group_of()
        noc_group_of = self._noc_group_of()

        def kind(p):
            return (geom_structure(p.geom), p.trace.addr.shape[1:],
                    np.shape(p.trace.insn_per_req), p.trace.n_apps)

        for group in {g for g in group_of.values() if len(g) > 1}:
            members = set(group)
            # one NoC member per stacked NoC group: whether two archs
            # share a state layout does not depend on the NoC member
            # (the NoC state is group-sized either way)
            combos = {kind(p) + (noc_group_of[p.noc],)
                      for p in self.points if p.arch in members}
            for *k, ngroup in combos:
                ref = _signature(group, group[0], *k, ngroup, ngroup[0])
                for arch in group[1:]:
                    if _signature(group, arch, *k, ngroup,
                                  ngroup[0]) != ref:
                        raise ValueError(
                            f"stack_key {get_arch(group[0]).stack_key!r}: "
                            f"architecture {arch!r} does not share "
                            f"{group[0]!r}'s round dataflow (carried "
                            "state differs), so they cannot stack into "
                            f"one pass; give {arch!r} its own stack_key")
        for ngroup in {g for g in noc_group_of.values() if len(g) > 1}:
            members = set(ngroup)
            combos = {kind(p) + (p.arch,)
                      for p in self.points if p.noc in members}
            for *k, arch in combos:
                ref = _signature((arch,), arch, *k, ngroup, ngroup[0])
                for noc in ngroup[1:]:
                    if _signature((arch,), arch, *k, ngroup, noc) != ref:
                        raise ValueError(
                            f"NoC stack_key {get_noc(ngroup[0]).stack_key!r}"
                            f": model {noc!r} does not share "
                            f"{ngroup[0]!r}'s round dataflow (carried NoC "
                            "state differs), so they cannot stack into "
                            f"one pass; give {noc!r} its own stack_key")

    def run(self, n_devices: Optional[int] = None, *,
            telemetry: Optional[TelemetryConfig] = None,
            device=None) -> SweepRun:
        """Sweep every grid point, one batched pass per bucket, on
        ``device`` (default ``"cuda"``). ``n_devices`` is accepted for
        the reference's signature; every pass runs on the one device.

        ``telemetry`` threads windowed observability through every
        pass: the returned :class:`SweepRun` gains ``timelines``, one
        ``repro_torch.obs.SimTimeline`` per point (aligned with
        :attr:`points`), and the results stay bit-equal to a run
        without it."""
        del n_devices
        t0 = time.perf_counter()
        if telemetry is not None:
            for p in self.points:
                telemetry.window_for(p.trace.addr.shape[0])
        device = resolve_device(device)
        group_of = self._arch_group_of()
        noc_group_of = self._noc_group_of()
        buckets: Dict[tuple, List[int]] = {}
        for i, p in enumerate(self.points):
            key = (group_of[p.arch], noc_group_of[p.noc],
                   geom_structure(p.geom), trace_kind(p.trace),
                   resolve_probe_backend(p.probe_backend, device))
            buckets.setdefault(key, []).append(i)

        results: List[Optional[SimResult]] = [None] * len(self.points)
        timelines = None if telemetry is None else [None] * len(self.points)
        used, new_compiles = set(), 0
        for key, idxs in buckets.items():
            exec_key = key + (device.type,)
            used.add(exec_key)
            if exec_key not in _COMPILED_KEYS:
                _COMPILED_KEYS.add(exec_key)
                new_compiles += 1
            pts = [self.points[i] for i in idxs]
            out = _simulate_points(
                [p.arch for p in pts], [p.noc for p in pts],
                [p.trace for p in pts], [p.geom for p in pts],
                probe_backend=key[4], device=device, telemetry=telemetry)
            if telemetry is not None:
                out, tls = out
                for i, tl in zip(idxs, tls):
                    tl.meta["probe_backend"] = self.points[i].probe_backend
                    timelines[i] = tl
            for i, r in zip(idxs, out):
                results[i] = r
        report = SweepReport(n_points=len(self.points),
                             n_executables=len(used),
                             n_compiles=new_compiles, n_devices=1,
                             wall_s=time.perf_counter() - t0)
        return SweepRun(results=results, report=report,  # type: ignore
                        timelines=timelines)


__all__ = ["SweepGrid", "SweepPoint", "SweepReport", "SweepRun",
           "compile_count"]
