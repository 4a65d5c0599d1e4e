"""The paper's figures as rows, computed from a ``run_suite`` result.

Each function takes a ``{app: {arch: AppResult}}`` suite and returns
``(name, derived)`` rows: the names, number formats and arithmetic of
the reference's figure scripts (``benchmarks/fig8_ipc.py``,
``fig9_kernels.py``, ``fig10_latency.py``, ``table1_landscape.py``), so
one suite run gives every figure with no extra simulation. The figures
read the apps and kernels the suite holds; a figure's architectures
must be in it.

* :func:`fig8` — whole-app IPC of ``ata`` and ``decoupled`` normalized
  to ``private``, and ``ata``'s geomean gain per locality class;
* :func:`fig9` — per-kernel IPC of SN, conv3d, HS3D and sradv1;
* :func:`fig10` — L1 access latency against ``private``, per app and as
  the mean of the per-app ratios;
* :func:`table1` — L1 hit rate, L2 accesses and kernel 0's NoC flits of
  the four paper architectures over the high-locality apps;
* :func:`zoo_table` — every architecture of the suite: geomean IPC
  against ``private``, mean L1 hit rate, NoC flits over all apps;
* :func:`mix_fairness` — ``benchmarks/fig_mix_fairness.py``'s rows from
  one ``run_mixes`` result (a ``MixRun``, not a suite): weighted
  speedup, unfairness and mix IPC per (mix, arch), and the
  ``ata``-vs-``private`` weighted-speedup ratio per mix;
* :func:`sweep_geometry` — ``benchmarks/fig_sweep_geometry.py``'s rows
  from one :func:`sweep_geometry_run`: ``ata``'s IPC against
  ``private``'s at every value of six geometry knobs (and ``remote``'s on
  the ``noc_bw`` knob);
* :func:`noc_topology` — ``benchmarks/fig_noc_topology.py``'s rows from
  one :func:`noc_topology_run`: the ``ata``/``private`` and
  ``remote``/``private`` IPC ratios and ``ata``'s mean NoC queue delay
  per (NoC model, ``noc_bw``).

The two grid runners put their whole grid through one ``SweepGrid.run``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.geometry import GpuGeometry, PAPER_GEOMETRY
from repro_torch.core.metrics import (AppResult, MixRun, app_traces,
                                      geomean, grid_app_results,
                                      kernel_range, normalized_ipc)
from repro_torch.core.noc import PAPER_NOCS
from repro_torch.core.report import NOC_BW_VALUES
from repro_torch.core.sweep import SweepGrid, SweepPoint, SweepReport
from repro_torch.core.trace import HIGH_LOCALITY, LOW_LOCALITY

Suite = Dict[str, Dict[str, AppResult]]
Rows = List[Tuple[str, str]]

FIG9_APPS: Tuple[str, ...] = ("SN", "conv3d", "HS3D", "sradv1")
TABLE1_ARCHS: Tuple[str, ...] = ("private", "remote", "decoupled", "ata")


def _ordered(suite: Suite, apps: Sequence[str]) -> List[str]:
    return [a for a in apps if a in suite]


def fig8(suite: Suite) -> Rows:
    """Fig. 8: normalized IPC per app and ``ata``'s geomean gains."""
    ipc = normalized_ipc(suite)
    rows = []
    for app in _ordered(suite, list(HIGH_LOCALITY) + list(LOW_LOCALITY)):
        rows.append((f"fig8.{app}.ata_vs_private",
                     f"{ipc[app]['ata']:.3f}"))
        rows.append((f"fig8.{app}.decoupled_vs_private",
                     f"{ipc[app]['decoupled']:.3f}"))
    for cls, apps in (("high", HIGH_LOCALITY), ("low", LOW_LOCALITY)):
        present = _ordered(suite, apps)
        if present:
            g = geomean([ipc[a]["ata"] for a in present])
            rows.append((f"fig8.ata_gain_{cls}_locality_pct",
                         f"{100 * (g - 1):.1f}"))
    return rows


def fig9(suite: Suite) -> Rows:
    """Fig. 9: per-kernel IPC of ``ata`` and ``decoupled`` against
    ``private`` for every kernel the suite holds of SN, conv3d, HS3D and
    sradv1."""
    rows = []
    for app in _ordered(suite, FIG9_APPS):
        res = suite[app]
        for k in range(len(res["ata"].per_kernel)):
            base = res["private"].per_kernel[k].ipc
            rows.append((f"fig9.{app}.k{k}.ata",
                         f"{res['ata'].per_kernel[k].ipc / base:.3f}"))
            rows.append((f"fig9.{app}.k{k}.decoupled",
                         f"{res['decoupled'].per_kernel[k].ipc / base:.3f}"))
    return rows


def fig10(suite: Suite) -> Rows:
    """Fig. 10: L1 latency of ``decoupled`` and ``ata`` against
    ``private``, per app and as the mean of the per-app ratios."""
    rows, ratios_d, ratios_a = [], [], []
    for app, res in suite.items():
        d = res["decoupled"].l1_latency / res["private"].l1_latency
        a = res["ata"].l1_latency / res["private"].l1_latency
        ratios_d.append(d)
        ratios_a.append(a)
        rows.append((f"fig10.{app}.decoupled_latency_x", f"{d:.3f}"))
        rows.append((f"fig10.{app}.ata_latency_x", f"{a:.3f}"))
    rows.append(("fig10.decoupled_latency_increase_pct",
                 f"{100 * (np.mean(ratios_d) - 1):.1f}"))
    rows.append(("fig10.ata_latency_increase_pct",
                 f"{100 * (np.mean(ratios_a) - 1):.1f}"))
    return rows


def table1(suite: Suite) -> Rows:
    """Table I: hit rate, L2 demand and NoC contention per paper
    architecture, averaged over the suite's high-locality apps."""
    apps = _ordered(suite, HIGH_LOCALITY)
    rows = []
    for arch in TABLE1_ARCHS:
        hr = np.mean([suite[a][arch].l1_hit_rate for a in apps])
        l2 = np.mean([suite[a][arch].l2_accesses for a in apps])
        noc = np.mean([suite[a][arch].per_kernel[0].noc_flits
                       for a in apps])
        rows.append((f"table1.{arch}.l1_hit_rate", f"{hr:.3f}"))
        rows.append((f"table1.{arch}.l2_accesses", f"{l2:.0f}"))
        rows.append((f"table1.{arch}.noc_flits", f"{noc:.0f}"))
    return rows


def zoo_table(suite: Suite) -> Rows:
    """Every architecture of the suite: geomean over apps of its IPC
    against ``private``, mean over apps of its L1 hit rate, and its NoC
    flits summed over every kernel of every app."""
    ipc = normalized_ipc(suite)
    archs = list(next(iter(suite.values())))
    rows = []
    for arch in archs:
        g = geomean([ipc[app][arch] for app in suite])
        hr = np.mean([suite[app][arch].l1_hit_rate for app in suite])
        noc = sum(suite[app][arch].noc_flits for app in suite)
        rows.append((f"zoo.{arch}.ipc_vs_private", f"{g:.4f}"))
        rows.append((f"zoo.{arch}.l1_hit_rate", f"{hr:.4f}"))
        rows.append((f"zoo.{arch}.noc_flits", f"{noc:.0f}"))
    return rows


def mix_fairness(mix_run: MixRun) -> Rows:
    """Multi-tenant fairness per (mix, arch), and ``ata``'s weighted
    speedup over ``private``'s per mix where both ran."""
    rows = []
    for mid, per_arch in mix_run.results.items():
        for arch, mr in per_arch.items():
            rows.append((f"fig_mix.{mid}.{arch}.weighted_speedup",
                         f"{mr.weighted_speedup:.3f}"))
            rows.append((f"fig_mix.{mid}.{arch}.unfairness",
                         f"{mr.unfairness:.3f}"))
            rows.append((f"fig_mix.{mid}.{arch}.ipc",
                         f"{mr.shared.ipc:.2f}"))
        if "ata" in per_arch and "private" in per_arch:
            ratio = (per_arch["ata"].weighted_speedup
                     / per_arch["private"].weighted_speedup)
            rows.append((f"fig_mix.{mid}.ata_vs_private_ws",
                         f"{ratio:.3f}"))
    rows.append(("fig_mix.executables",
                 str(mix_run.report.n_executables)))
    return rows


#: The high-locality app both grid figures sweep.
FIGURE_APP = "cfd"
#: Geometry knob -> swept values; the middle value is the paper
#: geometry's own. ``svc_port``, ``noc_bw`` and ``hide`` are timing
#: scalars (one pass); the others change tensor shapes (a pass each).
KNOBS: Dict[str, Tuple] = {
    "l1_sets": (4, 8, 16),
    "l1_ways": (32, 64, 128),
    "svc_port": (1, 2, 4),
    "cluster_size": (5, 10, 15),
    "noc_bw": (8.0, 16.0, 32.0),
    "hide": (5.0, 10.0, 20.0),
}
SWEEP_ARCHS: Tuple[str, ...] = ("private", "ata")
NOC_ARCHS: Tuple[str, ...] = ("private", "remote", "ata")


class GridFigure(NamedTuple):
    """A grid figure's results: ``{(arch, geom, noc): AppResult}`` over
    the kernels swept, and the grid run's pass accounting."""
    cells: Dict[tuple, AppResult]
    report: SweepReport


def knob_geometry(knob: str, value) -> GpuGeometry:
    """The paper geometry with one knob set to ``value``."""
    return dataclasses.replace(PAPER_GEOMETRY, **{knob: value})


def _grid_figure(cells: Sequence[Tuple[str, GpuGeometry, str]],
                 kernels_per_app: Optional[int], rounds: Optional[int],
                 device) -> GridFigure:
    """Every (arch, geometry, noc) cell over the app's kernels, in one
    ``SweepGrid.run``; no knob changes the core count, so every
    geometry takes the paper geometry's traces."""
    traces = app_traces(FIGURE_APP, PAPER_GEOMETRY,
                        kernel_range(FIGURE_APP, kernels_per_app),
                        rounds=rounds)
    grid = SweepGrid.from_points(SweepPoint(arch, g, t, noc)
                                 for arch, g, noc in cells for t in traces)
    run = grid.run(device=device)
    return GridFigure(grid_app_results(grid, run.results, FIGURE_APP),
                      run.report)


def sweep_geometry_run(kernels_per_app: Optional[int] = 1,
                       rounds: Optional[int] = None,
                       device=None) -> GridFigure:
    """``ata`` and ``private`` at every knob value (``remote`` too on the
    ``noc_bw`` knob), each distinct (arch, geometry) cell once."""
    cells = []
    for knob, values in KNOBS.items():
        archs = SWEEP_ARCHS + (("remote",) if knob == "noc_bw" else ())
        cells += [(a, knob_geometry(knob, v), "ideal")
                  for v in values for a in archs]
    return _grid_figure(list(dict.fromkeys(cells)), kernels_per_app,
                        rounds, device)


def sweep_geometry(fig: GridFigure) -> Rows:
    """The ata/private IPC ratio per knob value, and remote/private on
    the ``noc_bw`` knob."""
    rows = []
    for knob, values in KNOBS.items():
        for v in values:
            g = knob_geometry(knob, v)
            base = fig.cells[("private", g, "ideal")].ipc
            ratio = fig.cells[("ata", g, "ideal")].ipc / base
            rows.append((f"fig_sweep.{FIGURE_APP}.{knob}={v}.ata_vs_private",
                         f"{ratio:.3f}"))
            if knob == "noc_bw":
                rratio = fig.cells[("remote", g, "ideal")].ipc / base
                rows.append((f"fig_sweep.{FIGURE_APP}.{knob}={v}"
                             ".remote_vs_private", f"{rratio:.3f}"))
    return rows


def noc_topology_run(kernels_per_app: Optional[int] = 1,
                     rounds: Optional[int] = None,
                     archs: Sequence[str] = NOC_ARCHS,
                     nocs: Sequence[str] = PAPER_NOCS,
                     noc_bw: Sequence[float] = NOC_BW_VALUES,
                     device=None) -> GridFigure:
    """The archs x NoC models x ``noc_bw`` grid (the report's ``noc``
    section's topology grid, on one app)."""
    archs, nocs, noc_bw = tuple(archs), tuple(nocs), tuple(noc_bw)
    missing = {a for a in ("private", "ata") if a not in archs}
    if missing:
        raise ValueError(
            "fig_noc_topology needs 'private' and 'ata' for the headline "
            f"ata_vs_private ratio; archs={archs} is missing "
            f"{sorted(missing)}")
    return _grid_figure([(a, knob_geometry("noc_bw", v), n) for a in archs
                         for v in noc_bw for n in nocs],
                        kernels_per_app, rounds, device)


def noc_topology(fig: GridFigure) -> Rows:
    """Per (NoC model, ``noc_bw``): ata/private, remote/private where
    ``remote`` ran, and ``ata``'s mean queue delay; then the grid's pass
    count."""
    keys = list(fig.cells)
    nocs = list(dict.fromkeys(k[2] for k in keys))
    geoms = list(dict.fromkeys(k[1] for k in keys))
    has_remote = any(k[0] == "remote" for k in keys)
    rows = []
    for noc in nocs:
        for g in geoms:
            v = g.noc_bw
            ata = fig.cells[("ata", g, noc)]
            base = fig.cells[("private", g, noc)].ipc
            pre = f"fig_noc.{FIGURE_APP}.{noc}.noc_bw={v:g}"
            rows.append((f"{pre}.ata_vs_private", f"{ata.ipc / base:.3f}"))
            if has_remote:
                rratio = fig.cells[("remote", g, noc)].ipc / base
                rows.append((f"{pre}.remote_vs_private", f"{rratio:.3f}"))
            rows.append((f"{pre}.ata_queue_delay",
                         f"{ata.noc_mean_queue_delay:.2f}"))
    rows.append(("fig_noc.executables", str(fig.report.n_executables)))
    return rows


def paper_rows(suite: Suite) -> Rows:
    """Fig. 8, Fig. 9, Fig. 10 and Table I, in that order."""
    return fig8(suite) + fig9(suite) + fig10(suite) + table1(suite)
