"""Sensitivity reports over :class:`~repro_torch.core.sweep.SweepGrid` runs.

The port of the reference's ``repro.core.report`` sensitivity report:
the same sections, cells, schema, ``manifest`` block
(``repro_torch.obs.manifest.run_manifest``) and gate, so the committed
baselines (``benchmarks/baselines/sensitivity_rounds96.json``) gate the
port's reports. The reference's two other report kinds are here too:
:func:`compare_simspeed` gates ``launch/sim_speed.py``'s simulator
throughput reports and :func:`compare_serving` ``launch/serving_scale.py``'s
serving reports, against ``simspeed_rounds64.json`` and
``serving_rounds512.json``. Those baselines name the reference's probe
lowerings; both gates read the baseline's names through
:data:`REFERENCE_BACKENDS` and then compare exactly as the reference does.

:func:`run_sensitivity` sweeps the contention-policy zoo over widened
geometry axes around the paper's Table-II point —

    l1_ways : L1 associativity (structural: regroups per shape)
    noc_bw  : probe-network bandwidth (timing scalar: shares a pass)
    hide    : warp-level latency-hiding depth (timing scalar)

— every (arch x knob-value x kernel) point through *one* grid run, and
aggregates per (arch x geometry) cell into a machine-readable report
dict: IPC, L1 hit rate, remote-probe rate, NoC flits, plus the grid's
:class:`~repro_torch.core.sweep.SweepReport` accounting. :func:`write_report`
serializes it as JSON with a markdown sensitivity table alongside;
``python -m repro_torch.launch.sensitivity`` writes and gates it.

The report doubles as a benchmark-regression gate:
:func:`compare_reports` diffs a fresh report against a committed
baseline and flags per-cell IPC drift beyond a tolerance or
executable-count growth.

Schema history (``SCHEMA_VERSION``):

  1  solo policy-zoo cells only (``config``/``sweep``/``cells``)
  2  adds the multi-tenant ``mix`` section (its own config/sweep/cells
     from :func:`run_mix_sensitivity`); solo sections unchanged
  3  adds the interconnect-topology ``noc`` section
     (:func:`run_noc_sensitivity`: the zoo x {ideal, crossbar, ring} x
     ``noc_bw``); earlier sections unchanged

The gate is *forward-compatible*: a candidate at a newer schema is
compared against an older baseline on the sections the baseline
carries (solo cells, solo executable count, baseline config keys), so
committing a new report section never breaks the gate against an old
baseline — only drift in shared cells does.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.geometry import GpuGeometry, PAPER_GEOMETRY
from repro_torch.core.metrics import (AppResult, MixRun, app_traces,
                                      grid_app_results, kernel_range,
                                      run_mixes)
from repro_torch.core.noc import PAPER_NOCS
from repro_torch.core.sweep import SweepGrid, SweepPoint
from repro_torch.core.trace import WorkloadMix

SCHEMA_VERSION = 3

#: The zoo comparison set: the paper's poles, the probe-broadcast
#: baseline (the only ``noc_bw`` consumer), and both new policies.
SENSITIVITY_ARCHS: Tuple[str, ...] = ("private", "remote", "ata", "ciao",
                                      "victim")

#: Widened geometry axes; the middle value is the paper point.
SENSITIVITY_KNOBS: Dict[str, Tuple] = {
    "l1_ways": (32, 64, 128),
    "noc_bw": (8.0, 16.0, 32.0),
    "hide": (5.0, 10.0, 20.0),
}

#: Metrics reported per (arch x geometry) cell.
CELL_METRICS = ("ipc", "l1_hit_rate", "remote_hit_rate", "noc_flits",
                "l1_latency")

#: The full zoo for the multi-tenant fairness sweep.
MIX_ARCHS: Tuple[str, ...] = ("private", "remote", "decoupled", "ata",
                              "ciao", "victim")

#: ``noc_bw`` values the topology section sweeps (paper point = 16).
NOC_BW_VALUES: Tuple[float, ...] = (4.0, 8.0, 16.0, 32.0)

#: Metrics reported per (arch x noc x noc_bw) topology cell.
#: `noc_flits_injected` is the traffic the modeled interconnect
#: actually routes (probe + remote-data flits), not the legacy
#: memory-side `noc_flits` total.
NOC_CELL_METRICS = ("ipc", "l1_hit_rate", "remote_hit_rate",
                    "noc_flits_injected", "noc_mean_queue_delay",
                    "noc_max_link_util")

#: Locality mixes: high x high, high x low, low x low pairs, plus one
#: 3-app point (hi x hi x lo — ``WorkloadMix`` composes any app count;
#: weighted-speedup ideal = n_apps, so 3-app cells top out at 3.0).
MIX_PAIRINGS: Tuple[Tuple[str, ...], ...] = (
    ("cfd", "b+tree"), ("cfd", "HS3D"), ("HS3D", "sradv1"),
    ("cfd", "b+tree", "HS3D"))


def mix_grid_run(pairings: Sequence[Tuple[str, ...]] = MIX_PAIRINGS,
                 archs: Sequence[str] = MIX_ARCHS,
                 rounds: Optional[int] = None,
                 geom: GpuGeometry = PAPER_GEOMETRY,
                 n_devices: Optional[int] = None, *,
                 probe_backend: Optional[str] = None,
                 device=None) -> MixRun:
    """The canonical (pairing x zoo-arch) fairness grid run.

    One :func:`repro_torch.core.metrics.run_mixes` call over
    ``WorkloadMix(apps=pair)`` per pairing — shared by
    :func:`run_mix_sensitivity` and ``figures.mix_fairness``
    (``launch/sensitivity.py`` computes it once and feeds both).
    """
    mixes = [WorkloadMix(apps=tuple(p)) for p in pairings]
    return run_mixes(mixes, tuple(archs), geom=geom, rounds=rounds,
                     n_devices=n_devices, probe_backend=probe_backend,
                     device=device)


def run_mix_sensitivity(pairings: Sequence[Tuple[str, ...]] = MIX_PAIRINGS,
                        archs: Sequence[str] = MIX_ARCHS,
                        rounds: Optional[int] = None,
                        geom: GpuGeometry = PAPER_GEOMETRY,
                        n_devices: Optional[int] = None,
                        mix_run: Optional[MixRun] = None, *,
                        probe_backend: Optional[str] = None,
                        device=None) -> dict:
    """The multi-tenant ``mix`` report section: fairness of the zoo.

    One :func:`repro_torch.core.metrics.run_mixes` grid run over
    (pairing x arch), reporting weighted speedup, unfairness, mix IPC,
    and per-app IPC / L1 hit rate per cell, plus the grid's own
    executable accounting (kept separate from the solo sweep's so the
    solo regression gate is unaffected by this section existing).
    ``mix_run`` reuses an existing :func:`mix_grid_run` result — it
    must have been produced from the same pairings/archs/rounds.
    """
    archs = tuple(archs)
    run = mix_run if mix_run is not None else mix_grid_run(
        pairings, archs, rounds=rounds, geom=geom, n_devices=n_devices,
        probe_backend=probe_backend, device=device)
    cells = []
    for mid, per_arch in run.results.items():
        for arch, mr in per_arch.items():
            cells.append({
                "mix": mid, "arch": arch,
                "weighted_speedup": float(mr.weighted_speedup),
                "unfairness": float(mr.unfairness),
                "ipc": float(mr.shared.ipc),
                "per_app_ipc": [float(x) for x in mr.per_app_ipc],
                "per_app_l1_hit_rate": [float(x)
                                        for x in mr.per_app_l1_hit_rate],
            })
    return {
        "config": {
            "pairings": [list(p) for p in pairings],
            "archs": list(archs),
            "rounds": rounds,
        },
        "sweep": {
            "n_points": run.report.n_points,
            "n_executables": run.report.n_executables,
            "n_compiles": run.report.n_compiles,
            "n_devices": run.report.n_devices,
            "wall_s": round(run.report.wall_s, 3),
        },
        "cells": cells,
    }


def run_noc_sensitivity(app: str = "HS3D",
                        archs: Sequence[str] = SENSITIVITY_ARCHS,
                        nocs: Sequence[str] = PAPER_NOCS,
                        noc_bw: Sequence[float] = NOC_BW_VALUES,
                        kernels_per_app: Optional[int] = 1,
                        rounds: Optional[int] = None,
                        geom: GpuGeometry = PAPER_GEOMETRY,
                        n_devices: Optional[int] = None, *,
                        probe_backend: Optional[str] = None,
                        device=None) -> dict:
    """The interconnect-topology ``noc`` report section.

    One :class:`~repro_torch.core.sweep.SweepGrid` run over
    (arch x noc model x ``noc_bw``) — the paper's contention-
    sensitivity story per topology: how much of each policy's win
    survives a crossbar with real backpressure or a ring with
    hop-distance latency, as the probe-network bandwidth shrinks. The
    NoC axis stacks (all built-ins share one model family), so the
    whole section runs one pass per architecture family.
    Cells carry the solo metrics plus the interconnect block's queue
    delay and hotspot link utilization; the section keeps its own
    ``sweep`` accounting so the solo regression gate is unaffected.

    The ``ideal`` rows at ``noc_bw`` values the solo section also
    sweeps re-simulate those points rather than borrowing the solo
    results: a few points inside passes the crossbar/ring rows need
    anyway, and the two sections' sweep accounting (and the gate's
    per-section executable budgets) stay independent.
    """
    archs = tuple(archs)
    nocs = tuple(nocs)
    traces = app_traces(app, geom, kernel_range(app, kernels_per_app),
                       rounds=rounds)
    geoms = [dataclasses.replace(geom, noc_bw=v) for v in noc_bw]
    grid = SweepGrid(archs, geoms, traces, nocs=nocs,
                     probe_backends=(probe_backend,))
    run = grid.run(n_devices, device=device)
    agg = grid_app_results(grid, run.results, app)
    cells = []
    for arch in archs:
        for v, g in zip(noc_bw, geoms):
            for noc in nocs:
                cell = {"arch": arch, "noc": noc, "noc_bw": v}
                for metric in NOC_CELL_METRICS:
                    cell[metric] = float(getattr(agg[(arch, g, noc)],
                                                 metric))
                cells.append(cell)
    return {
        "config": {
            "app": app,
            "archs": list(archs),
            "nocs": list(nocs),
            "noc_bw": list(noc_bw),
            "kernels_per_app": kernels_per_app,
            "rounds": rounds,
        },
        "sweep": {
            "n_points": run.report.n_points,
            "n_executables": run.report.n_executables,
            "n_compiles": run.report.n_compiles,
            "n_devices": run.report.n_devices,
            "wall_s": round(run.report.wall_s, 3),
        },
        "cells": cells,
    }


def run_sensitivity(app: str = "HS3D",
                    archs: Sequence[str] = SENSITIVITY_ARCHS,
                    knobs: Optional[Dict[str, Tuple]] = None,
                    kernels_per_app: Optional[int] = 1,
                    rounds: Optional[int] = None,
                    geom: GpuGeometry = PAPER_GEOMETRY,
                    n_devices: Optional[int] = None,
                    mix_pairings: Optional[Sequence[Tuple[str, ...]]]
                    = None,
                    mix_run: Optional[MixRun] = None,
                    noc_models: Optional[Sequence[str]] = None, *,
                    probe_backend: Optional[str] = None,
                    device=None) -> dict:
    """One grid run over (arch x knob-value x kernel); report dict out.

    ``mix_pairings`` (e.g. ``MIX_PAIRINGS``) adds the multi-tenant
    ``mix`` section (schema 2; ``launch/sensitivity.py`` passes it, with
    ``mix_run`` reusing the grid run the fairness rows already paid
    for); ``noc_models`` (e.g. ``PAPER_NOCS``) adds the
    interconnect-topology ``noc`` section (schema 3,
    :func:`run_noc_sensitivity`) — the solo sections are unchanged
    either way and keep their own ``sweep`` accounting, so a schema-1
    baseline still gates them.
    """
    knobs = dict(SENSITIVITY_KNOBS if knobs is None else knobs)
    archs = tuple(archs)
    traces = app_traces(app, geom, kernel_range(app, kernels_per_app),
                        rounds=rounds)
    # Each knob lists the paper point among its values, so several cells
    # share one (arch, geometry): simulate each unique pair once and fan
    # the result out to every cell that references it.
    labels: List[Tuple[str, object, str, GpuGeometry]] = []
    start: Dict[Tuple[str, GpuGeometry], int] = {}
    points: List[SweepPoint] = []
    for knob, values in knobs.items():
        for value in values:
            g = dataclasses.replace(geom, **{knob: value})
            for arch in archs:
                labels.append((knob, value, arch, g))
                if (arch, g) not in start:
                    start[(arch, g)] = len(points)
                    points.extend(SweepPoint(arch, g, t, "ideal",
                                             probe_backend)
                                  for t in traces)
    grid = SweepGrid.from_points(points)
    run = grid.run(n_devices, device=device)

    cells = []
    per_cell = len(traces)
    for knob, value, arch, g in labels:
        lo = start[(arch, g)]
        agg = AppResult(app, arch, run.results[lo:lo + per_cell])
        cell = {"knob": knob, "value": value, "arch": arch}
        for metric in CELL_METRICS:
            cell[metric] = float(getattr(agg, metric))
        cells.append(cell)

    report = {
        # The schema tag is the highest *contiguous* coverage level
        # actually present (sections themselves are gated by presence):
        # schema 3 requires both mix and noc sections, so a noc-only
        # report cannot claim 3 while silently dropping mix coverage —
        # nor spuriously reject a schema-2 candidate that carries it.
        "schema": (3 if (mix_pairings and noc_models)
                   else 2 if mix_pairings else 1),
        "config": {
            "app": app,
            "archs": list(archs),
            "knobs": {k: list(v) for k, v in knobs.items()},
            "kernels_per_app": kernels_per_app,
            "rounds": rounds,
        },
        "sweep": {
            "n_points": run.report.n_points,
            "n_executables": run.report.n_executables,
            "n_compiles": run.report.n_compiles,
            "n_devices": run.report.n_devices,
            "wall_s": round(run.report.wall_s, 3),
        },
        "cells": cells,
    }
    if mix_pairings:
        report["mix"] = run_mix_sensitivity(
            mix_pairings, rounds=rounds, geom=geom, n_devices=n_devices,
            mix_run=mix_run, probe_backend=probe_backend, device=device)
    if noc_models:
        report["noc"] = run_noc_sensitivity(
            app, archs, noc_models, kernels_per_app=kernels_per_app,
            rounds=rounds, geom=geom, n_devices=n_devices,
            probe_backend=probe_backend, device=device)
    # provenance block; compare_reports gates only the baseline's own
    # sections, so adding it never breaks committed baselines
    from repro_torch.obs.manifest import run_manifest
    report["manifest"] = run_manifest(
        phases={"sweep": run.report.wall_s})
    return report


def to_markdown(report: dict) -> str:
    """Render the report as a markdown sensitivity table."""
    cfg = report["config"]
    lines = [
        f"# Sensitivity report — app `{cfg['app']}`",
        "",
        f"archs: {', '.join(cfg['archs'])} · "
        f"kernels/app: {cfg['kernels_per_app']} · "
        f"rounds: {cfg['rounds'] if cfg['rounds'] else 'full'} · "
        f"executables: {report['sweep']['n_executables']}",
        "",
        "| knob | value | arch | IPC | L1 hit | remote hit | NoC flits |",
        "|---|---|---|---|---|---|---|",
    ]
    for c in report["cells"]:
        lines.append(
            f"| {c['knob']} | {c['value']:g} | {c['arch']} "
            f"| {c['ipc']:.3f} | {c['l1_hit_rate']:.4f} "
            f"| {c['remote_hit_rate']:.4f} | {c['noc_flits']:.0f} |")
    mix = report.get("mix")
    if mix:
        lines += [
            "",
            "## Multi-tenant fairness (weighted speedup ideal = 2, "
            "unfairness ideal = 1)",
            "",
            f"pairings: "
            f"{', '.join('x'.join(p) for p in mix['config']['pairings'])}"
            f" · executables: {mix['sweep']['n_executables']}",
            "",
            "| mix | arch | weighted speedup | unfairness | mix IPC |",
            "|---|---|---|---|---|",
        ]
        for c in mix["cells"]:
            lines.append(
                f"| {c['mix']} | {c['arch']} "
                f"| {c['weighted_speedup']:.3f} | {c['unfairness']:.3f} "
                f"| {c['ipc']:.2f} |")
    noc = report.get("noc")
    if noc:
        lines += [
            "",
            "## Interconnect topology sensitivity",
            "",
            f"models: {', '.join(noc['config']['nocs'])} · "
            f"noc_bw: {', '.join(f'{v:g}' for v in noc['config']['noc_bw'])}"
            f" · executables: {noc['sweep']['n_executables']}",
            "",
            "| arch | noc | noc_bw | IPC | queue delay | hotspot util |",
            "|---|---|---|---|---|---|",
        ]
        for c in noc["cells"]:
            lines.append(
                f"| {c['arch']} | {c['noc']} | {c['noc_bw']:g} "
                f"| {c['ipc']:.3f} | {c['noc_mean_queue_delay']:.2f} "
                f"| {c['noc_max_link_util']:.4f} |")
    return "\n".join(lines) + "\n"


def write_report(path: str, report: dict) -> str:
    """Write ``report`` as JSON, plus the markdown table next to it.

    Returns the markdown path (``<path minus .json>.md``).
    """
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    base, ext = os.path.splitext(path)
    md_path = (base if ext == ".json" else path) + ".md"
    with open(md_path, "w") as f:
        f.write(to_markdown(report))
    return md_path


def load_report(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _cell_key(cell: dict) -> tuple:
    return (cell["arch"], cell["knob"], cell["value"])


def _mix_cell_key(cell: dict) -> tuple:
    return (cell["mix"], cell["arch"])


def _noc_cell_key(cell: dict) -> tuple:
    return (cell["arch"], cell["noc"], cell["noc_bw"])


def _compare_section(failures: List[str], baseline: dict, candidate: dict,
                     *, key_fn, metric: str, metric_label: str,
                     rtol: float, label: str) -> None:
    """Shared cell-diff logic for the solo and mix sections."""
    base_exec = baseline["sweep"]["n_executables"]
    cand_exec = candidate["sweep"]["n_executables"]
    if cand_exec > base_exec:
        failures.append(
            f"{label} executable count grew: {base_exec} -> {cand_exec} "
            "(policy stacking / geometry batching regression)")
    cand_cells = {key_fn(c): c for c in candidate["cells"]}
    for base_cell in baseline["cells"]:
        key = key_fn(base_cell)
        cell = cand_cells.get(key)
        if cell is None:
            failures.append(f"{label} cell missing from candidate: {key}")
            continue
        base_v, cand_v = base_cell[metric], cell[metric]
        drift = abs(cand_v - base_v) / abs(base_v)
        if drift > rtol:
            failures.append(
                f"{label} {metric_label} drift {drift:+.1%} beyond "
                f"±{rtol:.0%} at {key}: {base_v:.3f} -> {cand_v:.3f}")


def compare_reports(baseline: dict, candidate: dict, *,
                    ipc_rtol: float = 0.10) -> List[str]:
    """Regression-gate diff; returns human-readable failure strings.

    Fails on: schema *downgrade* or config mismatch (the runs are not
    comparable), missing cells, per-cell IPC drift beyond ``ipc_rtol``
    in *either* direction (improvements require a conscious baseline
    update too), and executable-count growth (compile-count
    regressions) — per section.

    Schema compatibility: a candidate at a **newer** schema than the
    baseline is legal — the gate compares the sections and config keys
    the baseline carries and ignores candidate-only additions (e.g. a
    schema-1 baseline gates a schema-2/3 candidate on its solo cells
    and tolerates the new ``mix``/``noc`` sections). The ``mix``
    section is gated (on ``weighted_speedup`` drift and its own
    executable count) only when both reports carry it, and likewise
    the ``noc`` topology section (on per-cell IPC drift).
    """
    failures: List[str] = []
    base_schema = baseline.get("schema")
    cand_schema = candidate.get("schema")
    if base_schema is None or cand_schema is None \
            or cand_schema < base_schema:
        return [f"schema mismatch: baseline {base_schema} "
                f"vs candidate {cand_schema} (candidate must be at the "
                "baseline's schema or newer)"]
    for key, value in baseline["config"].items():
        if candidate["config"].get(key) != value:
            return [f"config mismatch — reports are not comparable: "
                    f"baseline {baseline['config']} "
                    f"vs candidate {candidate['config']}"]

    _compare_section(failures, baseline, candidate, key_fn=_cell_key,
                     metric="ipc", metric_label="IPC", rtol=ipc_rtol,
                     label="solo")
    if "mix" in baseline:
        if "mix" not in candidate:
            failures.append("mix section missing from candidate "
                            "(baseline carries one)")
        else:
            _compare_section(failures, baseline["mix"], candidate["mix"],
                             key_fn=_mix_cell_key,
                             metric="weighted_speedup",
                             metric_label="weighted-speedup",
                             rtol=ipc_rtol, label="mix")
    if "noc" in baseline:
        if "noc" not in candidate:
            failures.append("noc section missing from candidate "
                            "(baseline carries one)")
        else:
            _compare_section(failures, baseline["noc"], candidate["noc"],
                             key_fn=_noc_cell_key, metric="ipc",
                             metric_label="IPC", rtol=ipc_rtol,
                             label="noc")
    return failures


#: The reference's probe lowerings by the port's names: a committed
#: baseline's backend names are read through this table, so a reference
#: baseline gates a port report. Names outside it (the port's own) pass
#: through unchanged.
REFERENCE_BACKENDS: Dict[str, str] = {"lax": "torch",
                                      "lax_unfused": "torch_unfused",
                                      "pallas": "cuda"}


def _port_names(report: dict) -> dict:
    """``report`` with its simspeed cells' ``backend`` and its config's
    ``probe_backend`` read through :data:`REFERENCE_BACKENDS`."""
    out = dict(report)
    if "cells" in out:
        out["cells"] = [
            dict(c, backend=REFERENCE_BACKENDS.get(c["backend"],
                                                   c["backend"]))
            if "backend" in c else c for c in out["cells"]]
    if "probe_backend" in out.get("config", {}):
        pb = out["config"]["probe_backend"]
        out["config"] = dict(out["config"],
                             probe_backend=REFERENCE_BACKENDS.get(pb, pb))
    return out


def compare_simspeed(baseline: dict, candidate: dict, *,
                     speedup_rtol: float = 0.30,
                     rps_rtol: Optional[float] = None) -> List[str]:
    """Regression gate for ``launch/sim_speed.py`` throughput reports
    (``kind == "simspeed"``); returns human-readable failure strings.

    The blocking check is the **fused speedup ratio**: rounds/sec of the
    fused ``torch`` backend over the historical ``torch_unfused`` chain,
    measured back to back on one device, so it is machine-portable. The
    gate fails when the candidate's ratio falls below the baseline's by
    more than ``speedup_rtol`` (one-sided: a faster fused path is never
    a regression). Absolute rounds/sec depends on the host and is gated
    only when ``rps_rtol`` is given. Also fails on config mismatch,
    schema downgrade, backends missing from the candidate, and
    per-backend executable-count growth. The baseline's backend names
    are read through :data:`REFERENCE_BACKENDS`.
    """
    for rep, who in ((baseline, "baseline"), (candidate, "candidate")):
        if rep.get("kind") != "simspeed":
            return [f"{who} is not a simspeed report "
                    f"(kind={rep.get('kind')!r})"]
    baseline = _port_names(baseline)
    if candidate.get("schema", 0) < baseline.get("schema", 0):
        return [f"schema downgrade: baseline {baseline.get('schema')} "
                f"vs candidate {candidate.get('schema')}"]
    for key, value in baseline["config"].items():
        if candidate["config"].get(key) != value:
            return [f"config mismatch — reports are not comparable: "
                    f"baseline {baseline['config']} "
                    f"vs candidate {candidate['config']}"]

    failures: List[str] = []
    cand_cells = {c["backend"]: c for c in candidate["cells"]}
    for base_cell in baseline["cells"]:
        backend = base_cell["backend"]
        cell = cand_cells.get(backend)
        if cell is None:
            failures.append(f"backend missing from candidate: {backend}")
            continue
        if cell["n_executables"] > base_cell["n_executables"]:
            failures.append(
                f"{backend} executable count grew: "
                f"{base_cell['n_executables']} -> "
                f"{cell['n_executables']}")
        if rps_rtol is not None:
            base_v, cand_v = (base_cell["rounds_per_sec"],
                              cell["rounds_per_sec"])
            if cand_v < base_v * (1 - rps_rtol):
                failures.append(
                    f"{backend} rounds/sec fell beyond -{rps_rtol:.0%}: "
                    f"{base_v:.0f} -> {cand_v:.0f}")
    base_ratio = baseline.get("headline", {}).get("fused_speedup")
    cand_ratio = candidate.get("headline", {}).get("fused_speedup")
    if base_ratio is not None:
        if cand_ratio is None:
            failures.append("fused_speedup headline missing from "
                            "candidate")
        elif cand_ratio < base_ratio * (1 - speedup_rtol):
            failures.append(
                f"fused speedup fell beyond -{speedup_rtol:.0%}: "
                f"{base_ratio:.3f}x -> {cand_ratio:.3f}x "
                "(the fused torch probe path lost its win over "
                "torch_unfused)")
    return failures


def _serving_cell_key(cell: dict) -> tuple:
    # pre-batching (schema 1) cells carry no "slots" key: B=1
    return (cell["shards"], cell["mix"], cell["policy"],
            cell.get("slots", 1))


#: Absolute floor on the batched modeled-throughput ratio (B=max vs
#: B=1 requests per kcycle): the batched-admission acceptance bar.
BATCHED_SPEEDUP_FLOOR = 1.5


def compare_serving(baseline: dict, candidate: dict, *,
                    hit_rtol: float = 0.005,
                    latency_rtol: Optional[float] = None,
                    batched_rtol: float = 0.15,
                    wall_rtol: Optional[float] = None) -> List[str]:
    """Regression gate for ``launch/serving_scale.py`` reports
    (``kind == "serving"``); returns human-readable failure strings.

    The engine is integer-deterministic on a seeded stream, so per
    (shards x mix x policy x slots) cell the **probe-message and request
    counts gate exactly** and the **hit rate** within ``hit_rtol`` (the
    tolerance absorbs only the float division). Cells without a
    ``slots`` key (schema-1 baselines) compare as ``slots=1``. Modeled
    p99 latency is gated only when ``latency_rtol`` is given.

    The ``batched_model_speedup`` headline (worst-cell modeled
    requests-per-kcycle ratio, B=max vs B=1) gates **one-sided**: it
    must clear both :data:`BATCHED_SPEEDUP_FLOOR` and ``baseline * (1 -
    batched_rtol)``. The wall-clock ``batched_wall_speedup`` is gated
    only when ``wall_rtol`` is given; per-cell wall throughput never is.
    Also fails on kind/config mismatch (the config's ``probe_backend``
    included, the baseline's read through :data:`REFERENCE_BACKENDS`),
    schema downgrade and missing cells.
    """
    for rep, who in ((baseline, "baseline"), (candidate, "candidate")):
        if rep.get("kind") != "serving":
            return [f"{who} is not a serving report "
                    f"(kind={rep.get('kind')!r})"]
    baseline = _port_names(baseline)
    if candidate.get("schema", 0) < baseline.get("schema", 0):
        return [f"schema downgrade: baseline {baseline.get('schema')} "
                f"vs candidate {candidate.get('schema')}"]
    for key, value in baseline["config"].items():
        if candidate["config"].get(key) != value:
            return [f"config mismatch — reports are not comparable: "
                    f"baseline {baseline['config']} "
                    f"vs candidate {candidate['config']}"]

    failures: List[str] = []
    cand_cells = {_serving_cell_key(c): c for c in candidate["cells"]}
    for base_cell in baseline["cells"]:
        key = _serving_cell_key(base_cell)
        cell = cand_cells.get(key)
        if cell is None:
            failures.append(f"serving cell missing from candidate: {key}")
            continue
        if cell["probe_messages"] != base_cell["probe_messages"]:
            failures.append(
                f"probe-message count changed at {key}: "
                f"{base_cell['probe_messages']} -> "
                f"{cell['probe_messages']} (directory/probe accounting "
                "drifted — the stream is seeded, this must be exact)")
        if cell["requests"] != base_cell["requests"]:
            failures.append(
                f"request count changed at {key}: "
                f"{base_cell['requests']} -> {cell['requests']} "
                "(stream generation drifted under an identical config)")
        base_v, cand_v = base_cell["hit_rate"], cell["hit_rate"]
        drift = abs(cand_v - base_v) / max(abs(base_v), 1e-9)
        if drift > hit_rtol:
            failures.append(
                f"hit-rate drift {drift:+.2%} beyond ±{hit_rtol:.1%} "
                f"at {key}: {base_v:.4f} -> {cand_v:.4f}")
        if latency_rtol is not None:
            base_v, cand_v = base_cell["p99_latency"], cell["p99_latency"]
            drift = abs(cand_v - base_v) / max(abs(base_v), 1e-9)
            if drift > latency_rtol:
                failures.append(
                    f"p99-latency drift {drift:+.2%} beyond "
                    f"±{latency_rtol:.0%} at {key}: "
                    f"{base_v:.1f} -> {cand_v:.1f}")

    base_head = baseline.get("headline", {})
    cand_head = candidate.get("headline", {})
    base_ratio = base_head.get("batched_model_speedup")
    if base_ratio is not None:
        cand_ratio = cand_head.get("batched_model_speedup")
        if cand_ratio is None:
            failures.append("batched_model_speedup headline missing "
                            "from candidate")
        else:
            floor = max(BATCHED_SPEEDUP_FLOOR,
                        base_ratio * (1 - batched_rtol))
            if cand_ratio < floor:
                failures.append(
                    f"batched modeled speedup fell below "
                    f"{floor:.3f}x (abs floor "
                    f"{BATCHED_SPEEDUP_FLOOR}x, baseline "
                    f"{base_ratio:.3f}x -{batched_rtol:.0%}): "
                    f"{cand_ratio:.3f}x at "
                    f"B={cand_head.get('batched_slots')} "
                    "(batched admission stopped amortizing rounds)")
        if wall_rtol is not None:
            base_w = base_head.get("batched_wall_speedup")
            cand_w = cand_head.get("batched_wall_speedup")
            if base_w is not None and cand_w is not None \
                    and cand_w < base_w * (1 - wall_rtol):
                failures.append(
                    f"batched wall speedup fell beyond "
                    f"-{wall_rtol:.0%}: {base_w:.3f}x -> "
                    f"{cand_w:.3f}x")
    return failures
