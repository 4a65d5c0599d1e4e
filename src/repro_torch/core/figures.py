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
  ``ata``-vs-``private`` weighted-speedup ratio per mix.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.metrics import (AppResult, MixRun, geomean,
                                      normalized_ipc)
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


def paper_rows(suite: Suite) -> Rows:
    """Fig. 8, Fig. 9, Fig. 10 and Table I, in that order."""
    return fig8(suite) + fig9(suite) + fig10(suite) + table1(suite)
