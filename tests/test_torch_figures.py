"""Port parity: the paper's figures (``repro_torch.core.figures``) and
their launcher (``repro_torch.launch.paper_repro``).

The reference's figure scripts (``benchmarks/fig8_ipc.py``,
``fig9_kernels.py``, ``fig10_latency.py``, ``table1_landscape.py``) go
through its sweep grid, which does not run under every JAX version, so
their arithmetic is copied here and applied to reference per-point
``simulate()`` results; the port's rows over its own ``run_suite`` at
the same cut ``rounds`` must read the same, name for name and digit for
digit.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import APPS as REF_APPS  # noqa: E402
from repro.core import HIGH_LOCALITY as REF_HIGH  # noqa: E402
from repro.core import LOW_LOCALITY as REF_LOW  # noqa: E402
from repro.core import make_trace as ref_make_trace  # noqa: E402
from repro.core import simulate as ref_simulate  # noqa: E402
from repro.core.metrics import AppResult as RefAppResult  # noqa: E402
from repro_torch.core import (APPS, HIGH_LOCALITY,  # noqa: E402
                              PAPER_ARCHITECTURES, AppResult, geomean,
                              make_trace, normalized_ipc, registered_archs,
                              run_suite, simulate)
from repro_torch.core import figures  # noqa: E402
from repro_torch.launch import paper_repro  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROUNDS = 48
KERNELS = 2
ZOO = ("ata_bypass", "ata_fifo", "ciao", "victim")
#: the zoo table's apps: one trace shape (m=4), one compile per policy
ZOO_APPS = ("SN", "HS3D", "sradv1")


@functools.lru_cache(maxsize=None)
def _ref_suite(archs: tuple, apps: tuple = tuple(REF_APPS)):
    """{app: {arch: reference AppResult}} from per-point simulate()."""
    out = {}
    for app in apps:
        p = dataclasses.replace(REF_APPS[app], rounds=ROUNDS)
        traces = [ref_make_trace(p, kernel=k)
                  for k in range(min(KERNELS, p.n_kernels))]
        out[app] = {arch: RefAppResult(app, arch,
                                       [ref_simulate(arch, t)
                                        for t in traces])
                    for arch in archs}
    return out


@functools.lru_cache(maxsize=None)
def _port_suite(archs: tuple, apps: tuple = tuple(APPS)):
    suite = {}
    for arch in archs:
        part = run_suite(apps=apps, archs=(arch,), kernels_per_app=KERNELS,
                         rounds=ROUNDS, device="cpu")
        for app, cells in part.items():
            suite.setdefault(app, {}).update(cells)
    return suite


# ---- the reference scripts' arithmetic, emit() collecting rows -----------
def ref_fig8(suite):
    rows = []
    ipc = {app: {arch: r[arch].ipc / r["private"].ipc for arch in r}
           for app, r in suite.items()}
    for app in list(REF_HIGH) + list(REF_LOW):
        rows.append((f"fig8.{app}.ata_vs_private",
                     f"{ipc[app]['ata']:.3f}"))
        rows.append((f"fig8.{app}.decoupled_vs_private",
                     f"{ipc[app]['decoupled']:.3f}"))
    hi = float(np.exp(np.mean(np.log([ipc[a]["ata"]
                                      for a in REF_HIGH]))))
    lo = float(np.exp(np.mean(np.log([ipc[a]["ata"]
                                      for a in REF_LOW]))))
    rows.append(("fig8.ata_gain_high_locality_pct", f"{100*(hi-1):.1f}"))
    rows.append(("fig8.ata_gain_low_locality_pct", f"{100*(lo-1):.1f}"))
    return rows


def ref_fig9(suite):
    rows = []
    for app in ("SN", "conv3d", "HS3D", "sradv1"):
        res = suite[app]
        n = len(res["ata"].per_kernel)
        for k in range(n):
            base = res["private"].per_kernel[k].ipc
            rows.append((f"fig9.{app}.k{k}.ata",
                         f"{res['ata'].per_kernel[k].ipc / base:.3f}"))
            rows.append((f"fig9.{app}.k{k}.decoupled",
                         f"{res['decoupled'].per_kernel[k].ipc / base:.3f}"))
    return rows


def ref_fig10(suite):
    rows, ratios_d, ratios_a = [], [], []
    for app, res in suite.items():
        d = res["decoupled"].l1_latency / res["private"].l1_latency
        a = res["ata"].l1_latency / res["private"].l1_latency
        ratios_d.append(d)
        ratios_a.append(a)
        rows.append((f"fig10.{app}.decoupled_latency_x", f"{d:.3f}"))
        rows.append((f"fig10.{app}.ata_latency_x", f"{a:.3f}"))
    rows.append(("fig10.decoupled_latency_increase_pct",
                 f"{100*(np.mean(ratios_d)-1):.1f}"))
    rows.append(("fig10.ata_latency_increase_pct",
                 f"{100*(np.mean(ratios_a)-1):.1f}"))
    return rows


def ref_table1(suite):
    suite = {a: suite[a] for a in REF_HIGH}
    rows = []
    for arch in ("private", "remote", "decoupled", "ata"):
        hr = np.mean([suite[a][arch].l1_hit_rate for a in suite])
        l2 = np.mean([suite[a][arch].l2_accesses for a in suite])
        noc = np.mean([suite[a][arch].per_kernel[0].noc_flits
                       for a in suite])
        rows.append((f"table1.{arch}.l1_hit_rate", f"{hr:.3f}"))
        rows.append((f"table1.{arch}.l2_accesses", f"{l2:.0f}"))
        rows.append((f"table1.{arch}.noc_flits", f"{noc:.0f}"))
    return rows


FIGURES = {"fig8": (figures.fig8, ref_fig8),
           "fig9": (figures.fig9, ref_fig9),
           "fig10": (figures.fig10, ref_fig10),
           "table1": (figures.table1, ref_table1)}


@pytest.mark.parametrize("fig", sorted(FIGURES))
def test_figure_rows_match_reference_arithmetic(fig):
    port_fn, ref_fn = FIGURES[fig]
    want = ref_fn(_ref_suite(PAPER_ARCHITECTURES))
    got = port_fn(_port_suite(PAPER_ARCHITECTURES))
    assert got == want
    assert len(got) > 4


def test_fig9_covers_each_kernel_the_suite_holds():
    rows = dict(figures.fig9(_port_suite(PAPER_ARCHITECTURES)))
    assert len(rows) == 4 * KERNELS * 2
    assert "fig9.HS3D.k1.ata" in rows


def test_paper_rows_are_the_four_figures_in_order():
    suite = _port_suite(PAPER_ARCHITECTURES)
    rows = figures.paper_rows(suite)
    assert rows == (figures.fig8(suite) + figures.fig9(suite)
                    + figures.fig10(suite) + figures.table1(suite))
    assert len({name for name, _ in rows}) == len(rows)


def test_zoo_table_matches_reference_arithmetic():
    archs = ("private",) + ZOO
    ref = _ref_suite(archs, ZOO_APPS)
    want = []
    for arch in archs:
        g = float(np.exp(np.mean(np.log(
            [ref[a][arch].ipc / ref[a]["private"].ipc for a in ref]))))
        hr = np.mean([ref[a][arch].l1_hit_rate for a in ref])
        noc = sum(r.noc_flits for a in ref for r in ref[a][arch].per_kernel)
        want += [(f"zoo.{arch}.ipc_vs_private", f"{g:.4f}"),
                 (f"zoo.{arch}.l1_hit_rate", f"{hr:.4f}"),
                 (f"zoo.{arch}.noc_flits", f"{noc:.0f}")]
    assert figures.zoo_table(_port_suite(archs, ZOO_APPS)) == want


def test_normalized_ipc_and_geomean_match_reference():
    port = _port_suite(PAPER_ARCHITECTURES)
    ref = _ref_suite(PAPER_ARCHITECTURES)
    ipc = normalized_ipc(port)
    for app in APPS:
        for arch in PAPER_ARCHITECTURES:
            want = ref[app][arch].ipc / ref[app]["private"].ipc
            assert math.isclose(ipc[app][arch], want, rel_tol=1e-6)
    assert math.isclose(
        geomean([ipc[a]["ata"] for a in HIGH_LOCALITY]),
        float(np.exp(np.mean(np.log([ref[a]["ata"].ipc
                                     / ref[a]["private"].ipc
                                     for a in HIGH_LOCALITY])))),
        rel_tol=1e-6)


@pytest.mark.parametrize("noc", ["crossbar", "ring"])
def test_app_result_noc_properties_match_reference(noc):
    from repro.core.geometry import PAPER_GEOMETRY as REF_GEOMETRY
    kernels = range(2)
    ref_p = dataclasses.replace(REF_APPS["SN"], rounds=ROUNDS)
    p = dataclasses.replace(APPS["SN"], rounds=ROUNDS)
    ref = RefAppResult("SN", "remote", [
        ref_simulate("remote", ref_make_trace(ref_p, kernel=k),
                     REF_GEOMETRY, noc=noc) for k in kernels])
    got = AppResult("SN", "remote", [
        simulate("remote", make_trace(p, kernel=k), noc=noc, device="cpu")
        for k in kernels])
    for prop in ("noc_flits_injected", "noc_mean_queue_delay",
                 "noc_max_link_util", "noc_flits", "l2_accesses", "ipc",
                 "l1_latency", "l1_hit_rate", "remote_hit_rate"):
        g, w = getattr(got, prop), getattr(ref, prop)
        assert math.isclose(g, w, rel_tol=1e-6, abs_tol=0.0), (prop, g, w)
    assert got.noc_flits_injected > 0
    assert got.noc_max_link_util > 0


def test_paper_repro_prints_the_figure_rows(capsys):
    out = paper_repro.main(["--device", "cpu", "--rounds", "24",
                            "--kernels", "1", "--archs", "victim"])
    printed = capsys.readouterr().out.splitlines()
    assert tuple(out["walls"]) == PAPER_ARCHITECTURES + ("victim",)
    suite = out["suite"]
    assert len(suite) == 10
    assert all(len(c["victim"].per_kernel) == 1 for c in suite.values())
    rows = out["rows"]
    assert rows == figures.paper_rows(suite) + figures.zoo_table(suite)
    assert printed[:len(rows)] == [f"{n},{d}" for n, d in rows]
    assert any(line.startswith("ATA IPC gain, high-locality")
               for line in printed)


def test_paper_repro_arch_choices():
    assert paper_repro.parse_archs("paper") == PAPER_ARCHITECTURES
    assert paper_repro.parse_archs("all") == registered_archs()
    assert paper_repro.parse_archs("victim,ata") == \
        PAPER_ARCHITECTURES + ("victim",)
    with pytest.raises(SystemExit, match="unknown architecture"):
        paper_repro.parse_archs("nope")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paper_repro.main(["--rounds", "8", "--kernels", "1"])
