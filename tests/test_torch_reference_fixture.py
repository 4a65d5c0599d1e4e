"""Reference results the CUDA card is checked against.

The machine with the card has no JAX, so the reference package's
``simulate()`` results for kernel 0 of every app at the full 1536
rounds are stored in two files: the four paper architectures in
``src/repro_torch/data/reference_kernel0.json``, the four zoo policies
(``ata_bypass``, ``ata_fifo``, ``ciao``, ``victim``) in
``src/repro_torch/data/reference_zoo_kernel0.json``. ``chip_smoke.py``
holds the port's full-suite runs against them. A third file,
``src/repro_torch/data/reference_mix_cfd_HS3D.json``, holds one
multi-tenant pairing at full length: ``WorkloadMix(("cfd", "HS3D"))``
at 1536 rounds under ``private`` and ``ata``, the composed trace and
both slots' solo traces, each through per-point ``simulate()``
(``chip_smoke.py``'s ``sweep`` phase holds the port's ``run_mixes``
against it). A fourth, ``src/repro_torch/data/reference_noc_HS3D.json``,
holds the non-ideal interconnects: HS3D kernel 0 at 96 rounds under
``ata`` and ``victim`` x ``crossbar`` and ``ring`` x the sensitivity
report's ``noc_bw`` values, each through per-point ``simulate()`` (the
``sweep`` phase holds those points of the report's NoC section against
it). A fifth, ``src/repro_torch/data/reference_telemetry.json``, holds
windowed telemetry: the reference ``SimTimeline``'s cumulative arrays
(window 32) and the ``SimResult`` of the telemetry capture's point
(``cfd`` kernel 0, ``ata``, ``crossbar``, 96 rounds) and of ``cfd``
kernel 0 under ``ata`` and ``victim`` at 1536 rounds, each through
per-point ``simulate(telemetry=...)`` (``chip_smoke.py``'s ``telemetry``
phase holds the port's timelines against it).

Regenerate them with::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_reference_fixture.py [paper|zoo|mix|noc|telemetry]

(all five when no argument is given). The tests recompute cells of
each file with JAX and check the files.
"""
import dataclasses
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import APPS, PAPER_GEOMETRY, make_trace, simulate  # noqa: E402
from repro.core import WorkloadMix  # noqa: E402
from repro.core.arch import PAPER_ARCHITECTURES  # noqa: E402
from repro.core.arch import registered_archs  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DATA = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch",
                    "data")
FIXTURE = os.path.join(DATA, "reference_kernel0.json")
ZOO_FIXTURE = os.path.join(DATA, "reference_zoo_kernel0.json")
MIX_FIXTURE = os.path.join(DATA, "reference_mix_cfd_HS3D.json")
#: the full-length pairing: a sharer co-run with a streamer
MIX_APPS = ("cfd", "HS3D")
MIX_ARCHS = ("private", "ata")
NOC_FIXTURE = os.path.join(DATA, "reference_noc_HS3D.json")
#: the NoC file's points: the stacked ATA family of the sensitivity
#: report's NoC section, on the two models with queues and hops, at the
#: section's noc_bw values (repro.core.report.NOC_BW_VALUES)
NOC_APP, NOC_ROUNDS = "HS3D", 96
NOC_ARCHS = ("ata", "victim")
NOC_MODELS = ("crossbar", "ring")
NOC_BW = (4.0, 8.0, 16.0, 32.0)
TELEMETRY_FIXTURE = os.path.join(DATA, "reference_telemetry.json")
#: the telemetry file's points: name -> (arch, noc, rounds), cfd kernel 0
#: (the first is benchmarks/telemetry_capture.py's simulator point; the
#: per-app latency sum of ``remote`` passes 2**20, where the float32
#: order of its adds shows in the window snapshots)
TELEMETRY_WINDOW = 32
TELEMETRY_POINTS = {"capture": ("ata", "crossbar", 96),
                    "ata_1536": ("ata", "ideal", 1536),
                    "victim_1536": ("victim", "ideal", 1536),
                    "remote_1536": ("remote", "ideal", 1536)}
#: the reference's registered architectures beyond the paper's four
ZOO_ARCHITECTURES = tuple(a for a in registered_archs()
                          if a not in PAPER_ARCHITECTURES)


def result_dict(r) -> dict:
    """A SimResult as plain JSON data (nested blocks as dicts)."""
    d = r._asdict()
    d["per_app"] = [a._asdict() for a in r.per_app]
    d["noc"] = r.noc._asdict()
    return d


def reference_cell(app: str, arch: str) -> dict:
    return result_dict(simulate(arch, make_trace(APPS[app], kernel=0)))


def write_fixture(path: str = FIXTURE,
                  archs=PAPER_ARCHITECTURES) -> None:
    results = {app: {arch: reference_cell(app, arch)
                     for arch in archs} for app in APPS}
    doc = {
        "what": "repro.core.simulate() of kernel 0 of every app, paper "
                "geometry, ideal NoC, default probe backend",
        "rounds": {app: APPS[app].rounds for app in APPS},
        "results": results,
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def mix_traces():
    """{"shared": composed trace, "solo": [slot traces]} of the pairing
    (seed 0, the paper's 30 cores, the mix's own 1536 rounds)."""
    mix = WorkloadMix(apps=MIX_APPS)
    return {"shared": mix.compose(30, seed=0),
            "solo": mix.component_traces(30, seed=0)}


def write_mix_fixture(path: str = MIX_FIXTURE) -> None:
    traces = mix_traces()
    results = {arch: {
        "shared": result_dict(simulate(arch, traces["shared"])),
        "solo": [result_dict(simulate(arch, t)) for t in traces["solo"]]}
        for arch in MIX_ARCHS}
    doc = {
        "what": "repro.core.simulate() of WorkloadMix(apps=('cfd', "
                "'HS3D')): the composed trace and each slot's solo trace "
                "(component_traces), seed 0, 30 cores, paper geometry, "
                "ideal NoC, default probe backend",
        "apps": list(MIX_APPS),
        "rounds": int(traces["shared"].addr.shape[0]),
        "results": results,
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def noc_trace():
    """HS3D kernel 0 cut to 96 rounds, 30 cores."""
    return make_trace(dataclasses.replace(APPS[NOC_APP], rounds=NOC_ROUNDS),
                      kernel=0)


def reference_noc_cell(arch: str, noc: str, noc_bw: float) -> dict:
    geom = dataclasses.replace(PAPER_GEOMETRY, noc_bw=noc_bw)
    return result_dict(simulate(arch, noc_trace(), geom, noc=noc))


def write_noc_fixture(path: str = NOC_FIXTURE) -> None:
    results = {arch: {noc: {repr(bw): reference_noc_cell(arch, noc, bw)
                            for bw in NOC_BW}
                      for noc in NOC_MODELS}
               for arch in NOC_ARCHS}
    doc = {
        "what": "repro.core.simulate() of HS3D kernel 0 at 96 rounds, "
                "paper geometry with noc_bw replaced, per (arch, noc, "
                "noc_bw), default probe backend",
        "app": NOC_APP, "kernel": 0, "rounds": NOC_ROUNDS,
        "noc_bw": list(NOC_BW),
        "results": results,
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def reference_telemetry_point(name: str) -> dict:
    """One point of the telemetry file, recomputed with JAX."""
    from repro.core import TelemetryConfig
    arch, noc, rounds = TELEMETRY_POINTS[name]
    trace = make_trace(dataclasses.replace(APPS["cfd"], rounds=rounds),
                       kernel=0)
    res, tl = simulate(arch, trace, noc=noc,
                       telemetry=TelemetryConfig(window=TELEMETRY_WINDOW))
    return {"arch": arch, "noc": noc, "app": "cfd", "kernel": 0,
            "rounds": rounds, "result": result_dict(res),
            "dtypes": {k: str(v.dtype) for k, v in tl.cumulative.items()},
            "cumulative": {k: v.tolist() for k, v in tl.cumulative.items()}}


def write_telemetry_fixture(path: str = TELEMETRY_FIXTURE) -> None:
    doc = {
        "what": "repro.core.simulate(telemetry=TelemetryConfig(window=32))"
                " of cfd kernel 0, paper geometry, default probe backend: "
                "the SimTimeline's cumulative per-window arrays (int64 / "
                "float64, leading axis = windows) and the SimResult",
        "window": TELEMETRY_WINDOW,
        "points": {name: reference_telemetry_point(name)
                   for name in TELEMETRY_POINTS},
    }
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, separators=(",", ":"))
        f.write("\n")


#: Counters that must agree exactly; every other float within rtol=1e-6,
#: the bar of the reference's own goldens (tests/test_arch_registry.py).
EXACT = {"l2_accesses", "dram_accesses", "noc_flits", "local_hits",
         "remote_hits", "requests", "l1_lat_n", "flits_injected",
         "flits_delivered", "app", "cores"}


def assert_result_close(got: dict, want: dict, where: str = "") -> None:
    """Nested SimResult dicts agree: EXACT fields bit-equal, NaN where
    NaN, other floats within rtol=1e-6."""
    assert set(got) == set(want), where
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert_result_close(g, w, f"{where}.{k}")
        elif isinstance(w, list):
            assert len(g) == len(w), f"{where}.{k}"
            for i, (gi, wi) in enumerate(zip(g, w)):
                assert_result_close(gi, wi, f"{where}.{k}[{i}]")
        elif k in EXACT:
            assert g == w, (f"{where}.{k}", g, w)
        elif isinstance(w, float) and math.isnan(w):
            assert math.isnan(g), f"{where}.{k}"
        else:
            assert math.isclose(g, w, rel_tol=1e-6, abs_tol=0.0), \
                (f"{where}.{k}", g, w)


def test_fixture_covers_every_app_and_paper_arch():
    with open(FIXTURE) as f:
        doc = json.load(f)
    assert set(doc["results"]) == set(APPS)
    for app, cells in doc["results"].items():
        assert set(cells) == set(PAPER_ARCHITECTURES), app
        assert doc["rounds"][app] == 1536
    assert PAPER_GEOMETRY.n_cores == 30


@pytest.mark.parametrize("app,arch", [("b+tree", "ata"), ("sradv1", "remote")])
def test_fixture_matches_reference_simulate(app, arch):
    with open(FIXTURE) as f:
        doc = json.load(f)
    assert_result_close(reference_cell(app, arch), doc["results"][app][arch],
                        f"{app}/{arch}")


def test_port_reproduces_fixture_cell_bit_for_bit():
    """The port on the CPU, full 1536 rounds, against the stored cell
    whose per-app latency sum outgrows 2**20 with fractional (1/16)
    latencies — where the float32 accumulation order shows."""
    from repro_torch.core import APPS as PORT_APPS
    from repro_torch.core import make_trace as port_make_trace
    from repro_torch.core import simulate as port_simulate
    with open(FIXTURE) as f:
        want = json.load(f)["results"]["cfd"]["remote"]
    got = result_dict(port_simulate(
        "remote", port_make_trace(PORT_APPS["cfd"], kernel=0), device="cpu"))
    assert want["per_app"][0]["l1_lat_sum"] > 2 ** 20
    assert got == want


def test_zoo_fixture_covers_every_app_and_zoo_arch():
    assert ZOO_ARCHITECTURES == ("ata_bypass", "ata_fifo", "ciao", "victim")
    with open(ZOO_FIXTURE) as f:
        doc = json.load(f)
    assert set(doc["results"]) == set(APPS)
    for app, cells in doc["results"].items():
        assert set(cells) == set(ZOO_ARCHITECTURES), app
        assert doc["rounds"][app] == 1536


@pytest.mark.parametrize("app,arch", [("HS3D", "victim"),
                                      ("cfd", "ata_bypass")])
def test_zoo_fixture_matches_reference_simulate(app, arch):
    with open(ZOO_FIXTURE) as f:
        doc = json.load(f)
    assert_result_close(reference_cell(app, arch), doc["results"][app][arch],
                        f"{app}/{arch}")


def test_port_reproduces_zoo_fixture_cell():
    """The port on the CPU, full 1536 rounds: the victim buffer over a
    whole kernel, against the stored reference cell."""
    from repro_torch.core import APPS as PORT_APPS
    from repro_torch.core import make_trace as port_make_trace
    from repro_torch.core import simulate as port_simulate
    with open(ZOO_FIXTURE) as f:
        want = json.load(f)["results"]["b+tree"]["victim"]
    got = result_dict(port_simulate(
        "victim", port_make_trace(PORT_APPS["b+tree"], kernel=0),
        device="cpu"))
    assert_result_close(got, want, "b+tree/victim")


def test_mix_fixture_covers_the_six_points():
    with open(MIX_FIXTURE) as f:
        doc = json.load(f)
    assert doc["apps"] == list(MIX_APPS) and doc["rounds"] == 1536
    assert set(doc["results"]) == set(MIX_ARCHS)
    for arch, cells in doc["results"].items():
        shared = cells["shared"]
        assert [a["cores"] for a in shared["per_app"]] == [15, 15], arch
        assert len(cells["solo"]) == 2, arch
        for solo in cells["solo"]:
            assert len(solo["per_app"]) == 1 and \
                solo["per_app"][0]["cores"] == 30, arch


def test_mix_fixture_matches_reference_simulate():
    """One point recomputed with JAX: ``ata`` on the composed trace."""
    with open(MIX_FIXTURE) as f:
        want = json.load(f)["results"]["ata"]["shared"]
    assert_result_close(result_dict(simulate("ata", mix_traces()["shared"])),
                        want, "ata/shared")


def test_port_reproduces_mix_fixture_cell():
    """The port on the CPU, full length: the second slot's solo trace
    (address-sliced by one ``APP_STRIDE``) under ``private``."""
    from repro_torch.core import WorkloadMix as PortMix
    from repro_torch.core import simulate as port_simulate
    with open(MIX_FIXTURE) as f:
        want = json.load(f)["results"]["private"]["solo"][1]
    trace = PortMix(apps=MIX_APPS).component_traces(30, seed=0)[1]
    got = result_dict(port_simulate("private", trace, device="cpu"))
    assert_result_close(got, want, "private/solo[1]")


def test_noc_fixture_covers_the_sixteen_points():
    from repro.core.report import NOC_BW_VALUES
    with open(NOC_FIXTURE) as f:
        doc = json.load(f)
    assert (doc["app"], doc["kernel"], doc["rounds"]) == (NOC_APP, 0, 96)
    assert tuple(doc["noc_bw"]) == NOC_BW == NOC_BW_VALUES
    assert set(doc["results"]) == set(NOC_ARCHS)
    for arch, by_noc in doc["results"].items():
        assert set(by_noc) == set(NOC_MODELS), arch
        for noc, cells in by_noc.items():
            assert set(cells) == {repr(bw) for bw in NOC_BW}, (arch, noc)
            for cell in cells.values():
                # the interconnect carried traffic and conserved it
                n = cell["noc"]
                assert n["flits_injected"] > 0, (arch, noc)
                assert n["flits_injected"] == n["flits_delivered"] + \
                    n["flits_queued"], (arch, noc)


def test_noc_fixture_matches_reference_simulate():
    """One point recomputed with JAX: ``victim`` on the ring at the
    narrowest network."""
    with open(NOC_FIXTURE) as f:
        want = json.load(f)["results"]["victim"]["ring"]["4.0"]
    assert_result_close(reference_noc_cell("victim", "ring", 4.0), want,
                        "victim/ring/4.0")


def test_port_stacked_noc_pass_reproduces_noc_fixture():
    """The port on the CPU: all sixteen points in the one stacked pass a
    ``SweepGrid`` makes of them (ata and victim, crossbar and ring, four
    bandwidths), each against its stored reference cell."""
    from repro_torch.core import APPS as PORT_APPS
    from repro_torch.core import PAPER_GEOMETRY as PORT_GEOMETRY
    from repro_torch.core import SweepGrid
    from repro_torch.core import make_trace as port_make_trace
    with open(NOC_FIXTURE) as f:
        want = json.load(f)["results"]
    trace = port_make_trace(dataclasses.replace(PORT_APPS[NOC_APP],
                                                rounds=NOC_ROUNDS), kernel=0)
    geoms = [dataclasses.replace(PORT_GEOMETRY, noc_bw=bw) for bw in NOC_BW]
    grid = SweepGrid(NOC_ARCHS, geoms, [trace], nocs=NOC_MODELS)
    run = grid.run(device="cpu")
    assert run.report.n_executables == 1
    for p, r in zip(grid.points, run.results):
        assert_result_close(result_dict(r),
                            want[p.arch][p.noc][repr(p.geom.noc_bw)],
                            f"{p.arch}/{p.noc}/{p.geom.noc_bw}")


def _telemetry_doc() -> dict:
    with open(TELEMETRY_FIXTURE) as f:
        return json.load(f)


def _fixture_cumulative(point: dict) -> dict:
    """A stored point's cumulative arrays, in their stored dtypes."""
    return {k: np.asarray(v, point["dtypes"][k])
            for k, v in point["cumulative"].items()}


def test_telemetry_fixture_covers_its_points():
    doc = _telemetry_doc()
    assert doc["window"] == TELEMETRY_WINDOW
    assert set(doc["points"]) == set(TELEMETRY_POINTS)
    for name, (arch, noc, rounds) in TELEMETRY_POINTS.items():
        point = doc["points"][name]
        assert (point["arch"], point["noc"], point["rounds"]) == \
            (arch, noc, rounds)
        cum = _fixture_cumulative(point)
        assert len(cum) == 21, name
        assert {v.shape[0] for v in cum.values()} == \
            {rounds // TELEMETRY_WINDOW}, name
        assert cum["lat_hist"].dtype == np.int64
        assert cum["lat_hist"][-1].sum() == \
            point["result"]["per_app"][0]["l1_lat_n"], name
        if arch == "remote":   # past 2**20: the float32 order shows
            assert cum["app_lat_sum"][-1, 0] > 2 ** 20, name
        if noc == "crossbar":
            assert cum["noc.link_flits"][-1].sum() > 0, name


def test_telemetry_fixture_matches_reference_simulate():
    """The capture point recomputed with JAX, every number equal."""
    want = _telemetry_doc()["points"]["capture"]
    got = json.loads(json.dumps(reference_telemetry_point("capture")))
    assert got == want


def test_port_reproduces_telemetry_fixture():
    """The port on the CPU: the capture point through ``simulate``, and
    the 1536-round points in one ``SweepGrid`` run (``ata`` and
    ``victim`` in one stacked pass), each cumulative array equal to the
    stored one (dtype included)."""
    from repro_torch.core import APPS as PORT_APPS
    from repro_torch.core import SweepGrid, TelemetryConfig
    from repro_torch.core import make_trace as port_make_trace
    from repro_torch.core import simulate as port_simulate
    doc = _telemetry_doc()
    tc = TelemetryConfig(window=TELEMETRY_WINDOW)

    def trace(rounds):
        return port_make_trace(dataclasses.replace(PORT_APPS["cfd"],
                                                   rounds=rounds), kernel=0)

    def check(name, res, tl):
        want = doc["points"][name]
        assert_result_close(result_dict(res), want["result"], name)
        got = tl.cumulative
        assert sorted(got) == sorted(want["cumulative"]), name
        for k, w in _fixture_cumulative(want).items():
            assert got[k].dtype == w.dtype, (name, k)
            np.testing.assert_array_equal(got[k], w, err_msg=f"{name} {k}")
        tl.check(res)

    check("capture", *port_simulate("ata", trace(96), noc="crossbar",
                                    telemetry=tc, device="cpu"))
    grid = SweepGrid(("ata", "victim", "remote"), None, [trace(1536)])
    run = grid.run(telemetry=tc, device="cpu")
    assert run.report.n_executables == 2
    for p, res, tl in zip(grid.points, run.results, run.timelines):
        check(f"{p.arch}_1536", res, tl)


if __name__ == "__main__":
    import sys
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("paper", "all"):
        write_fixture()
        print(f"wrote {os.path.normpath(FIXTURE)}")
    if which in ("zoo", "all"):
        write_fixture(ZOO_FIXTURE, ZOO_ARCHITECTURES)
        print(f"wrote {os.path.normpath(ZOO_FIXTURE)}")
    if which in ("mix", "all"):
        write_mix_fixture()
        print(f"wrote {os.path.normpath(MIX_FIXTURE)}")
    if which in ("noc", "all"):
        write_noc_fixture()
        print(f"wrote {os.path.normpath(NOC_FIXTURE)}")
    if which in ("telemetry", "all"):
        write_telemetry_fixture()
        print(f"wrote {os.path.normpath(TELEMETRY_FIXTURE)}")
