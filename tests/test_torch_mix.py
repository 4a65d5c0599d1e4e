"""Port parity: multi-tenant mixes (``repro_torch.core.trace.mix``,
``metrics.run_mixes``/``MixResult``, ``figures.mix_fairness``) and the
per-app attribution blocks (``AppStats``, ``NocStats``).

* ``WorkloadMix`` composed and component traces array-equal to the
  reference's (partitioned, interleaved, shares, phase stagger, three
  apps, pinned rounds); a one-app mix is its solo trace;
* ``run_mixes`` against ``MixResult`` built from the reference's
  per-point ``simulate()`` (the reference's ``run_mixes`` needs its
  grid, which does not run on jax 0.9.0), ``per_app`` compared by field
  name and slot;
* per-app attribution invariant under relabeling the slots, compared by
  name (the reference's own relabeling test compares
  ``tuple(SimResult)[:-1]``, which takes in ``per_app``, and fails;
  ROADMAP, "Reference baseline");
* ``AppStats``'s derived rates and ``NocStats.conserved`` against the
  reference's; the fairness rows against ``benchmarks/
  fig_mix_fairness.py``'s arithmetic.

Tolerance: bit-equal everywhere (ideal NoC, whole-number counters, and
the same float operations in the same order).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import AppStats as RefAppStats  # noqa: E402
from repro.core import NocStats as RefNocStats  # noqa: E402
from repro.core import WorkloadMix as RefMix  # noqa: E402
from repro.core import simulate as ref_simulate  # noqa: E402
from repro.core.metrics import MixResult as RefMixResult  # noqa: E402
from repro_torch.core import (APPS, AppStats, MixResult,  # noqa: E402
                              NocStats, WorkloadMix, make_trace, run_mixes,
                              simulate)
from repro_torch.core import figures  # noqa: E402
from repro_torch.core.trace import APP_STRIDE  # noqa: E402
from repro.core.trace import APP_STRIDE as REF_APP_STRIDE  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SPECS = {
    "partitioned": dict(apps=("cfd", "HS3D")),
    "interleaved": dict(apps=("cfd", "HS3D"), layout="interleaved"),
    "shares": dict(apps=("cfd", "HS3D"), shares=(20, 10)),
    "interleaved_shares": dict(apps=("b+tree", "SN"), shares=(12, 18),
                               layout="interleaved"),
    "stagger": dict(apps=("cfd", "HS3D"), phase_rounds=16),
    "three_apps": dict(apps=("cfd", "b+tree", "HS3D"), phase_rounds=7,
                       kernels=(0, 1, 2)),
    "same_app_twice": dict(apps=("lud", "lud"), rounds=100),
}


def assert_trace_equal(got, want, where):
    np.testing.assert_array_equal(got.addr, want.addr, err_msg=where)
    np.testing.assert_array_equal(got.is_write, want.is_write,
                                  err_msg=where)
    assert got.addr.dtype == want.addr.dtype == np.int32
    np.testing.assert_array_equal(np.asarray(got.insn_per_req),
                                  np.asarray(want.insn_per_req),
                                  err_msg=where)
    assert np.shape(got.insn_per_req) == np.shape(want.insn_per_req)
    if want.core_app is None:
        assert got.core_app is None, where
    else:
        np.testing.assert_array_equal(got.core_app, want.core_app,
                                      err_msg=where)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_workload_mix_traces_equal_reference(name):
    ref, port = RefMix(**SPECS[name]), WorkloadMix(**SPECS[name])
    assert port.mix_id == ref.mix_id
    assert port.n_apps == ref.n_apps
    for C in ((30,) if port.shares else (30, 12)):
        np.testing.assert_array_equal(port.core_assignment(C),
                                      ref.core_assignment(C))
    assert_trace_equal(port.compose(30, seed=3), ref.compose(30, seed=3),
                       f"{name} composed")
    comps = port.component_traces(30, seed=3)
    want = ref.component_traces(30, seed=3)
    assert len(comps) == len(want) == port.n_apps
    for slot, (g, w) in enumerate(zip(comps, want)):
        assert_trace_equal(g, w, f"{name} slot {slot}")
    assert APP_STRIDE == REF_APP_STRIDE


def test_one_app_mix_is_its_solo_trace():
    app = dataclasses.replace(APPS["cfd"], rounds=64)
    solo = make_trace(app)
    mixed = WorkloadMix(apps=(app,)).compose(30)
    assert_trace_equal(mixed, solo, "one-app mix")
    a = simulate("ata", mixed, device="cpu")
    b = simulate("ata", solo, device="cpu")
    assert a._asdict() == b._asdict()


@pytest.mark.parametrize("spec,match", [
    (dict(apps=()), "at least one app"),
    (dict(apps=("cfd",), layout="striped"), "layout"),
    (dict(apps=("cfd", "HS3D"), shares=(30,)), "one core count per app"),
    (dict(apps=("cfd", "HS3D"), kernels=(0,)), "one kernel per app"),
    (dict(apps=("nope",)), "unknown app"),
])
def test_mix_spec_validation_matches_reference(spec, match):
    for cls in (RefMix, WorkloadMix):
        with pytest.raises(ValueError, match=match):
            cls(**spec)
    for shares, match in (((20, 20), "sum to n_cores"),
                          ((30, 0), ">= 1 core")):
        for cls in (RefMix, WorkloadMix):
            with pytest.raises(ValueError, match=match):
                cls(apps=("cfd", "HS3D"), shares=shares).core_assignment(30)


MIX_ARCHS = ("private", "ata")
MIX_APPS = (("cfd", "HS3D"), ("cfd", "b+tree", "HS3D"))
ROUNDS = 96


@pytest.fixture(scope="module")
def mix_runs():
    """The port's run_mixes, and MixResults of the reference's per-point
    simulate() over the reference's own mix traces."""
    port = run_mixes([WorkloadMix(apps=a) for a in MIX_APPS],
                     archs=MIX_ARCHS, rounds=ROUNDS, device="cpu")
    ref = {}
    for apps in MIX_APPS:
        mix = RefMix(apps=apps, rounds=ROUNDS)
        shared, comps = mix.compose(30), mix.component_traces(30)
        ref[mix.mix_id] = {arch: RefMixResult(
            mix, arch, shared=ref_simulate(arch, shared),
            solo=[ref_simulate(arch, t) for t in comps])
            for arch in MIX_ARCHS}
    return port, ref


def assert_result_by_name(got, want, where):
    """SimResults equal field by field by name; ``per_app`` slot by slot,
    each AppStats by field name."""
    g, w = got._asdict(), want._asdict()
    assert list(g) == list(w), where
    for k, wv in w.items():
        if k == "per_app":
            assert len(g[k]) == len(wv), where
            for slot, (ga, wa) in enumerate(zip(g[k], wv)):
                assert ga._asdict() == wa._asdict(), (where, slot)
        elif k == "noc":
            assert g[k]._asdict() == wv._asdict(), where
        elif isinstance(wv, float) and math.isnan(wv):
            assert math.isnan(g[k]), (where, k)
        else:
            assert g[k] == wv, (where, k, g[k], wv)


def test_run_mixes_matches_reference_per_point(mix_runs):
    port, ref = mix_runs
    # 2 families x {2-app mix, 3-app mix, solo} kinds
    assert port.report.n_executables == 6, port.report
    assert port.report.n_points == 2 * (3 + 4)
    assert list(port.results) == list(ref)
    for mid, per_arch in ref.items():
        assert list(port.results[mid]) == list(MIX_ARCHS)
        for arch, want in per_arch.items():
            got = port.results[mid][arch]
            assert got.mix.mix_id == mid
            assert_result_by_name(got.shared, want.shared,
                                  f"{mid}/{arch}/shared")
            assert len(got.solo) == len(want.solo)
            for i, (g, w) in enumerate(zip(got.solo, want.solo)):
                assert_result_by_name(g, w, f"{mid}/{arch}/solo{i}")
            assert got.n_cores == want.n_cores == 30
            assert got.slowdowns == want.slowdowns
            assert got.weighted_speedup == want.weighted_speedup
            assert got.unfairness == want.unfairness
            assert got.per_app_ipc == want.per_app_ipc
            assert got.per_app_l1_hit_rate == want.per_app_l1_hit_rate
            assert 0 < got.weighted_speedup <= len(got.solo) + 0.5


def test_mix_fairness_rows_match_reference_arithmetic(mix_runs):
    """``benchmarks/fig_mix_fairness.py``'s names, formats and arithmetic
    (its ``run`` needs the reference grid), on the reference results."""
    port, ref = mix_runs
    want = []
    for mid, per_arch in ref.items():
        for arch, mr in per_arch.items():
            want += [(f"fig_mix.{mid}.{arch}.weighted_speedup",
                      f"{mr.weighted_speedup:.3f}"),
                     (f"fig_mix.{mid}.{arch}.unfairness",
                      f"{mr.unfairness:.3f}"),
                     (f"fig_mix.{mid}.{arch}.ipc",
                      f"{mr.shared.ipc:.2f}")]
        ratio = (per_arch["ata"].weighted_speedup
                 / per_arch["private"].weighted_speedup)
        want.append((f"fig_mix.{mid}.ata_vs_private_ws", f"{ratio:.3f}"))
    want.append(("fig_mix.executables", str(port.report.n_executables)))
    assert figures.mix_fairness(port) == want


def test_run_mixes_rejects_duplicate_ids():
    with pytest.raises(ValueError, match="duplicate mix ids"):
        run_mixes([WorkloadMix(apps=("cfd", "HS3D")),
                   WorkloadMix(apps=("cfd", "HS3D"))],
                  archs=("private",), rounds=16, device="cpu")


def test_per_app_attribution_invariant_under_relabeling():
    """Swapping the slot labels of a composed trace moves each app's
    AppStats to its new slot and changes nothing else, compared by
    field name (``app`` is the slot id itself)."""
    tr = WorkloadMix(apps=("cfd", "b+tree", "HS3D"), rounds=64).compose(30)
    perm = np.array([2, 0, 1])          # old slot -> new slot
    relabeled = tr._replace(core_app=perm[tr.core_app])
    a = simulate("ata", tr, device="cpu")
    b = simulate("ata", relabeled, device="cpu")
    for k, v in a._asdict().items():
        if k == "per_app":
            continue
        w = b._asdict()[k]
        if k == "noc":
            assert v._asdict() == w._asdict()
        else:
            assert v == w or (math.isnan(v) and math.isnan(w)), k
    for old, stats in enumerate(a.per_app):
        moved = b.per_app[perm[old]]._asdict()
        assert moved.pop("app") == perm[old]
        mine = stats._asdict()
        mine.pop("app")
        assert moved == mine, old


def _ref_app(**kw):
    return RefAppStats(**kw)


@pytest.mark.parametrize("lat_n", (10.0, 0.0))
def test_app_stats_derived_rates_match_reference(lat_n):
    fields = dict(app=1, cores=10, instructions=2345.5, cycles=123.25,
                  requests=400.0, local_hits=101.0, remote_hits=47.0,
                  l1_lat_sum=333.5, l1_lat_n=lat_n)
    got, want = AppStats(**fields), _ref_app(**fields)
    for prop in ("ipc", "local_hit_rate", "remote_hit_rate", "l1_hit_rate",
                 "l1_latency"):
        g, w = getattr(got, prop), getattr(want, prop)
        assert g == w or (math.isnan(g) and math.isnan(w)), prop
    assert math.isnan(got.l1_latency) == (lat_n == 0.0)


@pytest.mark.parametrize("inj,dlv,q", [(100.0, 100.0, 0.0),
                                       (1000.0, 900.0, 100.0),
                                       (5e6, 5e6 - 10.0, 9.0),
                                       (1000.0, 990.0, 9.998),
                                       (0.0, 0.0, 0.0)])
def test_noc_stats_conserved_matches_reference(inj, dlv, q):
    fields = (inj, dlv, q, 0.0, 0.0, 0.0)
    assert NocStats(*fields).conserved == RefNocStats(*fields).conserved


def test_mix_result_fairness_math_matches_reference():
    """Synthetic inputs with known answers: app0 10 cores at shared IPC
    20 against solo 90 on 30 cores (slowdown 1.5); app1 20 cores at 40
    against 60 (slowdown 1.0)."""
    def sim(cls_sim, cls_app, per_app, ipc=10.0):
        return cls_sim(ipc=ipc, l1_latency=30.0, local_hit_rate=0.5,
                       remote_hit_rate=0.0, l1_hit_rate=0.5,
                       l2_accesses=1.0, dram_accesses=1.0, noc_flits=1.0,
                       cycles=100.0, instructions=1000.0,
                       per_app=tuple(cls_app(app=a, cores=c,
                                             instructions=i * 100.0,
                                             cycles=100.0, requests=400.0,
                                             local_hits=100.0,
                                             remote_hits=50.0,
                                             l1_lat_sum=300.0,
                                             l1_lat_n=10.0)
                                     for a, c, i in per_app))
    from repro.core import SimResult as RefSim
    from repro_torch.core import SimResult
    out = []
    for mr_cls, sim_cls, app_cls, mix_cls in (
            (MixResult, SimResult, AppStats, WorkloadMix),
            (RefMixResult, RefSim, RefAppStats, RefMix)):
        mr = mr_cls(mix=mix_cls(apps=("cfd", "HS3D"), shares=(10, 20)),
                    arch="ata",
                    shared=sim(sim_cls, app_cls, [(0, 10, 20.0),
                                                  (1, 20, 40.0)]),
                    solo=[sim(sim_cls, app_cls, [(0, 30, 90.0)], 90.0),
                          sim(sim_cls, app_cls, [(1, 30, 60.0)], 60.0)])
        out.append((mr.n_cores, mr.slowdowns, mr.weighted_speedup,
                    mr.unfairness, mr.per_app_ipc, mr.per_app_l1_hit_rate))
    assert out[0] == out[1]
    assert out[0][1] == pytest.approx([1.5, 1.0])
    assert out[0][3] == pytest.approx(1.5)
