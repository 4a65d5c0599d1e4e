"""Port parity: ``repro_torch.core.metrics`` (``run_suite``/``run_app``
over ``simulate_batch``) against per-point reference ``simulate()``.

The reference's own ``run_suite`` rides ``SweepGrid``, which does not run
on the installed jax, so the comparison is per point.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro.core import geomean as ref_geomean  # noqa: E402
from repro.core import normalized_ipc as ref_normalized_ipc  # noqa: E402
from repro.core import simulate as ref_simulate  # noqa: E402
from repro.core.metrics import AppResult as RefAppResult  # noqa: E402
from repro.core.metrics import app_traces as ref_app_traces  # noqa: E402
from repro_torch.core import (PAPER_ARCHITECTURES, geomean,  # noqa: E402
                              normalized_ipc, run_app, run_suite)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROUNDS = 96
APPS_UNDER_TEST = ("cfd", "HS3D")   # one m=2 and one m=4 app: two batches
INTEGRAL = ("l2_accesses", "dram_accesses", "noc_flits")


@pytest.fixture(scope="module")
def suites():
    port = run_suite(apps=APPS_UNDER_TEST, kernels_per_app=1, rounds=ROUNDS,
                     device="cpu")
    ref = {app: {arch: RefAppResult(app, arch, [
        ref_simulate(arch, tr) for tr in ref_app_traces(
            app, kernels=range(1), rounds=ROUNDS)])
        for arch in PAPER_ARCHITECTURES} for app in APPS_UNDER_TEST}
    return port, ref


def test_run_suite_matches_per_point_reference(suites):
    port, ref = suites
    assert list(port) == list(APPS_UNDER_TEST)
    for app in APPS_UNDER_TEST:
        assert list(port[app]) == list(PAPER_ARCHITECTURES)
        for arch in PAPER_ARCHITECTURES:
            (g,), (w,) = port[app][arch].per_kernel, ref[app][arch].per_kernel
            for k, wv in w._asdict().items():
                gv = getattr(g, k)
                if k in INTEGRAL:
                    assert gv == wv, (app, arch, k)
                elif k in ("per_app", "noc"):
                    assert len(gv) == len(wv)
                else:
                    assert math.isclose(gv, wv, rel_tol=1e-6), (app, arch, k)
            for prop in ("ipc", "l1_latency", "l1_hit_rate",
                         "remote_hit_rate", "noc_flits", "l2_accesses"):
                assert math.isclose(getattr(port[app][arch], prop),
                                    getattr(ref[app][arch], prop),
                                    rel_tol=1e-6), (app, arch, prop)


def test_normalized_ipc_and_geomean_match_reference(suites):
    port, ref = suites
    got, want = normalized_ipc(port), ref_normalized_ipc(ref)
    for app in APPS_UNDER_TEST:
        assert got[app]["private"] == 1.0
        for arch in PAPER_ARCHITECTURES:
            assert math.isclose(got[app][arch], want[app][arch],
                                rel_tol=1e-6)
    gains = [got[a]["ata"] for a in APPS_UNDER_TEST]
    assert math.isclose(geomean(gains),
                        ref_geomean([want[a]["ata"] for a in APPS_UNDER_TEST]),
                        rel_tol=1e-6)
    for bad in ([], [1.0, float("nan")], [0.0, 2.0]):
        with pytest.raises(ValueError):
            geomean(bad)


def test_run_app_equals_run_suite_cell(suites):
    port, _ = suites
    r = run_app("HS3D", "ata", kernels=range(1), rounds=ROUNDS, device="cpu")
    assert [tuple(x) for x in r.per_kernel] == \
        [tuple(x) for x in port["HS3D"]["ata"].per_kernel]
