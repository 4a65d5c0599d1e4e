"""Port parity: ``repro_torch.core.simulate``/``simulate_batch``.

* the 8 pre-refactor goldens of ``tests/test_arch_registry.py``
  (cfd/HS3D x 4 paper architectures, 192 rounds, kernel 1);
* direct ``SimResult`` parity with the reference ``simulate()`` on a
  structure-changing geometry;
* ``simulate_batch`` == per-trace ``simulate``.

Integral counters must agree exactly, every other float within
``rtol=1e-6`` (the goldens' own bar).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import APPS as REF_APPS  # noqa: E402
from repro.core import GpuGeometry as RefGeometry  # noqa: E402
from repro.core import make_trace as ref_make_trace  # noqa: E402
from repro.core import simulate as ref_simulate  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (APPS, PAPER_ARCHITECTURES, Trace,  # noqa: E402
                              make_trace, simulate, simulate_batch)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# copied from tests/test_arch_registry.py (SimResult fields of the seed
# simulator; traces: dataclasses.replace(APPS[app], rounds=192), kernel=1)
GOLDEN = {
    ("cfd", "private"): dict(
        ipc=48.13981554281181, l1_latency=32.0,
        local_hit_rate=0.1287326388888889, remote_hit_rate=0.0,
        l1_hit_rate=0.1287326388888889, l2_accesses=10037.0,
        dram_accesses=5707.0, noc_flits=40148.0,
        cycles=7029.44677734375, instructions=338396.27122934104),
    ("cfd", "remote"): dict(
        ipc=45.47783321894619, l1_latency=47.09734693877551,
        local_hit_rate=0.1287326388888889, remote_hit_rate=0.20625,
        l1_hit_rate=0.3349826388888889, l2_accesses=7661.0,
        dram_accesses=5707.0, noc_flits=130481.0,
        cycles=7440.90576171875, instructions=338396.27122934104),
    ("cfd", "decoupled"): dict(
        ipc=48.866869537984314, l1_latency=50.52785388127854,
        local_hit_rate=0.3125, remote_hit_rate=0.0,
        l1_hit_rate=0.3125, l2_accesses=7920.0,
        dram_accesses=5712.0, noc_flits=46080.0,
        cycles=6924.86083984375, instructions=338396.27122934104),
    ("cfd", "ata"): dict(
        ipc=49.954089536322286, l1_latency=34.17364016736402,
        local_hit_rate=0.1287326388888889,
        remote_hit_rate=0.16770833333333332,
        l1_hit_rate=0.2964409722222222, l2_accesses=8105.0,
        dram_accesses=5707.0, noc_flits=40148.0,
        cycles=6774.1455078125, instructions=338396.27122934104),
    ("HS3D", "private"): dict(
        ipc=19.030607132323443, l1_latency=32.0,
        local_hit_rate=0.20598958333333334, remote_hit_rate=0.0,
        l1_hit_rate=0.20598958333333334, l2_accesses=18294.0,
        dram_accesses=17416.0, noc_flits=75024.0,
        cycles=8679.841796875, instructions=165182.6592070485),
    ("HS3D", "remote"): dict(
        ipc=16.818281729987405, l1_latency=34.58079545454545,
        local_hit_rate=0.20598958333333334,
        remote_hit_rate=0.01506076388888889,
        l1_hit_rate=0.22105034722222222, l2_accesses=17947.0,
        dram_accesses=17416.0, noc_flits=239670.0,
        cycles=9821.61328125, instructions=165182.6592070485),
    ("HS3D", "decoupled"): dict(
        ipc=18.24013462975359, l1_latency=54.798122065727696,
        local_hit_rate=0.19644097222222223, remote_hit_rate=0.0,
        l1_hit_rate=0.19644097222222223, l2_accesses=18514.0,
        dram_accesses=17437.0, noc_flits=92280.0,
        cycles=9056.0, instructions=165182.6592070485),
    ("HS3D", "ata"): dict(
        ipc=19.12823515147109, l1_latency=32.11472275334608,
        local_hit_rate=0.20598958333333334,
        remote_hit_rate=0.01115451388888889,
        l1_hit_rate=0.21714409722222222, l2_accesses=18037.0,
        dram_accesses=17416.0, noc_flits=75024.0,
        cycles=8635.541015625, instructions=165182.6592070485),
}

INTEGRAL_FIELDS = ("l2_accesses", "dram_accesses", "noc_flits")

#: 8 cores in clusters of 4, 4 sets of 8 ways, 12 L2 partitions
SMALL = RefGeometry(n_cores=8, cluster_size=4, l1_sets=4, l1_ways=8,
                    l2_parts=12, l2_sets=16)


def _close(got, want, where):
    """SimResults (port vs reference) agree under the goldens' bar."""
    got, want = got._asdict(), want._asdict()
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if k == "per_app":
            assert len(g) == len(w)
            for ga, wa in zip(g, w):
                _close(ga, wa, f"{where}.per_app")
        elif k == "noc":
            _close(g, w, f"{where}.noc")
        elif k in INTEGRAL_FIELDS or isinstance(w, int):
            assert g == w, (where, k, g, w)
        elif math.isnan(w):
            assert math.isnan(g), (where, k)
        else:
            assert math.isclose(g, w, rel_tol=1e-6, abs_tol=0.0), \
                (where, k, g, w)


@pytest.mark.parametrize("app,arch", sorted(GOLDEN))
def test_port_matches_pre_refactor_golden(app, arch):
    trace = make_trace(dataclasses.replace(APPS[app], rounds=192), kernel=1)
    r = simulate(arch, trace, device="cpu")._asdict()
    for field, want in GOLDEN[(app, arch)].items():
        if field in INTEGRAL_FIELDS:
            assert r[field] == want, (field, r[field], want)
        else:
            np.testing.assert_allclose(r[field], want, rtol=1e-6,
                                       err_msg=f"{app}/{arch}/{field}")


@pytest.mark.parametrize("arch", PAPER_ARCHITECTURES)
@pytest.mark.parametrize("app", ["cfd", "HS3D"])
def test_simulate_matches_reference_on_small_geometry(app, arch):
    ref_trace = ref_make_trace(dataclasses.replace(REF_APPS[app], rounds=96),
                               n_cores=SMALL.n_cores, kernel=2)
    want = ref_simulate(arch, ref_trace, SMALL)
    got = simulate(arch, convert.trace(ref_trace), convert.geometry(SMALL),
                   device="cpu")
    _close(got, want, f"{app}/{arch}")


@pytest.mark.parametrize("arch", PAPER_ARCHITECTURES)
def test_simulate_batch_matches_single(arch):
    geom = convert.geometry(SMALL)
    p = dataclasses.replace(APPS["cfd"], rounds=64)
    traces = [make_trace(p, n_cores=8, kernel=k) for k in range(3)]
    batched = simulate_batch(arch, traces, geom, device="cpu")
    singles = [simulate(arch, t, geom, device="cpu") for t in traces]
    assert len(batched) == len(singles)
    for b, s in zip(batched, singles):
        assert tuple(b) == tuple(s)


def test_simulate_batch_rejects_mixed_shapes_and_bad_args():
    t_a = make_trace(dataclasses.replace(APPS["cfd"], rounds=8))
    t_b = make_trace(dataclasses.replace(APPS["HS3D"], rounds=8))
    with pytest.raises(ValueError, match="same-shape"):
        simulate_batch("ata", [t_a, t_b], device="cpu")
    with pytest.raises(ValueError, match="arch must be one of"):
        simulate("ata_fifo", t_a, device="cpu")
    with pytest.raises(ValueError, match="noc must be one of"):
        simulate("ata", t_a, noc="ring", device="cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        simulate("ata", t_a, probe_backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="cores"):
        simulate("ata", t_a, convert.geometry(SMALL), device="cpu")
    assert simulate_batch("ata", [], device="cpu") == []


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    t = make_trace(dataclasses.replace(APPS["cfd"], rounds=4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate("ata", t)


def test_vector_insn_and_multi_app_trace():
    """A per-core instruction vector and a two-app core assignment go
    through the per-app attribution like the reference."""
    from repro.core import Trace as RefTrace
    ref_trace = ref_make_trace(dataclasses.replace(REF_APPS["SN"], rounds=48),
                               n_cores=8, kernel=1)
    insn = np.linspace(4.0, 11.0, 8).astype(np.float32)
    core_app = np.array([0, 0, 1, 1, 0, 1, 0, 1])
    ref_mixed = RefTrace(ref_trace.addr, ref_trace.is_write, insn, core_app)
    port_mixed = Trace(ref_trace.addr, ref_trace.is_write, insn, core_app)
    for arch in ("private", "ata"):
        want = ref_simulate(arch, ref_mixed, SMALL)
        got = simulate(arch, port_mixed, convert.geometry(SMALL),
                       device="cpu")
        assert len(got.per_app) == 2
        _close(got, want, f"mixed/{arch}")


def test_per_app_latency_fold_matches_reference_scatter_order():
    """Past 2**20 the float32 per-app latency sum depends on the order of
    its adds; the reference scatter-adds core by core, round by round.
    ``_fold_app_lat`` must reproduce that sequence bit for bit (a sum per
    round, or an atomic scatter on the card, would not)."""
    import jax
    import jax.numpy as jnp
    from repro_torch.core.simulator import _fold_app_lat

    rng = np.random.default_rng(11)
    T, C = 300, 30
    vals = (rng.integers(0, 12800, (T, 1, C)) / 16).astype(np.float32)
    vals[rng.random((T, 1, C)) < 0.3] = 0.0          # unserved cores
    core_app = np.zeros((1, C), np.int64)
    core_app[0, ::3] = 1

    step = jax.jit(lambda acc, v: acc.at[jnp.asarray(core_app[0])].add(v))
    acc = jnp.zeros((2,), jnp.float32)
    for t in range(T):
        acc = step(acc, jnp.asarray(vals[t, 0]))
    want = np.asarray(acc)
    got = _fold_app_lat(vals, core_app, 2)[0]
    assert want.max() > 2 ** 20
    np.testing.assert_array_equal(got, want)
    per_round = np.zeros(2, np.float32)
    for t in range(T):
        per_round += np.array([vals[t, 0][core_app[0] == a].sum()
                               for a in range(2)], np.float32)
    assert not np.array_equal(per_round, want)   # the order matters here
