"""Port parity: the interconnect models ``repro_torch.core.noc``.

* ``transit`` of ``ideal``/``crossbar``/``ring`` against the reference's
  on random multi-round traffic with the state carried, over a leading
  point axis of two independent traffic streams;
* ``simulate(arch, trace, noc=...)`` against the reference's per-point
  ``simulate`` for ``crossbar`` and ``ring``.

Tolerances: flit counts are whole numbers, so every scatter-add and
queue update is exact and compared bit for bit. Only two float32 *sums*
of fractional terms depend on add order — ``delivered`` (the crossbar's
``sent`` amounts at a drain budget that is not whole) and ``delay_sum``
(the delays ``/ rate``) — and those hold to rtol 1e-6, as do the
simulator's non-integral result fields (the goldens' bar).
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import APPS as REF_APPS  # noqa: E402
from repro.core import PAPER_GEOMETRY as REF_GEOMETRY  # noqa: E402
from repro.core import make_trace as ref_make_trace  # noqa: E402
from repro.core import simulate as ref_simulate  # noqa: E402
from repro.core import noc as rnoc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import noc as pnoc  # noqa: E402
from repro_torch.core import simulate  # noqa: E402
from repro_torch.core.geometry import DeviceGeometry  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the reference test's queueing geometry (crossbar backs up) and the
#: serving engine's 8-shard geometry (rate 2: everything whole)
GEOMETRIES = {
    "paper_slow": dataclasses.replace(REF_GEOMETRY, noc_bw=2.0,
                                      noc_drain=4.0),
    "serving8": dataclasses.replace(REF_GEOMETRY, n_cores=8, cluster_size=8,
                                    l1_sets=64, l1_ways=8),
}

#: state fields whose float32 sums depend on add order
ORDERED_SUMS = ("delivered", "delay_sum")


def _traffic(rng, geom, P, R):
    core = rng.integers(0, geom.n_cores, (P, R)).astype(np.int32)
    cluster = (core // geom.cluster_size).astype(np.int32)
    peer = (cluster * geom.cluster_size
            + rng.integers(0, geom.cluster_size, (P, R))).astype(np.int32)
    flits = (rng.integers(0, 3, (P, R))
             * geom.flits_per_line).astype(np.float32)
    mask = (flits > 0) & (rng.random((P, R)) < 0.9)
    return peer, core, cluster, flits, mask


def test_registry_holds_the_three_models_in_reference_order():
    assert pnoc.registered_nocs() == pnoc.PAPER_NOCS == rnoc.PAPER_NOCS
    with pytest.raises(ValueError, match="unknown NoC model"):
        pnoc.get_noc("mesh")


@pytest.mark.parametrize("geom_name", sorted(GEOMETRIES))
@pytest.mark.parametrize("name", ("ideal", "crossbar", "ring"))
def test_transit_matches_reference_over_carried_rounds(name, geom_name):
    geom = GEOMETRIES[geom_name]
    pgeom = convert.geometry(geom)
    P, R, rounds = 2, 48, 12
    ref_model, port_model = rnoc.get_noc(name), pnoc.get_noc(name)
    assert port_model.n_links(pgeom) == ref_model.n_links(geom)
    L = ref_model.n_links(geom)
    ref_states = [rnoc.init_noc_state(L) for _ in range(P)]
    state = pnoc.init_noc_state(L, batch=P, device="cpu")
    rng = np.random.default_rng(L + R)
    for t in range(rounds):
        src, dst, cluster, flits, mask = _traffic(rng, geom, P, R)
        if t >= rounds - 3:               # drain-only rounds at the end
            mask[:] = False
        out = port_model.transit(pgeom, state, pnoc.NocTraffic(
            *(torch.from_numpy(a) for a in (src, dst, cluster, flits,
                                            mask))))
        state = out.state
        for p in range(P):
            want = ref_model.transit(geom, ref_states[p], rnoc.NocTraffic(
                *(jnp.asarray(a[p]) for a in (src, dst, cluster, flits,
                                              mask))))
            ref_states[p] = want.state
            np.testing.assert_array_equal(out.delay[p].numpy(),
                                          np.asarray(want.delay))
            np.testing.assert_array_equal(out.occupancy[p].numpy(),
                                          np.asarray(want.occupancy))
            for k, w in want.state.items():
                g, w = state[k][p].numpy(), np.asarray(w)
                assert g.dtype == w.dtype, k
                if k in ORDERED_SUMS:
                    np.testing.assert_allclose(g, w, rtol=1e-6,
                                               err_msg=f"{t}/{k}")
                else:
                    np.testing.assert_array_equal(g, w, err_msg=f"{t}/{k}")
    injected = state["injected"].numpy()
    assert (injected > 0).all()
    np.testing.assert_allclose(
        injected, state["delivered"].numpy() + state["queue"].sum(-1).numpy(),
        rtol=1e-6)
    if name == "crossbar" and geom_name == "paper_slow":
        assert (state["queue"].sum(-1) > 0).all()   # backpressure engaged


def test_port_rate_takes_device_and_host_geometry():
    geom = convert.geometry(GEOMETRIES["paper_slow"])
    host = pnoc.port_rate(geom)
    dev = pnoc.port_rate(DeviceGeometry(geom, "cpu"))
    assert isinstance(host, float) and host == 2.0 / 10
    assert dev.dtype == torch.float32 and dev.item() == np.float32(0.2)


def _close(got, want, where):
    """SimResults agree: whole-number fields exactly, others rtol 1e-6."""
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
        elif k in ("l2_accesses", "dram_accesses", "noc_flits",
                   "flits_injected") or isinstance(w, int):
            assert g == w, (where, k, g, w)
        elif math.isnan(w):
            assert math.isnan(g), (where, k)
        else:
            assert math.isclose(g, w, rel_tol=1e-6, abs_tol=0.0), \
                (where, k, g, w)


@pytest.mark.parametrize("noc", ("crossbar", "ring"))
@pytest.mark.parametrize("app,arch", [("cfd", "ata"), ("HS3D", "remote")])
def test_simulate_matches_reference_under_noc(app, arch, noc):
    params = dataclasses.replace(REF_APPS[app], rounds=64)
    trace = ref_make_trace(params, kernel=0)
    want = ref_simulate(arch, trace, noc=noc)
    got = simulate(arch, convert.trace(trace), noc=noc, device="cpu")
    assert want.noc.flits_injected > 0
    _close(got, want, f"{app}/{arch}/{noc}")
