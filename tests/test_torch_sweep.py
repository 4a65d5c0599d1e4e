"""Port parity: ``repro_torch.core.sweep.SweepGrid`` and its stacked pass.

The reference's own grid does not run on jax 0.9.0 (ROADMAP, "Reference
baseline"), so the port's grid is held against the reference's
per-point ``simulate()``:

* the ATA family (``ata``, ``ata_fifo``, ``ata_bypass``, ``victim``)
  stacked into one pass at 768 rounds, where the variants diverge;
* bucket accounting: scalar-only geometries share one pass per family,
  each geometry structure gets its own;
* stacking validation names the policy (or NoC model) that breaks it;
* NoC stacking over ``ideal``, ``crossbar`` and ``ring`` at two
  ``noc_bw`` values;
* the repairs the grid needs: ``NocModel.stack_key``, ``simulate_many``,
  ``DeviceGeometry`` over per-point scalars, ``round_signature``;
* a one-architecture pass still dispatches, round for round, the ops
  the simulator dispatched before policy stacking existed.

Tolerance: under the ``ideal`` NoC every field of every result, the
``per_app`` and ``noc`` blocks included, equals the reference's bit for
bit. Under ``crossbar``/``ring`` the float32 totals of fractional terms
(``delivered``, the delay sum behind ``mean_queue_delay``) add in
another order than the reference's, so non-integral fields hold to
rtol 1e-6 there (``tests/test_torch_noc.py``'s bar); a stacked pass
still equals the port's own per-point runs bit for bit.
"""
import dataclasses
import hashlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import APPS as REF_APPS  # noqa: E402
from repro.core import PAPER_GEOMETRY as REF_GEOMETRY  # noqa: E402
from repro.core import make_trace as ref_make_trace  # noqa: E402
from repro.core import simulate as ref_simulate  # noqa: E402
from repro.core import WorkloadMix as RefMix  # noqa: E402
from repro.core.noc import get_noc as ref_get_noc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import APPS as PORT_APPS  # noqa: E402
from repro_torch.core import (PAPER_GEOMETRY, SweepGrid,  # noqa: E402
                              SweepPoint, simulate, simulate_batch,
                              simulate_many)
from repro_torch.core import make_trace as port_make_trace  # noqa: E402
from repro_torch.core import simulator as psim  # noqa: E402
from repro_torch.core import arch as parch  # noqa: E402
from repro_torch.core import noc as pnoc  # noqa: E402
from repro_torch.core.arch import AtaPolicy  # noqa: E402
from repro_torch.core.geometry import (DeviceGeometry,  # noqa: E402
                                       geom_structure)
from repro_torch.core.simulator import round_signature  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def result_dict(r) -> dict:
    d = r._asdict()
    d["per_app"] = [a._asdict() for a in r.per_app]
    d["noc"] = r.noc._asdict()
    return d


def assert_same(got, want, where=""):
    """Two SimResults equal field by field (by name), NaN where NaN."""
    g, w = result_dict(got), result_dict(want)
    assert list(g) == list(w)
    for k, wv in w.items():
        gv = g[k]
        if isinstance(wv, float) and math.isnan(wv):
            assert math.isnan(gv), (where, k)
        else:
            assert gv == wv, (where, k, gv, wv)


def assert_close(got, want, where=""):
    """Integral fields exactly, other floats within rtol 1e-6."""
    g, w = result_dict(got), result_dict(want)

    def walk(gv, wv, path):
        if isinstance(wv, dict):
            assert list(gv) == list(wv), path
            for k in wv:
                walk(gv[k], wv[k], f"{path}.{k}")
        elif isinstance(wv, list):
            assert len(gv) == len(wv), path
            for i, (a, b) in enumerate(zip(gv, wv)):
                walk(a, b, f"{path}[{i}]")
        elif isinstance(wv, float) and math.isnan(wv):
            assert math.isnan(gv), path
        elif float(wv).is_integer():
            assert gv == wv, (path, gv, wv)
        else:
            assert math.isclose(gv, wv, rel_tol=1e-6, abs_tol=0.0), \
                (path, gv, wv)
    walk(g, w, where)


def _ref_trace(app, rounds, kernel=0):
    return ref_make_trace(dataclasses.replace(REF_APPS[app], rounds=rounds),
                          kernel=kernel)


def _ref_geom(geom):
    return dataclasses.replace(REF_GEOMETRY, **dataclasses.asdict(geom))


ATA_FAMILY = ("ata", "ata_fifo", "ata_bypass", "victim")


def test_stacked_ata_family_bit_equal_to_reference_per_point():
    ref_tr = _ref_trace("HS3D", 768)
    grid = SweepGrid(ATA_FAMILY, None, [convert.trace(ref_tr)])
    run = grid.run(device="cpu")
    assert run.report.n_points == 4
    assert run.report.n_executables == 1       # one stacked pass
    assert run.report.n_devices == 1
    for p, r in zip(grid.points, run.results):
        assert_same(r, ref_simulate(p.arch, ref_tr), p.arch)
    by_arch = {p.arch: r for p, r in zip(grid.points, run.results)}
    # the policies diverge: a stack that ran one member for all would
    # not pass the check above
    assert tuple(by_arch["ata"]) != tuple(by_arch["ata_fifo"])
    assert tuple(by_arch["ata"]) != tuple(by_arch["victim"])


def test_scalar_geometries_share_one_pass_per_family():
    ref_tr = _ref_trace("cfd", 64)
    geoms = [PAPER_GEOMETRY,
             dataclasses.replace(PAPER_GEOMETRY, svc_port=4),
             dataclasses.replace(PAPER_GEOMETRY, lat_l2=240)]
    grid = SweepGrid(("private", "ata", "ciao", "victim"), geoms,
                     [convert.trace(ref_tr)])
    run = grid.run(device="cpu")
    assert run.report.n_points == 12
    assert run.report.n_executables == 2       # private+ciao, ata+victim
    for p, r in zip(grid.points, run.results):
        assert_same(r, ref_simulate(p.arch, ref_tr, _ref_geom(p.geom)),
                    (p.arch, p.geom.svc_port, p.geom.lat_l2))
    # the timing scalars really differ per point inside one pass
    ipc = {(p.arch, p.geom.lat_l2): r.ipc
           for p, r in zip(grid.points, run.results)}
    assert ipc[("ata", 240)] < ipc[("ata", 188)]


def test_structural_geometries_make_one_pass_each():
    tr = convert.trace(_ref_trace("HS3D", 48))
    geoms = [dataclasses.replace(PAPER_GEOMETRY, l1_ways=32),
             PAPER_GEOMETRY,
             dataclasses.replace(PAPER_GEOMETRY, svc_port=4)]
    grid = SweepGrid(("ata", "victim"), geoms, [tr])
    run = grid.run(device="cpu")
    assert run.report.n_executables == 2       # l1_ways 32 | 64
    for p, r in zip(grid.points, run.results):
        assert_same(r, simulate(p.arch, p.trace, p.geom, device="cpu"),
                    (p.arch, p.geom.l1_ways, p.geom.svc_port))
    # a second run of the same buckets is all warm
    again = grid.run(device="cpu")
    assert again.report.n_compiles == 0
    assert again.report.n_executables == 2
    # another trace kind (a two-app mix) is another pass
    mix = convert.trace(RefMix(apps=("cfd", "HS3D"), rounds=48).compose())
    grid = SweepGrid.from_points([SweepPoint("ata", PAPER_GEOMETRY, tr),
                                  SweepPoint("ata", PAPER_GEOMETRY, mix)])
    assert grid.run(device="cpu").report.n_executables == 2


@pytest.fixture
def temp_arch():
    """Register policies for one test; always unregister afterwards."""
    names = []

    def _register(policy):
        names.append(policy.name)
        return parch.register_arch(policy, overwrite=True)

    yield _register
    for n in names:
        parch._REGISTRY.pop(n, None)


def test_sweep_grid_rejects_stack_key_dataflow_mismatch(temp_arch):
    @dataclasses.dataclass(frozen=True)
    class BadStack(AtaPolicy):
        name: str = "test_bad_stack"

        def l1_stage(self, geom, l1, reqs, t, *, backend=None):
            out = super().l1_stage(geom, l1, reqs, t, backend=backend)
            # an extra carried state tensor: another round dataflow
            return out._replace(l1=dict(out.l1, extra=torch.zeros(3)))

    temp_arch(BadStack())
    traces = [convert.trace(_ref_trace("cfd", 16))]
    with pytest.raises(ValueError, match="stack_key 'ata'.*test_bad_stack"):
        SweepGrid(("ata", "test_bad_stack"), None, traces)
    # alone (its own one-member family) the policy is not rejected
    assert len(SweepGrid(("test_bad_stack",), None, traces).points) == 1


def test_sweep_grid_rejects_noc_stack_dataflow_mismatch():
    @dataclasses.dataclass(frozen=True)
    class LeakyNoc(pnoc.NocModel):
        name: str = "test_leaky"

        def transit(self, geom, state, traffic):
            zeros = torch.zeros_like(traffic.flits)
            return pnoc.NocTransit(state=dict(state, extra=zeros[..., 0]),
                                   delay=zeros, occupancy=zeros)

    pnoc.register_noc(LeakyNoc(), overwrite=True)
    try:
        traces = [convert.trace(_ref_trace("cfd", 16))]
        with pytest.raises(ValueError, match="NoC stack_key 'noc'.*"
                                             "test_leaky"):
            SweepGrid(("ata",), None, traces, nocs=("ideal", "test_leaky"))
    finally:
        pnoc._REGISTRY.pop("test_leaky", None)


def test_sweep_grid_validates_names_and_geometry():
    tr = convert.trace(_ref_trace("cfd", 8))
    with pytest.raises(ValueError, match="arch must be one of"):
        SweepGrid(("bogus",), None, [tr])
    with pytest.raises(ValueError, match="noc must be one of"):
        SweepGrid(("ata",), None, [tr], nocs=("bogus",))
    with pytest.raises(ValueError, match="probe_backend must be one of"):
        SweepGrid(("ata",), None, [tr], probe_backends=("lax",))
    with pytest.raises(ValueError, match="must divide"):
        SweepGrid(("ata",), [dataclasses.replace(PAPER_GEOMETRY,
                                                 cluster_size=7)], [tr])


@pytest.mark.parametrize("noc_bw", (4.0, 16.0))
def test_noc_models_stack_into_one_pass_per_family(noc_bw):
    ref_tr = _ref_trace("HS3D", 64)
    geom = dataclasses.replace(PAPER_GEOMETRY, noc_bw=noc_bw)
    grid = SweepGrid(("remote", "ata"), [geom], [convert.trace(ref_tr)],
                     nocs=("ideal", "crossbar", "ring"))
    run = grid.run(device="cpu")
    assert run.report.n_executables == 2       # remote | ata; NoCs stack
    for p, r in zip(grid.points, run.results):
        where = (p.arch, p.noc, noc_bw)
        assert_same(r, simulate(p.arch, p.trace, p.geom, noc=p.noc,
                                device="cpu"), where)
        assert_close(r, ref_simulate(p.arch, ref_tr, _ref_geom(p.geom),
                                     noc=p.noc), where)
        assert r.noc.conserved
        if p.noc != "ideal":
            assert r.noc.flits_injected > 0


def test_noc_stack_key_matches_reference():
    for name in pnoc.registered_nocs():
        assert pnoc.get_noc(name).stack_key == ref_get_noc(name).stack_key \
            == "noc"


def test_simulate_many_groups_kinds_in_input_order():
    ref_traces = [_ref_trace("cfd", 32), _ref_trace("HS3D", 32),
                  RefMix(apps=("cfd", "HS3D"), rounds=32).compose(),
                  _ref_trace("b+tree", 32)]
    got = simulate_many("ata", [convert.trace(t) for t in ref_traces],
                        device="cpu")
    assert len(got) == len(ref_traces)
    for i, (g, t) in enumerate(zip(got, ref_traces)):
        assert_same(g, ref_simulate("ata", t), i)


def test_device_geometry_carries_one_scalar_per_point():
    g0 = PAPER_GEOMETRY
    g1 = dataclasses.replace(PAPER_GEOMETRY, lat_l2=240, noc_bw=0.2)
    dg = DeviceGeometry([g0, g1, g0], "cpu")
    assert dg.l1_ways == 64 and dg.n_clusters == 3
    assert dg.lat_l2.shape == (3, 1) and dg.lat_l2.dtype == torch.float32
    assert dg.point("lat_l2").tolist() == [188.0, 240.0, 188.0]
    assert dg.point("noc_bw")[1].item() == np.float32(0.2)
    part = dg.take(slice(1, 3))
    assert part.point("lat_l2").tolist() == [240.0, 188.0]
    one = DeviceGeometry(g1, "cpu")
    assert one.hide.shape == (1, 1)
    assert one.point("lat_l2").tolist() == [240.0]
    with pytest.raises(ValueError, match="one structure"):
        DeviceGeometry([g0, dataclasses.replace(g0, l1_ways=32)], "cpu")


def test_round_signature_agrees_within_families():
    s = geom_structure(PAPER_GEOMETRY)
    for group in (("ata", "ata_bypass", "ata_fifo", "victim"),
                  ("private", "ciao")):
        sigs = {round_signature(group, a, s, (30, 4)) for a in group}
        assert len(sigs) == 1, group
    nocs = ("ideal", "crossbar", "ring")
    sigs = {round_signature(("remote",), "remote", s, (30, 2), (30,), 2,
                            nocs, n) for n in nocs}
    assert len(sigs) == 1
    # the group sizes the state: victim's buffer is zero-sized alone
    assert round_signature(("ata",), "ata", s, (30, 4)) != \
        round_signature(("ata", "victim"), "ata", s, (30, 4))


#: One round of ``simulate_batch`` (HS3D kernels 0 and 1, round 5) as the
#: simulator dispatched it before policy stacking existed: per
#: "arch/noc", the dtype conversions (``aten._to_copy``) among its ops
#: and a digest of the sequence of all the others, recorded on the CPU
#: with a ``TorchDispatchMode``.
PRE_STACKING_ROUND = {
    "private/ideal": (28, "1dae57cf7e98d73b"),
    "remote/ideal": (44, "5e433daf2ef622ca"),
    "decoupled/ideal": (34, "52b32f56a438565a"),
    "ata/ideal": (38, "45da8fd53b53daa1"),
    "ata_bypass/ideal": (47, "2f82e7aa97327553"),
    "ata_fifo/ideal": (38, "45da8fd53b53daa1"),
    "ciao/ideal": (39, "882dc1730b47ceb8"),
    "victim/ideal": (67, "d450025158887e7b"),
    "private/crossbar": (29, "760b8587598f3371"),
    "remote/crossbar": (44, "5957281866303b4e"),
    "decoupled/crossbar": (35, "d7b550315b57d4dc"),
    "ata/crossbar": (39, "b315dc984c230f26"),
    "ata_bypass/crossbar": (48, "e033eb56dc2cea61"),
    "ata_fifo/crossbar": (39, "b315dc984c230f26"),
    "ciao/crossbar": (40, "6677fd89404d332d"),
    "victim/crossbar": (68, "ca4d944f8097e3f6"),
    "private/ring": (32, "4230c32771f719b3"),
    "remote/ring": (47, "d0809f1b1533512f"),
    "decoupled/ring": (38, "5a55d81cb42103ee"),
    "ata/ring": (42, "c6792da4d1bb0a33"),
    "ata_bypass/ring": (51, "78085fc5aa8f4b3c"),
    "ata_fifo/ring": (42, "c6792da4d1bb0a33"),
    "ciao/ring": (43, "651b1c53c2441376"),
    "victim/ring": (71, "37a9b84ec287301a"),
}
#: conversions a round adds since the crossbar's and ring's fractional
#: totals add in float64 and round once (``noc.base.point_sum``): the
#: crossbar's delivered flits and delay sum, the ring's delay sum
POINT_SUM_CONVERSIONS = {"ideal": 0, "crossbar": 2, "ring": 1}


class _OpRecorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("key", sorted(PRE_STACKING_ROUND))
def test_one_member_pass_dispatches_the_pre_stacking_ops(key, monkeypatch):
    """Stacking costs a plain batch nothing: the same ops, in the same
    order, each round (so the same kernel launches on the card)."""
    arch, noc = key.split("/")
    rec, calls, plain_round = _OpRecorder(), [0], psim._round

    def round_(*args, **kwargs):
        calls[0] += 1
        if calls[0] != 6:
            return plain_round(*args, **kwargs)
        with rec:
            return plain_round(*args, **kwargs)

    monkeypatch.setattr(psim, "_round", round_)
    params = dataclasses.replace(PORT_APPS["HS3D"], rounds=6)
    simulate_batch(arch, [port_make_trace(params, kernel=k) for k in (0, 1)],
                   noc=noc, device="cpu")
    rest = [op for op in rec.ops if op != "aten._to_copy.default"]
    n_conv, digest = PRE_STACKING_ROUND[key]
    assert len(rec.ops) - len(rest) == n_conv + POINT_SUM_CONVERSIONS[noc]
    assert hashlib.sha256("\n".join(rest).encode()).hexdigest()[:16] \
        == digest, f"{key}: {len(rest)} ops besides conversions"
