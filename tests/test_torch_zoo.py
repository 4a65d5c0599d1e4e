"""Port parity: the contention-policy zoo (``ata_bypass``, ``ata_fifo``,
``ciao``, ``victim``) and the tag-array extensions under it.

* ``tagarray``'s victim buffer and dead-victim detector against the
  reference's on seeded numpy inputs, many evictions from one cache in
  one round included (the buffer keeps the last writer: a sequential
  insert is a different buffer);
* ``fused_probe_rank(pre_served=...)`` on the ``torch`` backend and the
  kernel's plain version under ``deny = is_write | pre_served`` against
  the reference's ``lax`` and ``pallas_interpret`` backends;
* each zoo policy's ``l1_stage`` on a mid-run state (whole simulations
  are in ``tests/test_torch_zoo_sim.py``);
* the 45 cells of ``benchmarks/baselines/sensitivity_rounds96.json``;
* the degenerate policies (``victim_ways=0`` is ``ata``,
  ``thrash_threshold=0`` is ``private``) bit for bit, at the L1 stage
  and through the whole simulator.

Integral counters must agree exactly, every other float within
``rtol=1e-6`` (the bar of ``tests/test_arch_registry.py::GOLDEN``).
"""
import dataclasses
import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import APPS as REF_APPS  # noqa: E402
from repro.core import PAPER_GEOMETRY as REF_GEOMETRY  # noqa: E402
from repro.core import make_trace as ref_make_trace  # noqa: E402
from repro.core import simulator as rsim  # noqa: E402
from repro.core import tagarray as rtag  # noqa: E402
from repro.core.arch import get_arch as ref_get_arch  # noqa: E402
from repro.core.noc import get_noc as ref_get_noc  # noqa: E402
from repro.core.probe import fused_probe_rank as ref_fused  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import arch as parch  # noqa: E402
from repro_torch.core import simulator as psim  # noqa: E402
from repro_torch.core import tagarray as ptag  # noqa: E402
from repro_torch.core import (APPS, PAPER_GEOMETRY, make_trace,  # noqa: E402
                              registered_archs, simulate)
from repro_torch.core.arch import (AtaPolicy, CiaoPolicy,  # noqa: E402
                                   PrivatePolicy, VictimPolicy)
from repro_torch.core.geometry import DeviceGeometry  # noqa: E402
from repro_torch.core.probe import fused_probe_rank  # noqa: E402
from repro_torch.kernels.ata_probe_rank import (  # noqa: E402
    ata_probe_rank_plain)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ZOO = ("ata_bypass", "ata_fifo", "ciao", "victim")
Policy = ptag.ReplacementPolicy


def _eq(got, want, name):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=name)


def _port_state(ref_state) -> dict:
    return convert.tag_state({k: np.asarray(v) for k, v in
                              ref_state.items()}, device="cpu")


def _assert_state_equal(port_state, ref_state, where=""):
    assert set(port_state) == set(ref_state), where
    for k, v in ref_state.items():
        _eq(port_state[k][0], v, f"{where}{k}")


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def test_registry_order_is_the_references():
    assert registered_archs() == ("private", "remote", "decoupled", "ata",
                                  "ata_bypass", "ata_fifo", "ciao",
                                  "victim")
    from repro.core.arch import registered_archs as ref_registered
    assert registered_archs() == ref_registered()
    assert parch.PAPER_ARCHITECTURES == ("private", "remote", "decoupled",
                                         "ata")


@pytest.mark.parametrize("arch", registered_archs())
def test_policy_declarations_match_reference(arch):
    p, r = parch.get_arch(arch), ref_get_arch(arch)
    assert p.stack_key == r.stack_key
    assert p.victim_ways == r.victim_ways
    assert p.track_thrash == r.track_thrash
    assert p.replacement.value == r.replacement.value


# ---------------------------------------------------------------------------
# tag-array extensions on seeded inputs
# ---------------------------------------------------------------------------
A, S, W, V = 4, 4, 8, 4       # arrays, sets, ways, victim-buffer entries


def _seeded_state(seed, *, victim_ways=V, thrash_lanes=0):
    """A reference TagState with random tags, timestamps and valid bits
    (``last == born`` on about half the ways: dead victims) and a
    random victim buffer with distinct install times."""
    rng = np.random.default_rng(seed)
    born = rng.integers(0, 50, (A, S, W)).astype(np.int32)
    last = np.where(rng.random((A, S, W)) < 0.5, born,
                    born + rng.integers(1, 9, (A, S, W))).astype(np.int32)
    vborn = np.stack([rng.permutation(40)[:victim_ways]
                      for _ in range(A)]).astype(np.int32)
    state = {
        "tags": rng.integers(0, 24, (A, S, W)).astype(np.int32),
        "last": last, "born": born,
        "valid": rng.random((A, S, W)) < 0.8,
        "dirty": rng.random((A, S, W)) < 0.3,
        "vtags": rng.integers(0, 24, (A, victim_ways)).astype(np.int32),
        "vvalid": rng.random((A, victim_ways)) < 0.6,
        "vborn": vborn.reshape(A, victim_ways),
        "thrash": rng.integers(0, 6, (thrash_lanes,)).astype(np.int32),
    }
    return {k: jnp.asarray(v) for k, v in state.items()}


def _seeded_requests(seed, R=24, arrays=A):
    rng = np.random.default_rng(seed + 1)
    # few arrays, so many requests aim at one cache in the round
    arr = rng.integers(0, min(arrays, 2), R).astype(np.int32)
    addr = rng.integers(0, 24, R).astype(np.int32)
    mask = rng.random(R) < 0.7
    return arr, addr, (addr % S).astype(np.int32), mask


def _t(x):
    return torch.from_numpy(np.asarray(x))[None]


@pytest.mark.parametrize("seed", range(4))
def test_victim_probe_matches_reference(seed):
    ref = _seeded_state(seed)
    arr, addr, _, _ = _seeded_requests(seed)
    # plant hits: some requests ask for a tag their buffer holds
    vt = np.asarray(ref["vtags"])
    addr[::3] = vt[arr[::3], seed % V]
    want = rtag.victim_probe(ref, jnp.asarray(arr), jnp.asarray(addr))
    got = ptag.victim_probe(_port_state(ref), _t(arr), _t(addr))
    _eq(got[0][0], want[0], "hit")
    _eq(got[1][0], want[1], "slot")
    assert got[1].dtype == torch.int32
    assert bool(np.asarray(want[0]).any())


@pytest.mark.parametrize("seed", range(4))
def test_victim_invalidate_matches_reference(seed):
    ref = _seeded_state(seed)
    arr, _, _, mask = _seeded_requests(seed)
    slot = np.random.default_rng(seed).integers(0, V, arr.size).astype(
        np.int32)
    want = rtag.victim_invalidate(ref, jnp.asarray(arr), jnp.asarray(slot),
                                  jnp.asarray(mask))
    got = ptag.victim_invalidate(_port_state(ref), _t(arr), _t(slot),
                                 _t(mask))
    _assert_state_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_victim_insert_matches_reference(seed):
    ref = _seeded_state(seed)
    arr, addr, _, mask = _seeded_requests(seed)
    now = 77
    want = rtag.victim_insert(ref, jnp.asarray(arr), jnp.asarray(addr),
                              jnp.int32(now), jnp.asarray(mask))
    got = ptag.victim_insert(_port_state(ref), _t(arr), _t(addr),
                             torch.tensor(now, dtype=torch.int32), _t(mask))
    _assert_state_equal(got, want)


def _sequential_insert(state, arr, addr, now, mask):
    """One insert per request, each seeing the buffer the one before it
    left: what a buffer with one write port per request would hold."""
    vtags, vvalid, vborn = (np.array(state[k]) for k in
                            ("vtags", "vvalid", "vborn"))
    for a, x, m in zip(arr, addr, mask):
        if not m:
            continue
        s = int(np.argmin(np.where(vvalid[a], vborn[a],
                                   np.iinfo(np.int32).min)))
        vtags[a, s], vvalid[a, s], vborn[a, s] = x, True, now
    return vtags, vvalid, vborn


def test_victim_insert_keeps_last_writer_not_a_sequential_insert():
    """Every request of the round evicts from cache 0: all aim at the
    slot the pre-insert buffer names, and only the last one lands. A
    sequential insert would fill several slots."""
    ref = _seeded_state(11)
    R = 12
    arr = np.zeros(R, np.int32)
    addr = np.arange(100, 100 + R, dtype=np.int32)
    mask = np.ones(R, bool)
    mask[-1] = False                   # the last writer is the 11th lane
    now = 90
    want = rtag.victim_insert(ref, jnp.asarray(arr), jnp.asarray(addr),
                              jnp.int32(now), jnp.asarray(mask))
    got = ptag.victim_insert(_port_state(ref), _t(arr), _t(addr),
                             torch.tensor(now, dtype=torch.int32), _t(mask))
    _assert_state_equal(got, want)
    changed = np.asarray(want["vtags"])[0] != np.asarray(ref["vtags"])[0]
    assert changed.sum() == 1
    assert int(np.asarray(want["vtags"])[0][changed][0]) == addr[R - 2]
    seq = _sequential_insert(ref, arr, addr, now, mask)
    assert not np.array_equal(seq[0], np.asarray(got["vtags"][0]))
    assert (seq[0][0] != np.asarray(ref["vtags"])[0]).sum() == V


@pytest.mark.parametrize("policy", list(Policy))
@pytest.mark.parametrize("seed", range(3))
def test_dead_victim_matches_reference(seed, policy):
    ref = _seeded_state(seed)
    arr, addr, set_idx, _ = _seeded_requests(seed, arrays=A)
    arr = np.random.default_rng(seed).integers(0, A, arr.size).astype(
        np.int32)
    want = rtag.dead_victim(ref, jnp.asarray(arr), jnp.asarray(set_idx),
                            jnp.asarray(addr),
                            policy=rtag.ReplacementPolicy(policy.value))
    got = ptag.dead_victim(_port_state(ref), _t(arr), _t(set_idx),
                           _t(addr), policy=policy)
    _eq(got[0], want, "dead")
    assert 0 < int(np.asarray(want).sum()) < arr.size


def test_zero_sized_extensions_are_no_ops():
    ref = _seeded_state(3, victim_ways=0)
    state = _port_state(ref)
    assert ptag.victim_ways(state) == 0
    arr, addr, _, mask = _seeded_requests(3)
    hit, slot = ptag.victim_probe(state, _t(arr), _t(addr))
    assert not bool(hit.any()) and not bool(slot.any())
    now = torch.tensor(5, dtype=torch.int32)
    assert ptag.victim_insert(state, _t(arr), _t(addr), now,
                              _t(mask)) is state
    assert ptag.victim_invalidate(state, _t(arr), slot, _t(mask)) is state


def test_init_tag_state_sizes_the_extensions():
    for vw, tl in ((0, 0), (8, 30)):
        ref = rtag.init_tag_state(30, 8, 64, victim_ways=vw,
                                  thrash_lanes=tl)
        got = ptag.init_tag_state(30, 8, 64, device="cpu", batch=3,
                                  victim_ways=vw, thrash_lanes=tl)
        for k, v in ref.items():
            assert tuple(got[k].shape) == (3,) + v.shape, k
            _eq(got[k][1], v, k)


# ---------------------------------------------------------------------------
# mid-run states: probe with pre_served, and each policy's l1_stage
# ---------------------------------------------------------------------------
#: structure-changing geometry where the caches fill within a few rounds
SMALL = dataclasses.replace(REF_GEOMETRY, n_cores=8, cluster_size=4,
                            l1_sets=4, l1_ways=8)
WARM_ROUNDS = 40


@functools.lru_cache(maxsize=None)
def _mid_run(arch: str):
    """(trace, l1 state after WARM_ROUNDS of ``arch`` on SMALL)."""
    trace = ref_make_trace(dataclasses.replace(REF_APPS["cfd"],
                                               rounds=WARM_ROUNDS + 4),
                           n_cores=SMALL.n_cores, kernel=1)
    policy, noc = ref_get_arch(arch), ref_get_noc("ideal")
    state = (rsim._l1_state(SMALL, [policy]), rsim._l2_state(SMALL),
             rsim._noc_state(SMALL, [noc]), jnp.int32(0),
             rsim._init_stats(SMALL))
    step = jax.jit(functools.partial(
        rsim._round, policy, [noc], jnp.int32(0), SMALL,
        jnp.float32(trace.insn_per_req),
        jnp.zeros((SMALL.n_cores,), jnp.int32)))
    for t in range(WARM_ROUNDS):
        state, _ = step(state, (jnp.asarray(trace.addr[t]),
                                jnp.asarray(trace.is_write[t])))
    return trace, {k: np.asarray(v) for k, v in state[0].items()}


def _both_requests(trace, t=WARM_ROUNDS):
    ref_reqs = rsim._request_batch(SMALL, jnp.asarray(trace.addr[t]),
                                   jnp.asarray(trace.is_write[t]))
    g = DeviceGeometry(convert.geometry(SMALL), "cpu")
    C, m = trace.addr.shape[1:]
    port_reqs = psim._request_batch(
        g, torch.from_numpy(trace.addr[t])[None],
        torch.from_numpy(trace.is_write[t])[None],
        psim._routing(g, 1, C, m, "cpu"))
    return g, ref_reqs, port_reqs


@pytest.mark.parametrize("mask", ["victim_probe", "random"])
def test_probe_rank_with_pre_served_matches_reference(mask):
    trace, l1 = _mid_run("victim")
    ref_l1 = {k: jnp.asarray(v) for k, v in l1.items()}
    state = convert.tag_state(l1, device="cpu")
    dropped = 0
    for t in range(WARM_ROUNDS, WARM_ROUNDS + 4):
        g, ref_reqs, port_reqs = _both_requests(trace, t)
        if mask == "random":
            pre = np.random.default_rng(t).random(
                ref_reqs.n_requests) < 0.5
        else:
            pre = np.asarray(rtag.victim_probe(ref_l1, ref_reqs.core,
                                               ref_reqs.addr)[0])
        pre_t = torch.from_numpy(pre)[None]
        want = ref_fused(SMALL, ref_l1, ref_reqs,
                         pre_served=jnp.asarray(pre), backend="lax")
        interp = ref_fused(SMALL, ref_l1, ref_reqs,
                           pre_served=jnp.asarray(pre),
                           backend="pallas_interpret")
        got = fused_probe_rank(g, state, port_reqs, pre_served=pre_t,
                               backend="torch")
        plain = ata_probe_rank_plain(
            port_reqs.set_idx, port_reqs.addr, port_reqs.core,
            port_reqs.cluster * SMALL.cluster_size,
            port_reqs.is_write | pre_t, state["tags"], state["valid"],
            state["dirty"], cluster_size=SMALL.cluster_size)
        free = fused_probe_rank(g, state, port_reqs, backend="torch")
        for name, p in zip(want._fields, plain):
            _eq(getattr(interp, name), getattr(want, name),
                f"pallas_interpret {name}")
            _eq(getattr(got, name)[0], getattr(want, name), name)
            _eq(p[0], getattr(want, name), f"plain {name}")
        dropped += int((free.remote_ok & ~got.remote_ok).sum())
        assert not bool((got.remote_ok & pre_t).any())
    if mask == "random":
        assert dropped > 0       # the mask took requests off the ports


@pytest.mark.parametrize("arch", ZOO)
def test_l1_stage_matches_reference_mid_run(arch):
    trace, l1 = _mid_run(arch)
    if arch == "victim":
        assert l1["vvalid"].any()
    if arch == "ciao":
        assert l1["thrash"].any()
    g, ref_reqs, port_reqs = _both_requests(trace)
    t = WARM_ROUNDS
    want = jax.jit(functools.partial(ref_get_arch(arch).l1_stage, SMALL))(
        {k: jnp.asarray(v) for k, v in l1.items()}, ref_reqs, jnp.int32(t))
    got = parch.get_arch(arch).l1_stage(
        g, convert.tag_state(l1, device="cpu"), port_reqs,
        torch.tensor(t, dtype=torch.int32))
    for name in want._fields:
        w = getattr(want, name)
        if name == "l1":
            for k in w:
                _eq(got.l1[k][0], w[k], f"l1.{k}")
        elif w is None:
            assert getattr(got, name, None) is None, name
        else:
            g_ = getattr(got, name)
            _eq(g_[0] if g_.dim() else g_, w, name)


def _outcomes_equal(a, b):
    assert set(a.l1) == set(b.l1)
    for k in a.l1:
        assert torch.equal(a.l1[k], b.l1[k]), k
    assert (a.bypass_fill is None) == (b.bypass_fill is None)
    for f in a._fields:
        if f in ("l1", "bypass_fill"):
            continue
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(x, y), f


def _own(state):
    """A copy of ``state`` for one stage: the stages write in place, so
    two stages handed one state would see each other's writes."""
    return {k: v.clone() for k, v in state.items()}


def test_degenerate_policies_at_the_l1_stage():
    """On a warmed state with the extensions present, the disabled zoo
    policies' rounds are their base policies', outputs and state."""
    trace, l1 = _mid_run("victim")
    g, _, reqs = _both_requests(trace)
    t = torch.tensor(WARM_ROUNDS, dtype=torch.int32)
    empty = convert.tag_state(dict(l1, vtags=l1["vtags"][:, :0],
                                   vvalid=l1["vvalid"][:, :0],
                                   vborn=l1["vborn"][:, :0]), device="cpu")
    _outcomes_equal(
        VictimPolicy(victim_ways=0).l1_stage(g, _own(empty), reqs, t),
        AtaPolicy().l1_stage(g, _own(empty), reqs, t))
    trace, l1 = _mid_run("ciao")
    g, _, reqs = _both_requests(trace)
    state = convert.tag_state(l1, device="cpu")
    _outcomes_equal(
        CiaoPolicy(thrash_threshold=0).l1_stage(g, _own(state), reqs, t),
        PrivatePolicy().l1_stage(g, _own(state), reqs, t))


# ---------------------------------------------------------------------------
# the sensitivity baseline, and the degenerate policies through the
# whole simulator
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _port(arch: str, app: str, rounds: int, geom=PAPER_GEOMETRY):
    tr = make_trace(dataclasses.replace(APPS[app], rounds=rounds), kernel=0)
    return simulate(arch, tr, geom, device="cpu")


BASELINE = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                        "baselines", "sensitivity_rounds96.json")
CELL_METRICS = ("ipc", "l1_hit_rate", "remote_hit_rate", "noc_flits",
                "l1_latency")


def _baseline():
    with open(BASELINE) as f:
        return json.load(f)


def test_sensitivity_baseline_has_45_cells():
    doc = _baseline()
    cfg = doc["config"]
    assert (cfg["app"], cfg["rounds"], cfg["kernels_per_app"]) == \
        ("HS3D", 96, 1)
    assert len(doc["cells"]) == 45
    assert {c["arch"] for c in doc["cells"]} == set(cfg["archs"])


@pytest.mark.parametrize("knob", ["l1_ways", "noc_bw", "hide"])
@pytest.mark.parametrize("arch", ["private", "remote", "ata", "ciao",
                                  "victim"])
def test_sensitivity_baseline_cells(arch, knob):
    """The committed sensitivity baseline (reference sweep, HS3D kernel
    0, 96 rounds): each (arch, knob) row of three values."""
    doc = _baseline()
    cells = [c for c in doc["cells"]
             if c["arch"] == arch and c["knob"] == knob]
    assert len(cells) == 3
    for c in cells:
        geom = dataclasses.replace(PAPER_GEOMETRY, **{knob: c["value"]})
        r = _port(arch, "HS3D", 96, geom)
        for metric in CELL_METRICS:
            got, want = float(getattr(r, metric)), c[metric]
            where = (arch, knob, c["value"], metric, got, want)
            if metric == "noc_flits":
                assert got == want, where
            else:
                assert math.isclose(got, want, rel_tol=1e-6,
                                    abs_tol=0.0), where


# ---------------------------------------------------------------------------
# degenerate policies through the whole simulator
# ---------------------------------------------------------------------------
@pytest.fixture
def temp_arch():
    names = []

    def _register(policy):
        names.append(policy.name)
        return parch.register_arch(policy, overwrite=True)

    yield _register
    for n in names:
        parch._REGISTRY.pop(n, None)


def test_victim_zero_ways_is_ata(temp_arch):
    temp_arch(VictimPolicy(name="victim0", victim_ways=0))
    assert _port("victim0", "HS3D", 384) == _port("ata", "HS3D", 384)


def test_ciao_zero_threshold_is_private(temp_arch):
    temp_arch(CiaoPolicy(name="ciao_off", thrash_threshold=0))
    assert _port("ciao_off", "HS3D", 384) == _port("private", "HS3D", 384)
