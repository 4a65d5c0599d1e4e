"""Port parity: the multi-device paths, on the CPU.

* ``SweepGrid.run(devices=[...])``: four listed CPU devices (one device
  named four times: the counterpart of the reference's forced host
  devices) split each bucket's points into contiguous slices; every
  point equals the one-device run's bit for bit and the reference's
  per-point ``simulate()`` (the reference's own sharded sweep fails on
  this jax, so it is not the oracle), and the report says D.
* 4 ``gloo`` ranks (``sharding/compat.spawn``, a ``file://`` rendezvous
  under the test's temporary directory, a timeout on every spawn: a
  hung collective fails the test instead of hanging the suite): a "dp"
  ZeRO-1 step and a "tp" step on ``make_test_mesh()`` (2 x 2) from the
  reference's seed-0 state (``convert.train_state``), two steps each,
  against the port's one-process step and the reference's one-device
  step, at ``test_torch_train.py``'s tolerances (loss and grad norm rel
  1e-5; m, v within 1e-4 of their leaf's largest; parameters within
  2 x the steps' summed lr everywhere and 1e-3 x it where the step-1
  gradient is clear of the noise: the gradients are summed over the
  ranks in another order); "tp" and "dp" within 1e-3 of each other
  (the reference's bar);
* ``all_reduce_compressed`` over 4 ranks against the reference's
  ``shard_map`` version on 4 forced host devices (a subprocess, as
  ``tests/test_sharding.py`` runs it): bit for bit (the int8 payload
  sums exactly as int32; the scales' max and the divisions are exact
  IEEE operations in both);
* a checkpoint saved from the 4 "tp" ranks (full leaves) restored onto
  2 ranks and onto one process: the next step matches the 4 ranks'
  uninterrupted step; ``launch/train.py --mesh test`` resumed on 2 ranks
  from a 4-rank run matches one process's ``train()``;
* every family on the same mesh, one spawn per profile: one "dp" and one
  "tp" step of the MoE, RWKV6, RG-LRU and encoder-decoder smoke configs,
  and of qwen3 and MoE accumulating two microbatches, against one
  process's step and the reference's one-device step at the tolerances
  above ("tp" and "dp" within 1e-3); MoE's groups, capacities and aux
  loss are the global batch's under "dp", and the microbatches global
  rows; a "tp" prefill ``forward`` and decode steps of five families
  equal one process's, every cache leaf placed as the reference's cache
  shardings place it.

Each spawn takes ~5-25 s here (four fresh interpreters that import
torch and this module). The spawned ranks unpickle their functions from
this module, so it imports the reference (and JAX) only inside the
functions that use it.
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import textwrap
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.core import (PAPER_GEOMETRY, SweepGrid,  # noqa: E402
                              simulate)
from repro_torch.core import simulator as psim  # noqa: E402
from repro_torch.core import sweep as psweep  # noqa: E402
from repro_torch.core.telemetry import TelemetryConfig  # noqa: E402
from repro_torch.data import DataConfig, make_batch  # noqa: E402
from repro_torch.launch import train as port_launch  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     make_test_mesh)
from repro_torch.optim import AdamWConfig, compression  # noqa: E402
from repro_torch.sharding.compat import spawn  # noqa: E402
from repro_torch.sharding.rules import make_rules  # noqa: E402
from repro_torch.train import step as PS  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORLD = 4
TIMEOUT_S = 240
ARCH = "qwen3-0.6b"
B, S = 4, 32
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
STEPS = 2
LOSS_REL = 1e-5
LEAF_REL = 1e-4
NOISE = 1e-3
TP_DP = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process (each spawned rank sets its
    own): the parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref():
    """The reference's modules, imported on first use (not by the
    spawned ranks)."""
    import types
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.core import APPS, PAPER_GEOMETRY, make_trace, simulate
    from repro.optim.adamw import AdamWConfig
    from repro.train import step
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, smoke=get_smoke_config, APPS=APPS,
        GEOMETRY=PAPER_GEOMETRY, make_trace=make_trace, simulate=simulate,
        AdamW=AdamWConfig, RS=step)


def _rdzv(tmp_path, name):
    return f"file://{tmp_path / name}"


# ---------------------------------------------------------------------------
# the split sweep
# ---------------------------------------------------------------------------
def result_dict(r) -> dict:
    d = r._asdict()
    d["per_app"] = [a._asdict() for a in r.per_app]
    d["noc"] = r.noc._asdict()
    return d


def assert_same(got, want, where=""):
    """Two SimResults equal field by field, NaN where NaN."""
    g, w = result_dict(got), result_dict(want)
    assert list(g) == list(w)
    for k, wv in w.items():
        if isinstance(wv, float) and math.isnan(wv):
            assert math.isnan(g[k]), (where, k)
        else:
            assert g[k] == wv, (where, k, g[k], wv)


@functools.lru_cache(maxsize=None)
def _traces(app, rounds, kernels=(0,)):
    R = _ref()
    ref = [R.make_trace(dataclasses.replace(R.APPS[app], rounds=rounds),
                        kernel=k) for k in kernels]
    return ref, [convert.trace(t) for t in ref]


def _geoms():
    return [PAPER_GEOMETRY,
            dataclasses.replace(PAPER_GEOMETRY, noc_bw=8.0),
            dataclasses.replace(PAPER_GEOMETRY, l1_ways=4)]


SPLIT_GRIDS = {
    # a stacked family beside a plain architecture, two kernels
    "family": lambda: dict(archs=("private", "ata", "ata_fifo", "victim"),
                           geoms=None, app=("HS3D", 32, (0, 1)),
                           nocs=("ideal",)),
    # scalar and structural geometries: several buckets of uneven size
    "geometry": lambda: dict(archs=("remote", "ata"), geoms=_geoms(),
                             app=("cfd", 48, (0,)), nocs=("ideal",)),
    # stacked NoC models
    "noc": lambda: dict(archs=("ata",), geoms=None, app=("HS3D", 48, (0,)),
                        nocs=("ideal", "crossbar", "ring")),
}


@pytest.mark.parametrize("name", sorted(SPLIT_GRIDS))
def test_split_sweep_bit_equal_to_one_device_and_reference(name):
    spec = SPLIT_GRIDS[name]()
    ref_traces, traces = _traces(*spec["app"])
    grid = SweepGrid(spec["archs"], spec["geoms"], traces, nocs=spec["nocs"])
    one = grid.run(device="cpu")
    split = grid.run(devices=["cpu"] * WORLD)
    assert one.report.n_devices == 1
    assert split.report.n_devices == WORLD
    assert split.report.n_points == one.report.n_points == len(grid.points)
    assert split.report.n_executables == one.report.n_executables
    by_trace = {id(t): r for t, r in zip(traces, ref_traces)}
    for p, got, want in zip(grid.points, split.results, one.results):
        where = (p.arch, p.noc, p.geom.noc_bw, p.geom.l1_ways)
        assert_same(got, want, where)
        if p.noc == "ideal":
            R = _ref()
            ref_geom = dataclasses.replace(R.GEOMETRY,
                                           **dataclasses.asdict(p.geom))
            assert_same(got, R.simulate(p.arch, by_trace[id(p.trace)],
                                        ref_geom), where)
        else:
            assert_same(got, simulate(p.arch, p.trace, p.geom, noc=p.noc,
                                      device="cpu"), where)


def test_split_sweep_cuts_contiguous_slices_one_pass_per_device(
        monkeypatch):
    """Each bucket's points go to the devices in contiguous slices of
    ceil(B / D), in the points' order; a slice that would be empty makes
    no pass."""
    _, traces = _traces("cfd", 16, (0, 1, 2))
    seen = []
    real = psweep._PointPass

    class Recording(real):
        def __init__(self, archs, nocs, tr, geoms, **kw):
            seen.append(([t.addr.ctypes.data for t in tr], kw["device"]))
            super().__init__(archs, nocs, tr, geoms, **kw)

    monkeypatch.setattr(psweep, "_PointPass", Recording)
    devs = [torch.device("cpu")] * 3
    grid = SweepGrid(("ata", "victim", "remote"), None, traces)
    run = grid.run(devices=devs)
    assert run.report.n_devices == 3
    ids = [t.addr.ctypes.data for t in traces]
    # buckets: {ata, victim} (6 points -> 2 + 2 + 2), {remote} (3 -> 1+1+1)
    assert [s for s, _ in seen] == [ids[:2], ids[2:] + ids[:1], ids[1:],
                                    ids[:1], ids[1:2], ids[2:]]
    assert all(d == torch.device("cpu") for _, d in seen)


def test_split_sweep_takes_the_first_d_devices():
    """D = max(1, min(n_devices or all, all)), the reference's rule; fewer
    points than devices leave the extra devices idle."""
    _, traces = _traces("cfd", 16, (0,))
    grid = SweepGrid(("ata", "remote"), None, traces)
    one = grid.run(device="cpu")
    for n, want in ((None, WORLD), (2, 2), (8, WORLD), (1, 1)):
        run = grid.run(n, devices=["cpu"] * WORLD)
        assert run.report.n_devices == want
        for got, ref in zip(run.results, one.results):
            assert_same(got, ref)
    with pytest.raises(ValueError, match="one type"):
        grid.run(devices=["cpu", "meta"])


def test_split_sweep_on_cuda_splits_only_when_asked(monkeypatch):
    """On a host with 4 cards the default ``"cuda"`` runs on one device
    (one host thread issues every pass, so a split only adds launches);
    ``n_devices`` or ``devices`` splits."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert psweep.split_devices() == [torch.device("cuda")]
    assert psweep.split_devices(None, "cuda:1") == [cards[1]]
    assert psweep.split_devices(2, "cuda") == cards[:2]
    assert psweep.split_devices(8, "cuda") == cards
    assert psweep.split_devices(None, "cuda", cards[1:]) == cards[1:]
    assert psweep.split_devices(None, "cpu") == [torch.device("cpu")]


def test_split_sweep_keeps_each_points_timeline():
    """With telemetry, every point's timeline equals the one-device
    run's."""
    _, traces = _traces("HS3D", 32, (0,))
    tel = TelemetryConfig(window=16)
    grid = SweepGrid(("ata", "victim", "private"), None, traces)
    one = grid.run(device="cpu", telemetry=tel)
    split = grid.run(devices=["cpu"] * 2, telemetry=tel)
    for a, b, ra, rb in zip(one.timelines, split.timelines, one.results,
                            split.results):
        assert_same(rb, ra)
        assert a.meta == b.meta
        assert a.cumulative.keys() == b.cumulative.keys()
        for k, v in a.cumulative.items():
            np.testing.assert_array_equal(b.cumulative[k], v, err_msg=k)


def test_one_pass_runs_rounds_as_simulate_points():
    """``_PointPass`` taken a round at a time is ``_simulate_points``."""
    _, traces = _traces("cfd", 16, (0, 1))
    args = (["ata", "victim"], ["ideal", "ideal"], traces,
            [PAPER_GEOMETRY] * 2)
    want = psim._simulate_points(*args, probe_backend="torch", device="cpu")
    p = psim._PointPass(*args, probe_backend="torch", device="cpu")
    for i in range(p.rounds):
        p.round(i)
    for a, b in zip(p.finish(), want):
        assert_same(a, b)


# ---------------------------------------------------------------------------
# spawn
# ---------------------------------------------------------------------------
def _sum_rank(x):
    t = torch.tensor([x * (dist.get_rank() + 1)])
    dist.all_reduce(t)
    return dist.get_rank(), dist.get_world_size(), int(t)


def _fail_rank():
    if dist.get_rank() == 2:
        raise ValueError("rank two fails on purpose")
    return dist.get_rank()


def _hang_rank():
    if dist.get_rank() != 0:
        dist.barrier()            # rank 0 never joins
    else:
        time.sleep(60)
    return dist.get_rank()


def _mesh_rank():
    out = {}
    try:
        make_production_mesh()
    except ValueError as e:
        out["production"] = str(e)
    mesh = make_test_mesh(1, 1)
    out["test"] = (tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape))
    return out


def test_spawn_returns_each_ranks_result_in_rank_order(tmp_path):
    got = spawn(_sum_rank, WORLD, backend="gloo", timeout_s=TIMEOUT_S,
                init_method=_rdzv(tmp_path, "sum"), args=(3,))
    assert got == [(r, WORLD, 3 * 10) for r in range(WORLD)]


def test_spawn_raises_with_the_failing_ranks_traceback(tmp_path):
    with pytest.raises(RuntimeError, match="rank two fails on purpose"):
        spawn(_fail_rank, WORLD, backend="gloo", timeout_s=TIMEOUT_S,
              init_method=_rdzv(tmp_path, "fail"))


def test_spawn_stops_a_hung_collective_at_its_timeout(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="not done after"):
        spawn(_hang_rank, 2, backend="gloo", timeout_s=5,
              init_method=_rdzv(tmp_path, "hang"))
    assert time.monotonic() - t0 < 40


def test_production_mesh_needs_its_ranks(tmp_path):
    """The reference's 16 x 16 mesh is a shape: on a group of one rank it
    raises; the test mesh builds."""
    (out,) = spawn(_mesh_rank, 1, backend="gloo", timeout_s=TIMEOUT_S,
                   init_method=_rdzv(tmp_path, "mesh"))
    assert "needs 256 ranks" in out["production"]
    assert out["test"] == (("data", "model"), (1, 1))


# ---------------------------------------------------------------------------
# sharded train steps
# ---------------------------------------------------------------------------
def _cfg():
    """The reference's qwen3 smoke config on the blocked route, f32, remat
    per layer (remat and the chunked loss run under both profiles)."""
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(ARCH),
                               attention_impl="blocked", remat="layer")


def _batches():
    dcfg = DataConfig(vocab_size=_cfg().vocab_size, seq_len=S,
                      global_batch=B)
    return [make_batch(dcfg, i) for i in range(STEPS)]


def _tensors(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _ref_run():
    """The reference's seed-0 state and its states and metrics after each
    of STEPS one-device steps (numpy)."""
    R = _ref()
    rcfg = dataclasses.replace(R.smoke(ARCH), remat="layer")
    assert convert.model_config(rcfg) == dataclasses.replace(
        _cfg(), attention_impl=rcfg.attention_impl)
    state = R.RS.init_train_state(R.jax.random.PRNGKey(0), rcfg)
    step = R.jax.jit(R.RS.make_train_step(rcfg, R.AdamW(**OPT)))
    states, metrics = [R.jax.tree.map(np.asarray, state)], []
    for b in _batches():
        state, m = step(state, {k: R.jnp.asarray(v) for k, v in b.items()})
        states.append(R.jax.tree.map(np.asarray, state))
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics


def _full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t
            ).detach().clone()


def _snapshot(state):
    """Full params, m and v of a (placed) state; a collective when the
    state holds DTensors."""
    return {"params": {k: _full(p) for k, p in
                       state["params"].named_parameters()},
            "m": {k: _full(t) for k, t in state["opt"]["m"].items()},
            "v": {k: _full(t) for k, t in state["opt"]["v"].items()}}


def _train_rank(ref_state0, batches, ckpt_dir):
    """Both profiles on the 2 x 2 mesh from the reference's seed-0 state,
    STEPS steps; the "tp" state saved after step 1."""
    cfg = _cfg()
    mesh = make_test_mesh()
    out = {}
    for profile in ("dp", "tp"):
        rules = make_rules(cfg, mesh, batch_size=B, profile=profile)
        state = PS.place_train_state(
            convert.train_state(ref_state0, cfg, device="cpu"), cfg, mesh,
            rules)
        step = PS.make_train_step(cfg, AdamWConfig(**OPT), mesh=mesh,
                                  rules=rules)
        metrics, snaps = [], []
        for i, b in enumerate(batches):
            if profile == "tp" and i == 1:
                CheckpointStore(ckpt_dir).save(1, state, wait=True)
            state, m = step(state, PS.local_batch(_tensors(b), mesh, rules))
            metrics.append({k: float(v) for k, v in m.items()})
            snaps.append(_snapshot(state))
        out[profile] = {
            "metrics": metrics,
            "snaps": snaps if dist.get_rank() == 0 else None,
            "m_local": {k: tuple(t.to_local().shape)
                        for k, t in state["opt"]["m"].items()},
            "params_dtensor": any(hasattr(p, "to_local") for p in
                                  state["params"].parameters())}
    return out


def _restore_rank(ckpt_dir, batch, like_state0):
    """A "tp" state restored from the 4-rank checkpoint onto this group's
    (1, world) mesh, then one step."""
    cfg = _cfg()
    mesh = make_test_mesh(1, dist.get_world_size())
    rules = make_rules(cfg, mesh, batch_size=B, profile="tp")
    like = PS.place_train_state(
        convert.train_state(like_state0, cfg, device="cpu"), cfg, mesh, rules)
    state, at = CheckpointStore(ckpt_dir).restore(
        like, mesh=mesh, placements=PS.state_placements(
            like["params"], cfg, mesh, rules))
    step = PS.make_train_step(cfg, AdamWConfig(**OPT), mesh=mesh,
                              rules=rules)
    state, m = step(state, PS.local_batch(_tensors(batch), mesh, rules))
    snap = _snapshot(state)
    return at, float(m["loss"]), snap if dist.get_rank() == 0 else None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's, one process's and the 4 ranks' runs, and the "tp"
    checkpoint after step 1."""
    states, ref_metrics = _ref_run()
    cfg = _cfg()
    one = convert.train_state(states[0], cfg, device="cpu")
    step = PS.make_train_step(cfg, AdamWConfig(**OPT))
    one_metrics, one_snaps = [], []
    for b in _batches():
        one, m = step(one, _tensors(b))
        one_metrics.append({k: float(v) for k, v in m.items()})
        one_snaps.append(_snapshot(one))
    tmp = tmp_path_factory.mktemp("dist_train")
    ckpt = str(tmp / "ckpt")
    ranks = spawn(_train_rank, WORLD, backend="gloo", timeout_s=TIMEOUT_S,
                  init_method=_rdzv(tmp, "rdzv"),
                  args=(states[0], _batches(), ckpt))
    return {"ref_states": states, "ref_metrics": ref_metrics,
            "one_metrics": one_metrics, "one_snaps": one_snaps,
            "ranks": ranks, "ckpt": ckpt, "tmp": tmp}


def _ref_leaves(state, cfg):
    """The reference's numpy state as {key: {port name: tensor}}."""
    port = convert.train_state(state, cfg, device="cpu")
    return {"params": {k: p.detach() for k, p in
                       port["params"].named_parameters()},
            "m": port["opt"]["m"], "v": port["opt"]["v"]}


def _lr_sum(metrics, n):
    return sum(m["lr"] for m in metrics[:n])


def assert_state_close(got, want, metrics, n, where):
    """Parameters within 2 x the summed lr (1e-3 x it where the step-1
    gradient is clear of the noise), m and v within LEAF_REL of their
    leaf's largest value."""
    lr = _lr_sum(metrics, n)
    g1 = want["m1"]
    for k, w in want["params"].items():
        diff = (got["params"][k] - w).abs()
        assert float(diff.max()) <= 2 * lr + 1e-7, (where, k)
        clear = g1[k].abs() > NOISE * g1[k].abs().max()
        if clear.any():
            assert float(diff[clear].max()) <= NOISE * lr + 1e-7, (where, k)
    for key in ("m", "v"):
        for k, w in want[key].items():
            rel = float((got[key][k] - w).abs().max()
                        / w.abs().max().clamp_min(1e-30))
            assert rel <= (LEAF_REL if n == 1 else NOISE), (where, key, k)


def _want_one(runs, n):
    snap = dict(runs["one_snaps"][n - 1])
    snap["m1"] = runs["one_snaps"][0]["m"]
    return snap


def _want_ref(runs, n):
    cfg = _cfg()
    snap = _ref_leaves(runs["ref_states"][n], cfg)
    snap["m1"] = _ref_leaves(runs["ref_states"][1], cfg)["m"]
    return snap


@pytest.mark.parametrize("oracle", ("one_process", "reference"))
@pytest.mark.parametrize("profile", ("dp", "tp"))
def test_sharded_step_matches_one_device(runs, profile, oracle):
    """Each profile's STEPS steps on 4 ranks against the port's
    one-process step and the reference's one-device step: loss, grad
    norm, lr, parameters, m and v."""
    got = runs["ranks"][0][profile]
    want_m = (runs["one_metrics"] if oracle == "one_process"
              else runs["ref_metrics"])
    for n in range(1, STEPS + 1):
        g, w = got["metrics"][n - 1], want_m[n - 1]
        assert abs(g["loss"] - w["loss"]) <= LOSS_REL * abs(w["loss"]), n
        assert abs(g["grad_norm"] - w["grad_norm"]) <= \
            LOSS_REL * w["grad_norm"], n
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
        want = _want_one(runs, n) if oracle == "one_process" \
            else _want_ref(runs, n)
        assert_state_close(got["snaps"][n - 1], want, want_m, n,
                           (profile, oracle, n))


def test_tp_and_dp_losses_agree(runs):
    """The reference's bar between its two profiles: 1e-3."""
    dp, tp = (runs["ranks"][0][p]["metrics"] for p in ("dp", "tp"))
    for a, b in zip(dp, tp):
        assert abs(a["loss"] - b["loss"]) < TP_DP


def test_every_rank_reports_the_same_metrics(runs):
    for profile in ("dp", "tp"):
        want = runs["ranks"][0][profile]["metrics"]
        for r in runs["ranks"][1:]:
            assert r[profile]["metrics"] == want, profile


def test_zero1_shards_the_moments_over_the_data_ranks(runs):
    """m and v hold half their first free dimension on each rank (data
    size 2); "dp" keeps plain parameters, "tp" makes them DTensors."""
    cfg = _cfg()
    shapes = {k: tuple(p.shape) for k, p in
              PS.init_train_state(cfg, generator=torch.Generator(
                  "cpu").manual_seed(0), device="cpu")[
                  "params"].named_parameters()}
    dp, tp = (runs["ranks"][0][p] for p in ("dp", "tp"))
    assert not dp["params_dtensor"] and tp["params_dtensor"]
    # dp: nothing else is sharded, so the first dimension that 2 divides
    for k, shape in shapes.items():
        want = list(shape)
        for i, d in enumerate(shape):
            if d % 2 == 0:
                want[i] = d // 2
                break
        assert dp["m_local"][k] == tuple(want), k
    # tp: the vocab rows are over "model"; ZeRO-1 cuts the embedding
    assert tp["m_local"]["embed.table"] == (shapes["embed.table"][0] // 2,
                                            shapes["embed.table"][1] // 2)
    assert tp["m_local"]["layers.0.mlp.wi.kernel"] == (
        shapes["layers.0.mlp.wi.kernel"][0] // 2,
        shapes["layers.0.mlp.wi.kernel"][1] // 2)


def test_checkpoint_holds_full_leaves(runs):
    """The 4 "tp" ranks wrote full leaves in the one-device layout: a
    one-device state restores from it unchanged in shape."""
    manifest = json.loads(open(os.path.join(
        runs["ckpt"], "step_00000001", "manifest.json")).read())
    cfg = _cfg()
    like = PS.init_train_state(cfg, generator=torch.Generator(
        "cpu").manual_seed(0), device="cpu")
    for k, p in like["params"].named_parameters():
        assert manifest["leaves"][f"params/{k}"]["shape"] == list(p.shape)
        assert manifest["leaves"][f"opt/m/{k}"]["shape"] == list(p.shape)
    assert manifest["leaves"]["opt/step"]["shape"] == []


def test_checkpoint_from_4_ranks_restores_onto_2(runs):
    """Re-mesh: the 4-rank "tp" checkpoint of step 1 on a (1, 2) mesh;
    the next step matches the 4 ranks' uninterrupted step 2."""
    b2 = _batches()[1]
    res = spawn(_restore_rank, 2, backend="gloo", timeout_s=TIMEOUT_S,
                init_method=_rdzv(runs["tmp"], "rdzv2"),
                args=(runs["ckpt"], b2, runs["ref_states"][0]))
    at, loss, snap = res[0]
    assert at == 1 and res[1][:2] == (at, loss)
    tp = runs["ranks"][0]["tp"]
    want = dict(tp["snaps"][1], m1=tp["snaps"][0]["m"])
    assert abs(loss - tp["metrics"][1]["loss"]) <= LOSS_REL * abs(loss)
    assert_state_close(snap, want, tp["metrics"], 2, "2 ranks")


def test_checkpoint_from_4_ranks_restores_onto_1(runs):
    """Re-mesh onto one process: restore into a one-device state (here
    from another seed, so every leaf must come from the checkpoint) and
    take the one-process step."""
    cfg = _cfg()
    like = PS.init_train_state(cfg, generator=torch.Generator(
        "cpu").manual_seed(5), device="cpu")
    state, at = CheckpointStore(runs["ckpt"]).restore(like)
    assert at == 1 and int(state["opt"]["step"]) == 1
    state, m = PS.make_train_step(cfg, AdamWConfig(**OPT))(
        state, _tensors(_batches()[1]))
    tp = runs["ranks"][0]["tp"]
    want = dict(tp["snaps"][1], m1=tp["snaps"][0]["m"])
    assert abs(float(m["loss"]) - tp["metrics"][1]["loss"]) <= \
        LOSS_REL * float(m["loss"])
    assert_state_close(_snapshot(state), want, tp["metrics"], 2, "1 process")


def test_train_cli_mesh_test_resumes_on_two_ranks(tmp_path, capsys):
    """``launch/train.py --mesh test`` on 4 gloo ranks to step 2, resumed
    with ``--nproc 2`` to step 3: the checkpoint matches one process's
    ``train()`` over the same 3 steps."""
    ckpt = str(tmp_path / "ckpt")
    common = ["--arch", ARCH, "--smoke", "--batch", str(B), "--seq", str(S),
              "--device", "cpu", "--mesh", "test", "--ckpt-dir", ckpt]
    port_launch.main(common + ["--steps", "2", "--init-method",
                               _rdzv(tmp_path, "a")])
    port_launch.main(common + ["--steps", "3", "--nproc", "2",
                               "--init-method", _rdzv(tmp_path, "b")])
    out = capsys.readouterr().out
    assert "mesh (2, 2)" in out and "mesh (1, 2)" in out
    cfg = dataclasses.replace(port_launch.get_smoke_config(ARCH),
                              attention_impl="blocked")
    one, losses = port_launch.train(cfg, steps=3, global_batch=B, seq_len=S,
                                    device="cpu", log_every=10**9)
    like = PS.init_train_state(cfg, generator=torch.Generator(
        "cpu").manual_seed(9), device="cpu")
    state, at = CheckpointStore(ckpt).restore(like)
    assert at == 3
    # the default schedule's warmup keeps lr at <= 3 x 3e-6: all three
    # steps move an element by at most 2 x their summed lr apart
    lr = sum(AdamWConfig().lr * s / AdamWConfig().warmup_steps
             for s in (1, 2, 3))
    for (k, p), q in zip(state["params"].named_parameters(),
                         one["params"].parameters()):
        assert float((p - q).abs().max()) <= 2 * lr + 1e-7, k


# ---------------------------------------------------------------------------
# the compressed all-reduce
# ---------------------------------------------------------------------------
REF_COMPRESS = """
import sys
from functools import partial
import numpy as np
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.optim.compression import all_reduce_compressed
from repro.sharding.compat import make_mesh, shard_map
mesh = make_mesh((4,), ("data",))
f = partial(shard_map, mesh=mesh, in_specs=(P("data"), P("data")),
            out_specs=(P("data"), P("data")))(
    lambda g, e: all_reduce_compressed(g, e, "data"))
for src, dst in zip(sys.argv[1::2], sys.argv[2::2]):
    d = np.load(src)
    red, err = f(jnp.asarray(d["g"]), jnp.asarray(d["e"]))
    np.savez(dst, red=np.asarray(red), err=np.asarray(err))
"""


def _compress_inputs(with_error):
    rng = np.random.default_rng(0)
    g = rng.standard_normal((8, 64)).astype(np.float32)
    e = (0.01 * rng.standard_normal((8, 64)) if with_error
         else np.zeros((8, 64))).astype(np.float32)
    return g, e


def _compress_rank(inputs):
    r = dist.get_rank()
    rows = slice(2 * r, 2 * r + 2)
    out = []
    for g, e in inputs:
        red, err = compression.all_reduce_compressed(
            {"g": torch.from_numpy(g[rows])},
            {"g": torch.from_numpy(e[rows])})
        out.append((red["g"].numpy(), err["g"].numpy()))
    return out


@pytest.fixture(scope="module")
def compressed(tmp_path_factory):
    """Both packages' results for both inputs: the reference in a
    subprocess on 4 forced host devices, the port on 4 ranks."""
    tmp = tmp_path_factory.mktemp("compress")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    inputs = [_compress_inputs(with_error) for with_error in (False, True)]
    paths = []
    for i, (g, e) in enumerate(inputs):
        np.savez(tmp / f"in{i}.npz", g=g, e=e)
        paths += [str(tmp / f"in{i}.npz"), str(tmp / f"out{i}.npz")]
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_COMPRESS),
                        *paths], capture_output=True, text=True, env=env,
                       timeout=TIMEOUT_S)
    assert r.returncode == 0, r.stderr
    port = spawn(_compress_rank, WORLD, backend="gloo", timeout_s=TIMEOUT_S,
                 init_method=_rdzv(tmp, "rdzv"), args=(inputs,))
    out = {}
    for i, with_error in enumerate((False, True)):
        ref = np.load(tmp / f"out{i}.npz")
        out[with_error] = inputs[i] + (ref["red"], ref["err"],
                                       [p[i] for p in port])
    return out


@pytest.mark.parametrize("with_error", (False, True))
def test_compressed_all_reduce_matches_reference_on_4_devices(
        compressed, with_error):
    g, e, red, err, port = compressed[with_error]
    for r, (pred, perr) in enumerate(port):
        np.testing.assert_array_equal(pred, red[2 * r:2 * r + 2])
        np.testing.assert_array_equal(perr, err[2 * r:2 * r + 2])


@pytest.mark.parametrize("with_error", (False, True))
def test_compressed_all_reduce_is_the_mean_within_quantization(
        compressed, with_error):
    """Every rank gets the same result, within 2 x scale of the exact
    mean (the reference test's bar), and its residual is what the shared
    scale left: g + e - q x s."""
    g, e, _, _, port = compressed[with_error]
    g32 = g + e
    exact = g32.reshape(4, 2, 64).mean(0)
    scale = np.abs(g32).max() / 127.0
    for pred, perr in port:
        np.testing.assert_array_equal(pred, port[0][0])
        assert np.abs(pred - exact).max() < 2 * scale
        assert np.abs(perr).max() <= 0.5 * scale * (1 + 1e-6)


# ---------------------------------------------------------------------------
# every family sharded: "dp" and "tp" steps, accumulation, decode
# ---------------------------------------------------------------------------
FAMILIES = ("granite-moe-1b-a400m", "rwkv6-3b", "recurrentgemma-9b",
            "whisper-tiny")
MOE = "granite-moe-1b-a400m"
#: (arch, accum_steps, global batch, sequence): each family's one step at
#: the file's shape; qwen3 and MoE accumulating two microbatches (a
#: batch of 8 x 16, so that each microbatch splits over the 4 "dp" ranks)
STEP_CASES = tuple((a, 1, B, S) for a in FAMILIES) + (
    (ARCH, 2, 8, 16), (MOE, 2, 8, 16))
DECODE_ARCHS = (ARCH,) + FAMILIES
S_ENC = 16
DEC_PROMPT, DEC_STEPS = 16, 4
#: a sharded forward and decode against one process's: max |diff| over
#: max |logit| (f32; the sharded matmuls add in another order)
DECODE_REL = 1e-5


def _fcfg(arch):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch),
                               attention_impl="blocked", remat="layer")


def _fbatch(arch, b, s):
    """The pipeline's step-0 batch of ``b`` x ``s`` (with seeded encoder
    frames for an encoder-decoder), numpy."""
    cfg = _fcfg(arch)
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                  global_batch=b), 0)
    if cfg.is_enc_dec:
        batch["enc_frames"] = np.random.default_rng(7).standard_normal(
            (b, S_ENC, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _ref_state0(arch):
    """The reference's seed-0 train state of ``arch``'s smoke config
    (numpy)."""
    R = _ref()
    rcfg = dataclasses.replace(R.smoke(arch), remat="layer")
    return R.jax.tree.map(np.asarray, R.RS.init_train_state(
        R.jax.random.PRNGKey(0), rcfg))


def _ref_family(arch, accum, b, s):
    """The reference's state after one one-device step from its seed-0
    state with ``accum`` microbatches, and that step's metrics (numpy)."""
    R = _ref()
    rcfg = dataclasses.replace(R.smoke(arch), remat="layer")
    state = R.jax.tree.map(R.jnp.asarray, _ref_state0(arch))
    step = R.jax.jit(R.RS.make_train_step(rcfg, R.AdamW(**OPT), accum))
    state, m = step(state, {k: R.jnp.asarray(v)
                            for k, v in _fbatch(arch, b, s).items()})
    return (R.jax.tree.map(np.asarray, state),
            {k: float(v) for k, v in m.items()})


def _decode_run(cfg, params, toks, enc, mesh=None, rules=None):
    """Logits of a prefill forward and of DEC_STEPS decode steps (full
    tensors), and the cache leaves' placements (None when plain)."""
    import contextlib
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import transformer as T
    from repro_torch.sharding.rules import (logical_to_spec, place,
                                            rules_context)
    ctx = contextlib.ExitStack()
    wrap = (lambda t: t)
    if mesh is not None:
        ctx.enter_context(rules_context(mesh, rules))
        ctx.enter_context(implicit_replication())
        bp = logical_to_spec(("batch",), rules, mesh)
        wrap = (lambda t: None if t is None else place(t, mesh, bp))
    out = []
    with ctx, torch.no_grad():
        logits, _ = T.forward(params, cfg, wrap(toks[:, :DEC_PROMPT]),
                              enc_frames=wrap(enc))
        out.append(_full(logits))
        cache = T.init_cache(cfg, toks.shape[0], DEC_PROMPT + DEC_STEPS,
                             device="cpu", params=params,
                             enc_frames=wrap(enc))
        for i in range(DEC_STEPS):
            logits, cache = T.decode_step(params, cfg,
                                          wrap(toks[:, i:i + 1]), cache)
            out.append(_full(logits))
        # each leaf against the reference's cache shardings (a dimension
        # the mesh does not divide stays whole, as ``annotate`` keeps it)
        wrong = []
        if mesh is not None:
            from repro_torch.launch.specs import cache_axes
            from repro_torch.sharding.rules import _divisible
            for i, c in enumerate(cache):
                for k, t in c.items():
                    want = _divisible(t.shape, logical_to_spec(
                        cache_axes(f"{i}/{k}", t.dim()), rules, mesh), mesh)
                    got = (tuple(t.placements) if isinstance(t, DTensor)
                           else None)
                    if got != want:
                        wrong.append((i, k, got, want))
    return out, wrong


def _family_rank(profile, cases, decode):
    """One spawn of a profile group on the 2 x 2 mesh: each case's step
    from the reference's seed-0 state; with ``decode`` (numpy tokens and
    frames per arch), each arch's sharded forward and decode (its logits,
    for one process's run in the test process, and the cache leaves'
    misplacements)."""
    from repro_torch.sharding.rules import param_placements, place_params
    mesh = make_test_mesh()
    out = {"steps": {}, "decode": {}}
    for (arch, accum, b, s), state0, batch in cases:
        cfg = _fcfg(arch)
        rules = make_rules(cfg, mesh, batch_size=b, profile=profile)
        state = PS.place_train_state(
            convert.train_state(state0, cfg, device="cpu"), cfg, mesh, rules)
        step = PS.make_train_step(cfg, AdamWConfig(**OPT), accum,
                                  mesh=mesh, rules=rules)
        state, m = step(state, PS.local_batch(_tensors(batch), mesh, rules,
                                              accum))
        snap = _snapshot(state)
        out["steps"][(arch, accum)] = {
            "metrics": {k: float(v) for k, v in m.items()},
            "snap": snap if dist.get_rank() == 0 else None}
    for arch, (toks, enc) in decode.items():
        cfg = _fcfg(arch)
        params = _decode_params(cfg)
        rules = make_rules(cfg, mesh, batch_size=B, profile=profile)
        got, wrong = _decode_run(
            cfg, place_params(params, mesh, param_placements(
                params, mesh, rules)), torch.from_numpy(toks),
            None if enc is None else torch.from_numpy(enc), mesh, rules)
        out["decode"][arch] = {"logits": got, "wrong": wrong}
    return out


def _decode_params(cfg):
    from repro_torch.models import transformer as T
    return T.init_params(cfg, generator=torch.Generator("cpu").manual_seed(0),
                         device="cpu")


def _decode_inputs(arch):
    cfg = _fcfg(arch)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (B, DEC_PROMPT + DEC_STEPS))
    enc = (rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
           if cfg.is_enc_dec else None)
    return toks.astype(np.int64), enc


@pytest.fixture(scope="module")
def family_runs(tmp_path_factory):
    """The reference's and one process's step of every case and one
    process's decode logits, while one spawn of 4 ranks per profile
    ("tp" also runs the decode checks) and one of one rank (a "tp" step)
    run."""
    cases = [(case, _ref_state0(case[0]), _fbatch(case[0], *case[2:]))
             for case in STEP_CASES]
    tmp = tmp_path_factory.mktemp("families")
    decode = {a: _decode_inputs(a) for a in DECODE_ARCHS}
    ref, one, want = {}, {}, {}
    with ThreadPoolExecutor(3) as pool:
        ranks = {p: pool.submit(
            spawn, _family_rank, WORLD, backend="gloo",
            timeout_s=2 * TIMEOUT_S, init_method=_rdzv(tmp, f"rdzv_{p}"),
            args=(p, cases, decode if p == "tp" else {}))
            for p in ("dp", "tp")}
        one_rank = pool.submit(
            spawn, _one_rank_tp_rank, 1, backend="gloo", timeout_s=TIMEOUT_S,
            init_method=_rdzv(tmp, "one"),
            args=(_ref_state0(MOE), _fbatch(MOE, B, S)))
        for (arch, accum, b, s), s0, batch in cases:
            ref[(arch, accum)] = _ref_family(arch, accum, b, s)
            cfg = _fcfg(arch)
            state, m = PS.make_train_step(cfg, AdamWConfig(**OPT), accum)(
                convert.train_state(s0, cfg, device="cpu"), _tensors(batch))
            one[(arch, accum)] = ({k: float(v) for k, v in m.items()},
                                  _snapshot(state))
        for arch, (toks, enc) in decode.items():
            cfg = _fcfg(arch)
            want[arch], _ = _decode_run(
                cfg, _decode_params(cfg), torch.from_numpy(toks),
                None if enc is None else torch.from_numpy(enc))
        ranks = {p: f.result() for p, f in ranks.items()}
        one_rank = one_rank.result()[0]
    return {"ref": ref, "one": one, "ranks": ranks, "one_rank": one_rank,
            "decode_want": want}


def _case_id(case):
    return f"{case[0]}-accum{case[1]}"


@pytest.mark.parametrize("oracle", ("one_process", "reference"))
@pytest.mark.parametrize("profile", ("dp", "tp"))
@pytest.mark.parametrize("case", STEP_CASES, ids=_case_id)
def test_family_sharded_step_matches_one_device(family_runs, case, profile,
                                                oracle):
    """One step of each family (and the accumulating cases) on 4 ranks
    against the port's one-process step and the reference's one-device
    step, at the file's tolerances. For MoE under "dp" this holds the
    global batch's groups, capacities and aux loss (each slice alone
    would route its tokens in groups of its own size), and with
    accumulation the reference's microbatches (global rows, each its own
    mean)."""
    arch, accum = case[:2]
    cfg = _fcfg(arch)
    got = family_runs["ranks"][profile][0]["steps"][(arch, accum)]
    if oracle == "one_process":
        w, snap = family_runs["one"][(arch, accum)]
        want = dict(snap, m1=snap["m"])
    else:
        s1, w = family_runs["ref"][(arch, accum)]
        want = _ref_leaves(s1, cfg)
        want["m1"] = want["m"]
    g = got["metrics"]
    assert abs(g["loss"] - w["loss"]) <= LOSS_REL * abs(w["loss"])
    assert abs(g["grad_norm"] - w["grad_norm"]) <= \
        LOSS_REL * w["grad_norm"]
    assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
    assert_state_close(got["snap"], want, [w], 1,
                       (arch, accum, profile, oracle))


@pytest.mark.parametrize("case", STEP_CASES, ids=_case_id)
def test_family_tp_and_dp_losses_agree(family_runs, case):
    """The reference's bar between its two profiles (1e-3), and every
    rank's metrics the same."""
    key = case[:2]
    dp, tp = (family_runs["ranks"][p] for p in ("dp", "tp"))
    assert abs(dp[0]["steps"][key]["metrics"]["loss"]
               - tp[0]["steps"][key]["metrics"]["loss"]) < TP_DP
    for runs in (dp, tp):
        for r in runs[1:]:
            assert r["steps"][key]["metrics"] == \
                runs[0]["steps"][key]["metrics"]


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_sharded_forward_and_decode_match_one_process(family_runs, arch):
    """Under "tp" on the 2 x 2 mesh: a prefill forward and DEC_STEPS
    decode steps of each family give one process's logits (DECODE_REL),
    and every cache leaf is a DTensor placed as the reference's cache
    shardings place it (heads over "model" where head-TP; the recurrent
    states over their channels)."""
    want = family_runs["decode_want"][arch]
    for r in family_runs["ranks"]["tp"]:
        got = r["decode"][arch]
        rel = [float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got["logits"], want)]
        assert len(rel) == DEC_STEPS + 1 and max(rel) <= DECODE_REL, rel
        assert got["wrong"] == [], got["wrong"]


def _one_rank_tp_rank(state0, batch):
    """A MoE "tp" step on a (1, 1) mesh: one batch slice, so the aux loss
    takes the one-slice path, and must still come back a DTensor."""
    cfg = _fcfg(MOE)
    mesh = make_test_mesh(1, 1)
    rules = make_rules(cfg, mesh, batch_size=B, profile="tp")
    state = PS.place_train_state(
        convert.train_state(state0, cfg, device="cpu"), cfg, mesh, rules)
    _, m = PS.make_train_step(cfg, AdamWConfig(**OPT), mesh=mesh,
                              rules=rules)(
        state, PS.local_batch(_tensors(batch), mesh, rules))
    return {k: float(v) for k, v in m.items()}


def test_moe_tp_step_on_one_rank_matches_one_process(family_runs):
    """The one-rank group the card machine runs: MoE's "tp" step on (1, 1)
    equals one process's (loss and grad norm rel 1e-5)."""
    got = family_runs["one_rank"]
    want = family_runs["one"][(MOE, 1)][0]
    for k in ("loss", "grad_norm"):
        assert abs(got[k] - want[k]) <= LOSS_REL * abs(want[k]), k
