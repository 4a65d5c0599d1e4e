"""Port parity on a mid-run tag state: ``fused_probe_rank`` (torch
backend, and the kernel wrapper's plain version) against the reference
``lax`` backend, and every paper policy's ``l1_stage`` against the
reference's, with the state carried across by ``repro_torch.convert``.

The mid-run state comes from driving the reference round loop over the
first rounds of a real trace, so it holds the duplicates, dirty lines
and remote copies the simulator itself produces.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import APPS, PAPER_GEOMETRY, make_trace  # noqa: E402
from repro.core import simulator as rsim  # noqa: E402
from repro.core.arch import PAPER_ARCHITECTURES, get_arch  # noqa: E402
from repro.core.noc import get_noc  # noqa: E402
from repro.core.probe import fused_probe_rank as ref_fused  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import arch as parch  # noqa: E402
from repro_torch.core import simulator as psim  # noqa: E402
from repro_torch.core.geometry import DeviceGeometry  # noqa: E402
from repro_torch.core.probe import fused_probe_rank  # noqa: E402
from repro_torch.kernels.ata_probe_rank import ata_probe_rank  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: structure-changing geometry: 8 cores in clusters of 4, 4 sets of 8 ways
SMALL = dataclasses.replace(PAPER_GEOMETRY, n_cores=8, cluster_size=4,
                            l1_sets=4, l1_ways=8)
GEOMS = {"small": SMALL, "paper": PAPER_GEOMETRY}
WARM_ROUNDS = 40
PROBE_ROUNDS = 8   # rounds after the warm-up whose requests probe it


@functools.lru_cache(maxsize=None)
def _mid_run(geom_name: str):
    """(reference geom, trace, l1 state after WARM_ROUNDS of ``ata``)."""
    geom = GEOMS[geom_name]
    trace = make_trace(dataclasses.replace(APPS["cfd"],
                                           rounds=WARM_ROUNDS + PROBE_ROUNDS),
                       n_cores=geom.n_cores, kernel=1)
    policy, noc = get_arch("ata"), get_noc("ideal")
    state = (rsim._l1_state(geom, [policy]), rsim._l2_state(geom),
             rsim._noc_state(geom, [noc]), jnp.int32(0),
             rsim._init_stats(geom))
    step = jax.jit(functools.partial(
        rsim._round, policy, [noc], jnp.int32(0), geom,
        jnp.float32(trace.insn_per_req),
        jnp.zeros((geom.n_cores,), jnp.int32)))
    for t in range(WARM_ROUNDS):
        state, _ = step(state, (jnp.asarray(trace.addr[t]),
                                jnp.asarray(trace.is_write[t])))
    l1 = {k: np.asarray(v) for k, v in state[0].items()}
    return geom, trace, l1


def _both_requests(geom, trace, t=WARM_ROUNDS):
    ref_reqs = rsim._request_batch(geom, jnp.asarray(trace.addr[t]),
                                   jnp.asarray(trace.is_write[t]))
    g = DeviceGeometry(convert.geometry(geom), "cpu")
    C, m = trace.addr.shape[1:]
    port_reqs = psim._request_batch(
        g, torch.from_numpy(trace.addr[t])[None],
        torch.from_numpy(trace.is_write[t])[None],
        psim._routing(g, 1, C, m, "cpu"))
    return g, ref_reqs, port_reqs


def _eq(got, want, name):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=name)


@pytest.mark.parametrize("geom_name", sorted(GEOMS))
def test_fused_probe_rank_torch_matches_reference_lax(geom_name):
    geom, trace, l1 = _mid_run(geom_name)
    state = convert.tag_state(l1, device="cpu")
    ref_probe = jax.jit(functools.partial(ref_fused, geom))
    seen_local = seen_remote = False
    for t in range(WARM_ROUNDS, WARM_ROUNDS + PROBE_ROUNDS):
        g, ref_reqs, port_reqs = _both_requests(geom, trace, t)
        want = ref_probe({k: jnp.asarray(v) for k, v in l1.items()},
                         ref_reqs)
        got = fused_probe_rank(g, state, port_reqs, backend="torch")
        # the kernel wrapper on CPU tensors runs the plain version
        plain = ata_probe_rank(
            port_reqs.set_idx, port_reqs.addr, port_reqs.core,
            port_reqs.cluster * geom.cluster_size, port_reqs.is_write,
            state["tags"], state["valid"], state["dirty"],
            cluster_size=geom.cluster_size)
        for name, p in zip(want._fields, plain):
            _eq(getattr(got, name)[0], getattr(want, name), name)
            _eq(p[0], getattr(want, name), f"plain {name}")
        seen_local |= bool(np.asarray(want.local_hit).any())
        seen_remote |= bool(np.asarray(want.remote_ok).any())
    assert seen_local and seen_remote


def test_probe_backend_resolution():
    geom, trace, l1 = _mid_run("small")
    g, _, port_reqs = _both_requests(geom, trace)
    state = convert.tag_state(l1, device="cpu")
    a = fused_probe_rank(g, state, port_reqs)            # CPU default
    b = fused_probe_rank(g, state, port_reqs, backend="torch")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fused_probe_rank(g, state, port_reqs, backend="cuda")
    with pytest.raises(ValueError, match="probe_backend must be one of"):
        fused_probe_rank(g, state, port_reqs, backend="lax")


@pytest.mark.parametrize("arch", PAPER_ARCHITECTURES)
@pytest.mark.parametrize("geom_name", sorted(GEOMS))
def test_l1_stage_matches_reference(geom_name, arch):
    geom, trace, l1 = _mid_run(geom_name)
    g, ref_reqs, port_reqs = _both_requests(geom, trace)
    t = WARM_ROUNDS
    want = jax.jit(functools.partial(get_arch(arch).l1_stage, geom))(
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
            _eq(getattr(got, name)[0], w, name)


# ---------------------------------------------------------------------------
# the unfused chain: the reference's ``lax_unfused``
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pre", [False, True], ids=["plain", "pre_served"])
@pytest.mark.parametrize("replacement", ["LRU", "FIFO"])
@pytest.mark.parametrize("geom_name", sorted(GEOMS))
def test_torch_unfused_matches_reference_lax_unfused(geom_name, replacement,
                                                     pre):
    from repro.core.tagarray import ReplacementPolicy as RefPolicy
    from repro_torch.core.tagarray import ReplacementPolicy
    geom, trace, l1 = _mid_run(geom_name)
    state = convert.tag_state(l1, device="cpu")
    ref_probe = jax.jit(functools.partial(
        ref_fused, geom, replacement=RefPolicy[replacement],
        backend="lax_unfused"))
    dead_differs = False
    for t in range(WARM_ROUNDS, WARM_ROUNDS + PROBE_ROUNDS):
        g, ref_reqs, port_reqs = _both_requests(geom, trace, t)
        served = (np.random.default_rng(t).random(port_reqs.addr.shape[1])
                  < 0.3) if pre else None
        want = ref_probe({k: jnp.asarray(v) for k, v in l1.items()},
                         ref_reqs, pre_served=None if served is None
                         else jnp.asarray(served))
        kw = dict(pre_served=None if served is None
                  else torch.from_numpy(served)[None])
        got = fused_probe_rank(g, state, port_reqs,
                               replacement=ReplacementPolicy[replacement],
                               backend="torch_unfused", **kw)
        fused = fused_probe_rank(g, state, port_reqs, backend="torch", **kw)
        for name in want._fields:
            w = getattr(want, name)
            assert getattr(got, name).dtype == getattr(fused, name).dtype
            _eq(getattr(got, name)[0], w, name)       # dead lanes too
            if name != "touch_way":
                _eq(getattr(fused, name)[0], w, f"fused {name}")
        dead = ~np.asarray(want.local_hit)
        dead_differs |= bool((np.asarray(want.touch_way)[dead]
                              != fused.touch_way[0].numpy()[dead]).any())
    assert dead_differs     # the victim probe really ran


def test_simulate_bit_equal_across_fused_and_unfused_chains():
    import json
    from repro_torch.core import SweepGrid, simulate
    from repro_torch.core import make_trace as port_make_trace
    from repro_torch.core import APPS as PORT_APPS

    def as_json(r):
        d = r._asdict()
        d["per_app"] = [a._asdict() for a in r.per_app]
        d["noc"] = r.noc._asdict()
        return json.dumps(d, sort_keys=True)

    geom = convert.geometry(SMALL)
    trace = port_make_trace(dataclasses.replace(PORT_APPS["cfd"],
                                                rounds=160),
                            n_cores=8, kernel=1)
    for arch in ("ata", "ata_fifo"):
        want = simulate(arch, trace, geom, probe_backend="torch",
                        device="cpu")
        got = simulate(arch, trace, geom, probe_backend="torch_unfused",
                       device="cpu")
        assert as_json(got) == as_json(want), arch
    grid = SweepGrid(["ata"], [geom], [trace],
                     probe_backends=["torch", "torch_unfused"])
    run = grid.run(device="cpu")
    assert run.report.n_executables == 2      # one pass per backend
    assert as_json(run.results[0]) == as_json(run.results[1])


def test_serving_engine_refuses_the_unfused_chain():
    from repro_torch.serving import ServingConfig
    with pytest.raises(ValueError, match="probe_backend must be None or"):
        ServingConfig(probe_backend="torch_unfused")
