"""Port parity: the serving path ``repro_torch.serving``.

* request streams (``core/trace/serving.py``, a numpy copy) array-equal
  to the reference's for each tenant and mix, and for ``sequential`` /
  ``batched``;
* the port's numpy oracle ``run_stream`` equal to the reference's;
* ``serve_stream`` against the reference engine under its ``lax`` and
  ``pallas_interpret`` probe backends, for each policy x B in {1, 2, 4}
  at 4 shards x 64 rounds (the reference's own test sizes): counters
  and ``shard_load`` exact, and the latency grid, cycles and tenant
  sums exact under ``ideal``;
* the same under ``crossbar`` and ``ring``, every field exact: with 4
  flits per block and a port rate of 16/C the NoC's float32 sums are of
  whole numbers far below 2**24, so no add order can change them;
* one cell of the committed serving baseline
  (``benchmarks/baselines/serving_rounds512.json``);
* the port's own contract: device default, probe backends, the stream
  hash contract, the headroom guard.

The port runs with ``device="cpu"`` (its CPU probe backend is
``torch``); the card runs the ``cuda`` backend in ``chip_smoke.py``.
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.trace import serving as rtrace  # noqa: E402
from repro.serving import ServingConfig as RefConfig  # noqa: E402
from repro.serving import ref as rref  # noqa: E402
from repro.serving import serve_stream as ref_serve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.trace import serving as ptrace  # noqa: E402
from repro_torch.serving import (SERVING_POLICIES, ServingConfig,  # noqa: E402
                                 engine, serve_stream)
from repro_torch.serving import ref as pref  # noqa: E402

N_SHARDS = 4
ROUNDS = 64
BASELINE = (pathlib.Path(__file__).resolve().parents[1] / "benchmarks"
            / "baselines" / "serving_rounds512.json")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_stream():
    return rtrace.ServingMix(("chat", "batch")).make_stream(
        n_shards=N_SHARDS, rounds=ROUNDS, seed=1)


@pytest.fixture(scope="module")
def stream(ref_stream):
    return convert.request_stream(ref_stream)


@pytest.fixture(scope="module")
def oracle(stream):
    return {p: pref.run_stream(p, pref.AtaCacheConfig(), stream)
            for p in SERVING_POLICIES}


def _same_stream(a, b):
    for f in ("valid", "hashes", "n_blocks", "tenant"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.tenants, a.slots) == (b.tenants, b.slots)


def _assert_counters(res, st):
    assert res.local_hits == st.local_hits
    assert res.remote_hits == st.remote_hits
    assert res.recomputed_blocks == st.recomputed_blocks
    assert res.probe_messages == st.probe_messages
    assert res.remote_fetch_blocks == st.remote_fetch_blocks
    assert res.directory_sync_entries == st.directory_sync_entries
    np.testing.assert_array_equal(res.shard_load, st.shard_load)


def _assert_results_equal(got, want):
    """Every ServeResult field bit-equal (the reference's telemetry
    fields aside)."""
    assert got._fields == want._fields[:-1]       # all but hist_exact
    for f in got._fields:
        if f == "lat_hist":
            continue
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, (f, g, w)


# ---------------------------------------------------------------------------
# request streams
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tenant", sorted(rtrace.TENANTS))
def test_tenant_streams_equal_reference(tenant):
    for slot in (0, 3):
        _same_stream(
            ptrace.tenant_stream(tenant, n_shards=8, rounds=300, seed=5,
                                 slot=slot),
            rtrace.tenant_stream(tenant, n_shards=8, rounds=300, seed=5,
                                 slot=slot))
    assert ptrace.TENANTS[tenant] == ptrace.TenantParams(
        **vars(rtrace.TENANTS[tenant]))


@pytest.mark.parametrize("names", [("chat", "rag"), ("chat", "batch"),
                                   ("rag",), ("chat", "rag", "batch")])
@pytest.mark.parametrize("slots", (1, 2, 4))
def test_mix_streams_equal_reference(names, slots):
    kw = dict(n_shards=8, rounds=128, seed=2, slots=slots)
    got = ptrace.ServingMix(names).make_stream(**kw)
    want = rtrace.ServingMix(names).make_stream(**kw)
    _same_stream(got, want)
    _same_stream(got.sequential(), want.sequential())
    _same_stream(got.batched(1), want.batched(1))
    _same_stream(got.slot_sequential(), want.slot_sequential())


# ---------------------------------------------------------------------------
# the numpy oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", SERVING_POLICIES)
def test_oracle_equals_reference_oracle(ref_stream, stream, oracle, policy):
    want = rref.run_stream(policy, rref.AtaCacheConfig(), ref_stream)
    got = oracle[policy]
    for f in ("local_hits", "remote_hits", "recomputed_blocks",
              "probe_messages", "remote_fetch_blocks",
              "directory_sync_entries", "hot_block_load"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.shard_load, want.shard_load)


# ---------------------------------------------------------------------------
# the engine against the reference engine and the oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("slots", (1, 2, 4))
@pytest.mark.parametrize("policy", SERVING_POLICIES)
@pytest.mark.parametrize("ref_backend", ("lax", "pallas_interpret"))
def test_engine_matches_reference_engine(ref_stream, stream, oracle,
                                         ref_backend, policy, slots):
    got = serve_stream(policy, stream.batched(slots), device="cpu")
    want = ref_serve(policy, ref_stream.batched(slots),
                     RefConfig(probe_backend=ref_backend))
    _assert_counters(got, oracle[policy])
    _assert_results_equal(got, want)


@pytest.mark.parametrize("policy", SERVING_POLICIES)
def test_engine_matches_oracle_sequential(ref_stream, policy):
    """One request per round: the oracle's one-at-a-time order."""
    seq = convert.request_stream(ref_stream.sequential())
    _assert_counters(serve_stream(policy, seq, device="cpu"),
                     pref.run_stream(policy, pref.AtaCacheConfig(), seq))


@pytest.mark.parametrize("noc", ("crossbar", "ring"))
@pytest.mark.parametrize("policy", ("broadcast", "ata"))   # private: no fetch
def test_engine_matches_reference_under_noc(ref_stream, stream, oracle,
                                            policy, noc):
    got = serve_stream(policy, stream.batched(2), ServingConfig(noc=noc),
                       device="cpu")
    want = ref_serve(policy, ref_stream.batched(2), RefConfig(noc=noc))
    _assert_counters(got, oracle[policy])
    _assert_results_equal(got, want)
    assert got.noc_injected == got.noc_delivered + got.noc_queued
    assert got.noc_injected > 0


def test_b1_matches_committed_baseline():
    """The committed baseline's (8 shards, chat+rag, ata, B=1) cell."""
    rep = json.loads(BASELINE.read_text())
    cell = next(c for c in rep["cells"]
                if (c["shards"], c["mix"], c["policy"], c["slots"])
                == (8, "chat+rag", "ata", 1))
    st = ptrace.ServingMix(("chat", "rag"), name="chat+rag").make_stream(
        n_shards=8, rounds=cell["rounds"], seed=rep["config"]["seed"])
    res = serve_stream("ata", st, device="cpu")
    assert st.n_requests == cell["requests"]
    for f in ("local_hits", "remote_hits", "recomputed_blocks",
              "probe_messages", "remote_fetch_blocks"):
        assert getattr(res, f) == cell[f], f
    for f in ("hit_rate", "load_imbalance", "p50_latency", "p99_latency",
              "requests_per_kcycle"):
        assert getattr(res, f) == pytest.approx(cell[f], rel=1e-12), f


def test_block_conservation_and_tenant_sums(stream):
    res = serve_stream("ata", stream.batched(4), device="cpu")
    total = int(stream.n_blocks[stream.valid].sum())
    assert res.local_hits + res.remote_hits + res.recomputed_blocks == total
    assert int(res.tenant_blocks.sum()) == total
    assert int(res.tenant_requests.sum()) == stream.n_requests
    assert res.slots == 4 and res.lat_hist is None


# ---------------------------------------------------------------------------
# the port's own contract
# ---------------------------------------------------------------------------
def test_probe_backends_agree_on_the_cpu(stream):
    """``_probe_all`` through the kernel wrapper (its plain version on
    CPU tensors) equals the plain gather/compare backend."""
    rng = np.random.default_rng(0)
    C, K, S, W = N_SHARDS, stream.max_blocks, 64, 8
    tags = torch.from_numpy(
        rng.integers(0, 40, (C, S, W)).astype(np.int32))
    h = torch.from_numpy(rng.integers(0, 40, (C, K)).astype(np.int32))
    sets = h % S
    a = engine._probe_all(tags, h, sets, backend="torch")
    b = engine._probe_all(tags, h, sets, backend="cuda")
    assert a.shape == (C, K, C) and a.any()
    assert torch.equal(a, b)


def test_config_and_device_contract(stream):
    with pytest.raises(ValueError, match="probe_backend"):
        ServingConfig(probe_backend="lax")
    with pytest.raises(ValueError, match="unknown NoC model"):
        ServingConfig(noc="mesh")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        serve_stream("ata", stream, ServingConfig(probe_backend="cuda"),
                     device="cpu")
    with pytest.raises(ValueError, match="policy must be one of"):
        serve_stream("decoupled", stream, device="cpu")
    with pytest.raises(ValueError, match="f32"):
        serve_stream("private", stream,
                     ServingConfig(lat_recompute=2.0 ** 24), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve_stream("ata", stream)


def test_stream_hash_contract_is_checked(stream):
    hashes = stream.hashes.copy()
    t, c = np.argwhere(stream.valid)[0]
    hashes[t, c, 0] = 0
    bad = ptrace.RequestStream(valid=stream.valid, hashes=hashes,
                               n_blocks=stream.n_blocks,
                               tenant=stream.tenant, tenants=stream.tenants)
    with pytest.raises(ValueError, match="hash >= 1"):
        serve_stream("ata", bad, device="cpu")


def test_serving_config_carries_across(stream):
    ref_cfg = RefConfig(noc="ring", lat_fetch=5.0, probe_backend="pallas")
    cfg = convert.serving_config(ref_cfg)
    assert cfg == ServingConfig(noc="ring", lat_fetch=5.0)
    assert cfg.geometry(8) == convert.geometry(ref_cfg.geometry(8))
