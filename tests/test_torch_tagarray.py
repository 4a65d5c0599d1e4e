"""Port parity: ``repro_torch.core.tagarray`` against the reference
``repro.core.tagarray`` on the same converted states, with planted
duplicate fill targets and masked-out lanes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import tagarray as ref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import tagarray as port  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


POLICIES = ("LRU", "FIFO", "RANDOM")

# one compile per shape instead of one per eager op
ref_probe = jax.jit(ref.probe, static_argnames="policy")
ref_probe_many = jax.jit(ref.probe_many)
ref_touch = jax.jit(ref.touch)
ref_fill = jax.jit(ref.fill)


def _state(rng, A=6, S=4, W=8, fill=0.7, tag_hi=24):
    """A populated reference TagState as numpy arrays."""
    st = {k: np.asarray(v) for k, v in ref.init_tag_state(A, S, W).items()}
    valid = rng.random((A, S, W)) < fill
    if A > 1:
        valid[1, 0] = True          # one full set: RANDOM's hash branch
    st.update(tags=rng.integers(0, tag_hi, (A, S, W)).astype(np.int32),
              valid=valid,
              dirty=valid & (rng.random((A, S, W)) < 0.3),
              last=rng.integers(-1, 50, (A, S, W)).astype(np.int32),
              born=rng.integers(-1, 50, (A, S, W)).astype(np.int32))
    return st


def _requests(rng, st, R=40, tag_hi=24):
    A, S, W = st["tags"].shape
    a = rng.integers(0, A, R).astype(np.int32)
    s = rng.integers(0, S, R).astype(np.int32)
    addr = rng.integers(0, tag_hi, R).astype(np.int32)
    way = rng.integers(0, W, R).astype(np.int32)
    mask = rng.random(R) < 0.6
    flag = rng.random(R) < 0.5
    # planted duplicates: lanes 0..5 all target (1, 0, 3) with distinct
    # addresses, masked in/out alternately, so last-writer-wins and the
    # masked-lane drop both decide the result
    a[:6], s[:6], way[:6] = 1, 0, 3
    addr[:6] = 100 + np.arange(6)
    mask[:6] = [True, False, True, True, False, False]
    flag[:6] = [True, True, False, True, False, True]
    return a, s, addr, way, mask, flag


def _t(x):
    return torch.from_numpy(np.asarray(x))[None]


def _assert_state_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k][0].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", [0, 1])
def test_probe_matches_reference(policy, seed):
    rng = np.random.default_rng(seed)
    st = _state(rng)
    a, s, addr, _, _, _ = _requests(rng, st)
    want = ref_probe({k: jnp.asarray(v) for k, v in st.items()},
                     jnp.asarray(a), jnp.asarray(s), jnp.asarray(addr),
                     policy=ref.ReplacementPolicy[policy])
    got = port.probe(convert.tag_state(st, device="cpu"), _t(a), _t(s),
                     _t(addr), policy=port.ReplacementPolicy[policy])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_many_matches_reference(seed):
    rng = np.random.default_rng(seed)
    st = _state(rng)
    _, s, addr, _, _, _ = _requests(rng, st)
    arrays = rng.integers(0, st["tags"].shape[0], (len(s), 3)).astype(np.int32)
    want = ref_probe_many({k: jnp.asarray(v) for k, v in st.items()},
                          jnp.asarray(arrays), jnp.asarray(s),
                          jnp.asarray(addr))
    got = port.probe_many(convert.tag_state(st, device="cpu"), _t(arrays),
                          _t(s), _t(addr))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


@pytest.mark.parametrize("set_dirty", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_touch_matches_reference(seed, set_dirty):
    rng = np.random.default_rng(seed)
    st = _state(rng)
    a, s, _, way, mask, flag = _requests(rng, st)
    now = 77
    want = ref_touch({k: jnp.asarray(v) for k, v in st.items()},
                     jnp.asarray(a), jnp.asarray(s), jnp.asarray(way),
                     jnp.int32(now), jnp.asarray(mask),
                     set_dirty=jnp.asarray(flag) if set_dirty else None)
    got = port.touch(convert.tag_state(st, device="cpu"), _t(a), _t(s),
                     _t(way), torch.tensor(now, dtype=torch.int32), _t(mask),
                     set_dirty=_t(flag) if set_dirty else None)
    _assert_state_equal(got, want)


@pytest.mark.parametrize("with_dirty", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fill_matches_reference(seed, with_dirty):
    rng = np.random.default_rng(seed)
    st = _state(rng)
    a, s, addr, way, mask, flag = _requests(rng, st)
    now = 91
    want_st, want_ev = ref_fill(
        {k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(a),
        jnp.asarray(s), jnp.asarray(way), jnp.asarray(addr), jnp.int32(now),
        jnp.asarray(mask), dirty=jnp.asarray(flag) if with_dirty else None)
    got_st, got_ev = port.fill(
        convert.tag_state(st, device="cpu"), _t(a), _t(s), _t(way), _t(addr),
        torch.tensor(now, dtype=torch.int32), _t(mask),
        dirty=_t(flag) if with_dirty else None)
    _assert_state_equal(got_st, want_st)
    np.testing.assert_array_equal(got_ev[0].numpy(), np.asarray(want_ev))
    # the planted duplicates: lane 3 is the last masked-in writer
    assert int(got_st["tags"][0, 1, 0, 3]) == 103


def test_batched_state_equals_per_point():
    """P points in one call == each point alone (no cross-point reads
    or writes), for probe, touch and fill."""
    rng = np.random.default_rng(5)
    states = [_state(rng) for _ in range(3)]
    reqs = [_requests(rng, st) for st in states]
    big = {k: torch.cat([convert.tag_state(st, device="cpu")[k]
                         for st in states])
           for k in states[0]}
    cols = [torch.from_numpy(np.stack(c)) for c in zip(*reqs)]
    a, s, addr, way, mask, flag = cols
    now = torch.tensor(9, dtype=torch.int32)
    hit, pway, dh = port.probe(big, a, s, addr)
    st_b, ev_b = port.fill(port.touch(big, a, s, way, now, mask,
                                      set_dirty=flag),
                           a, s, way, addr, now, mask, dirty=flag)
    for p, st in enumerate(states):
        one = convert.tag_state(st, device="cpu")
        r = [x[p:p + 1] for x in cols]
        h1, w1, d1 = port.probe(one, r[0], r[1], r[2])
        assert torch.equal(h1[0], hit[p]) and torch.equal(w1[0], pway[p])
        assert torch.equal(d1[0], dh[p])
        st1, ev1 = port.fill(port.touch(one, r[0], r[1], r[3], now, r[4],
                                        set_dirty=r[5]),
                             r[0], r[1], r[3], r[2], now, r[4], dirty=r[5])
        assert torch.equal(ev1[0], ev_b[p])
        for k in st1:
            assert torch.equal(st1[k][0], st_b[k][p]), k


def test_init_tag_state_matches_reference_layout():
    want = ref.init_tag_state(4, 2, 8)
    got = port.init_tag_state(4, 2, 8, batch=2, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == (2,) + tuple(v.shape), k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
        np.testing.assert_array_equal(got[k][1].numpy(), np.asarray(v))
