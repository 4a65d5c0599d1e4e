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


# ---------------------------------------------------------------------------
# the in-place write path: the winner over a point's own requests, and
# writes that land in the tensors they are given
# ---------------------------------------------------------------------------
def _winner_oracle(idx, mask, numel):
    """Last masked-in lane per target by an ``amax`` scatter of lane
    numbers into a buffer the size of the field."""
    lane = torch.arange(idx.numel()).view_as(idx)
    win = torch.full((numel,), -1, dtype=torch.long)
    win.scatter_reduce_(0, idx.reshape(-1),
                        torch.where(mask, lane, -1).reshape(-1), "amax")
    return win[idx]


@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_winner_matches_a_field_sized_oracle(seed, P):
    rng = np.random.default_rng(seed)
    R, E = 40, 8                       # 40 requests over 8 elements a point
    local = rng.integers(0, E, (P, R))
    mask = rng.random((P, R)) < 0.5
    # a masked-in lane before a masked-out duplicate, alone on their
    # element: lane 2 wins for both
    local[local == E - 1] = 0
    local[:, 2] = local[:, 5] = E - 1
    mask[:, 2], mask[:, 5] = True, False
    if P > 1:
        mask[1] = False                # a point with every lane masked out
    idx = torch.from_numpy(np.arange(P)[:, None] * E + local)
    mask = torch.from_numpy(mask)
    got = port._winner(idx, mask)
    assert torch.equal(got, _winner_oracle(idx, mask, P * E))
    base = torch.arange(P) * R
    assert torch.equal(got[0, [2, 5]], base[0] + torch.tensor([2, 2]))
    if P > 1:
        assert bool((got[1] == -1).all())
    # dense duplicates: some target is hit by several masked-in lanes
    assert (got >= 0).sum() > len(set(got[got >= 0].tolist()))


def _victim_state(rng, A=6, V=4):
    """``_state`` with a populated victim buffer of V entries per array."""
    st = _state(rng, A=A)
    st.update(vtags=rng.integers(0, 24, (A, V)).astype(np.int32),
              vvalid=rng.random((A, V)) < 0.6,
              vborn=np.stack([rng.permutation(40)[:V]
                              for _ in range(A)]).astype(np.int32))
    return st


def _ref_call(op, st, a, s, addr, way, mask, flag, now):
    j = {k: jnp.asarray(v) for k, v in st.items()}
    a, s, addr, way, mask, flag = map(jnp.asarray,
                                      (a, s, addr, way, mask, flag))
    now = jnp.int32(now)
    if op == "touch":
        return ref.touch(j, a, s, way, now, mask, set_dirty=flag)
    if op == "fill":
        return ref.fill(j, a, s, way, addr, now, mask, dirty=flag)[0]
    if op == "victim_insert":
        return ref.victim_insert(j, a, addr, now, mask)
    return ref.victim_invalidate(j, a, way % st["vtags"].shape[-1], mask)


def _port_call(op, st, a, s, addr, way, mask, flag, now):
    a, s, addr, way, mask, flag = map(_t, (a, s, addr, way, mask, flag))
    now = torch.tensor(now, dtype=torch.int32)
    if op == "touch":
        return port.touch(st, a, s, way, now, mask, set_dirty=flag)
    if op == "fill":
        return port.fill(st, a, s, way, addr, now, mask, dirty=flag)[0]
    if op == "victim_insert":
        return port.victim_insert(st, a, addr, now, mask)
    return port.victim_invalidate(st, a, way % st["vtags"].shape[-1], mask)


@pytest.mark.parametrize("op", ["touch", "fill", "victim_insert",
                                "victim_invalidate"])
@pytest.mark.parametrize("seed", [0, 1])
def test_writes_land_in_the_given_tensors(seed, op):
    rng = np.random.default_rng(seed)
    st = _victim_state(rng)
    reqs = _requests(rng, st)
    want = _ref_call(op, st, *reqs, now=63)
    state = convert.tag_state(st, device="cpu")
    given = dict(state)
    ptrs = {k: v.data_ptr() for k, v in state.items()}
    got = _port_call(op, state, *reqs, now=63)
    for k in state:
        assert got[k] is given[k] and got[k].data_ptr() == ptrs[k], k
    _assert_state_equal(got, want)
    written = {"touch": ("last", "dirty"), "fill": ("tags", "last"),
               "victim_insert": ("vtags",),
               "victim_invalidate": ("vvalid",)}[op]
    assert any(not np.array_equal(np.asarray(want[k]), st[k])
               for k in written)


@pytest.mark.parametrize("op,key", [("touch", "last"), ("touch", "dirty"),
                                    ("fill", "tags"), ("fill", "valid"),
                                    ("fill", "last"), ("fill", "born"),
                                    ("fill", "dirty"),
                                    ("victim_insert", "vtags"),
                                    ("victim_invalidate", "vvalid")])
def test_a_field_that_is_not_contiguous_raises(op, key):
    rng = np.random.default_rng(4)
    st = _victim_state(rng)
    reqs = _requests(rng, st)
    state = convert.tag_state(st, device="cpu")
    # the same values, laid out with the last two axes swapped
    state[key] = state[key].transpose(-1, -2).contiguous().transpose(-1, -2)
    assert not state[key].is_contiguous()
    with pytest.raises(RuntimeError, match="view size"):
        _port_call(op, state, *reqs, now=63)
