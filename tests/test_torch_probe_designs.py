"""CPU emulation of how the Hopper probe kernels split their work.

The CUDA kernels run only on the card, so their decomposition is
emulated here in numpy, step for step, and held against the plain
PyTorch versions, the reference oracles and (for ``ata_probe_rank``)
the reference Pallas kernel in interpret mode:

* ``csrc/ata_probe_rank.cu``: a cluster of K CTAs per point, CTA k on
  the k-th contiguous chunk of requests; a warp probes a request's own
  row and every peer row (lane i of a group of W / 8 lanes on ways 8i ..
  8i + 7 of one row for W a multiple of 8, else lane l on ways l,
  l + 32, ...), each lane folding what it read into its first matches,
  and min-reductions over the lanes give the first way and the
  lowest-id hitting peer; one warp per CTA ranks its chunk 32 requests
  at a time (match-any groups plus per-port counts carried in shared
  memory); a request then adds the earlier CTAs' counts at its port, and
  ``psize`` sums all K.
* ``csrc/ata_tag_probe.cu``: a group of g lanes per (request, cache)
  pair (g the power of two >= W, at most 32), ways j + g * k, a ballot
  per slice and the group's lowest set bit; ``tags`` read through its
  element strides, as the serving engine passes the tag lane of its
  packed directory.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ata_probe_rank as kmod  # noqa: E402
from repro_torch.kernels import ata_tag_probe as tmod  # noqa: E402
from repro_torch.serving.engine import _probe_all  # noqa: E402

NAMES = ("local_hit", "hit_way", "remote_ok", "src_cache", "prank", "psize")
C, S, W, G = 30, 8, 64, 10        # the paper geometry


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lowbit(b):
    """Index of the lowest set bit of each nonzero entry (``__ffs`` - 1)."""
    b = np.asarray(b, np.int64)
    return np.log2(b & -b).astype(np.int64)


# ---------------------------------------------------------------------------
# ata_probe_rank
# ---------------------------------------------------------------------------
NONE = 2**32 - 1                  # the kernel's kNone


def _lane_of(Wn, n_rows):
    """(n_rows, W) lane that reads each (row, way) of a request. W a
    multiple of 8 up to 256: lane i of each group of 2^lg lanes (8 << lg
    >= W) reads ways 8i .. 8i + 7, group g rows g, g + 32 >> lg, ...
    Otherwise lane l reads ways l, l + 32, ... of every row."""
    j = np.arange(n_rows)[:, None]
    w = np.arange(Wn)[None, :]
    if Wn % 8 == 0 and Wn <= 256:
        lg = 0
        while (8 << lg) < Wn:
            lg += 1
        return (j % (32 >> lg)) << lg | w // 8
    return np.broadcast_to(w % 32, (n_rows, Wn))


def _probe_request(tags, valid, dirty, s, tag, self, cb, G):
    """One warp's probe of one request: every lane folds what it reads of
    the own row and of each peer row (in id order) into its first
    matching own way, its first matching peer row and that row's dirty
    bit; the warp then takes the least way, the least row, and any
    lane's dirty bit at that row."""
    Cn, _, Wn = tags.shape
    c0, c1 = max(cb, 0), min(cb + G, Cn)
    self_in = c0 <= self < c1
    n_rows = 1 + max(c1 - c0, 0) - int(self_in)
    rows = [self] + [c for c in range(c0, c1) if c != self]
    m = (tags[rows, s] == tag) & valid[rows, s]        # (n_rows, W)
    d = m & dirty[rows, s]
    lane = _lane_of(Wn, n_rows)
    jj, ww = np.nonzero(m)
    lway = np.full(32, NONE, np.int64)
    own = jj == 0
    np.minimum.at(lway, lane[jj[own], ww[own]], ww[own])
    lrow = np.full(32, NONE, np.int64)
    np.minimum.at(lrow, lane[jj[~own], ww[~own]], jj[~own])
    ldirty = np.zeros(32, bool)
    at = ~own & (jj == lrow[lane[jj, ww]]) & d[jj, ww]
    ldirty[lane[jj[at], ww[at]]] = True
    way, row = lway.min(), lrow.min()              # __reduce_min_sync
    dirt = bool(((lrow == row) & ldirty).any())    # __any_sync
    if row == NONE:
        return way != NONE, 0 if way == NONE else int(way), False, cb, False
    return (way != NONE, 0 if way == NONE else int(way), True, rows[row],
            dirt)


def emulate_probe_rank(args, G, K):
    """The kernel's decomposition over P points, K CTAs per point."""
    set_idx, qtag, core, cbase, deny, tags, valid, dirty = args
    P, R = set_idx.shape
    Cn = tags.shape[1]
    lh = np.zeros((P, R), bool)
    rok = np.zeros((P, R), bool)
    hw, src, prank, psize = (np.zeros((P, R), np.int32) for _ in range(4))
    chunk = -(-R // K)
    for p in range(P):
        counts = np.zeros((K, Cn), np.int64)      # each CTA's shared counts
        spans = [(min(k * chunk, R), min(min(k * chunk, R) + chunk, R))
                 for k in range(K)]
        for k, (lo, hi) in enumerate(spans):
            for q in range(lo, hi):               # 1. probe
                own, way, anyr, sc, sd = _probe_request(
                    tags[p], valid[p], dirty[p], set_idx[p, q], qtag[p, q],
                    core[p, q], cbase[p, q], G)
                lh[p, q], hw[p, q], src[p, q] = own, way, sc
                rok[p, q] = not deny[p, q] and not own and anyr and not sd
            for b in range(lo, hi, 32):           # 2. one warp ranks
                r = np.arange(b, b + 32)
                live = r < hi
                rr = np.minimum(r, R - 1)
                key = np.where(live & rok[p, rr], src[p, rr], -1)
                before = np.where(key >= 0, counts[k, np.maximum(key, 0)], 0)
                for lane in range(32):
                    peers = key == key[lane]       # __match_any_sync
                    if key[lane] >= 0 and not peers[lane + 1:].any():
                        counts[k, key[lane]] = before[lane] + peers.sum()
                    if live[lane]:
                        prank[p, r[lane]] = (before[lane] + peers[:lane].sum()
                                             if key[lane] >= 0 else 0)
        for k, (lo, hi) in enumerate(spans):      # 3. carry across CTAs
            for q in range(lo, hi):
                if rok[p, q]:
                    prank[p, q] += counts[:k, src[p, q]].sum()
                    psize[p, q] = counts[:, src[p, q]].sum()
    return lh, hw, rok, src, prank, psize


def _inputs(P, R, seed, one_port=False):
    """Paper-geometry inputs (numpy) with a leading point axis. With
    ``one_port``, every request misses its own row and hits one clean
    copy in cache 2, so all R queue at one port in arrival order."""
    rng = np.random.default_rng(seed)
    tags = rng.integers(0, 48, (P, C, S, W)).astype(np.int32)
    valid = rng.random((P, C, S, W)) < 0.7
    dirty = valid & (rng.random((P, C, S, W)) < 0.2)
    qtag = rng.integers(0, 48, (P, R)).astype(np.int32)
    set_idx = rng.integers(0, S, (P, R)).astype(np.int32)
    core = rng.integers(0, C, (P, R)).astype(np.int32)
    deny = rng.random((P, R)) < 0.2
    if one_port:
        tags[:, :G] = 0
        qtag[:] = 7
        tags[:, 2, :, 45] = 7
        valid[:, 2, :, 45] = True
        dirty[:, 2] = False
        core = rng.integers(0, G, (P, R)).astype(np.int32)
        core[core == 2] = 3
        deny[:] = False
    cbase = ((core // G) * G).astype(np.int32)
    return [set_idx, qtag, core, cbase, deny, tags, valid, dirty]


@functools.lru_cache(maxsize=None)
def _case(R, one_port):
    """(inputs, plain, oracle, Pallas interpret) for one point."""
    args = _inputs(1, R, seed=R + 1000 * one_port, one_port=one_port)
    plain = [x.numpy() for x in kmod.ata_probe_rank(
        *(torch.from_numpy(a) for a in args), cluster_size=G)]
    jargs = [jnp.asarray(a[0]) for a in args]
    oracle = ref.ata_probe_rank_ref(*jargs, cluster_size=G)
    pallas = ops.ata_probe_rank(*jargs, cluster_size=G, impl="interpret",
                                br=128)
    return args, plain, oracle, pallas


def _assert_equal(got, want, where):
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"{where}: {name}")


RS = (1, 31, 33, 120, 1500)


@pytest.mark.parametrize("one_port", [False, True])
@pytest.mark.parametrize("R", RS)
def test_probe_rank_decomposition_matches_plain_ref_and_pallas(R, one_port):
    """Every chunking the wrapper can pick for this R (points 7, 46 and
    200), and 3 CTAs, whose boundaries split a port's queue."""
    args, plain, oracle, pallas = _case(R, one_port)
    _assert_equal(plain[:], [np.asarray(x)[None] for x in oracle], "plain")
    _assert_equal(plain, [np.asarray(x)[None] for x in pallas], "pallas")
    if one_port:
        assert plain[2].all() and (plain[3] == 2).all()
        np.testing.assert_array_equal(plain[4][0], np.arange(R))
        assert (plain[5] == R).all()
    elif R >= 33:
        assert plain[0].any() and plain[2].any()
    ks = {1, 3} | {kmod.cluster_blocks(P, R) for P in (7, 46, 200)}
    for K in sorted(ks):
        _assert_equal(emulate_probe_rank(args, G, K), plain, f"K={K}")


@pytest.mark.parametrize("K", [1, 2, 5, 8])
def test_probe_rank_decomposition_over_points(K):
    """A leading point axis: each point's cluster ranks only its own
    requests."""
    args = _inputs(3, 70, seed=K)
    plain = [x.numpy() for x in kmod.ata_probe_rank(
        *(torch.from_numpy(a) for a in args), cluster_size=G)]
    assert plain[2].any()
    _assert_equal(emulate_probe_rank(args, G, K), plain, f"K={K}")


@pytest.mark.parametrize("Wn", [6, 8, 63, 64, 96])
def test_first_way_across_lanes_and_slices(Wn):
    """The first valid match wins, across the 8 ways of a lane and the
    lanes of a row (W a multiple of 8) or across 32-way slices (6, 63);
    matching tags in invalid ways and a dirty later way do not move
    it."""
    Cn, Sn, Gn = 4, 2, 4
    tags = np.zeros((1, Cn, Sn, Wn), np.int32)
    valid = np.zeros_like(tags, bool)
    dirty = np.zeros_like(valid)
    late = Wn - 1
    tags[0, 1, 1, [0, late // 2 + 1, late]] = 5      # way 0 invalid
    valid[0, 1, 1, [late // 2 + 1, late]] = True
    dirty[0, 1, 1, late] = True                      # a dirty copy
    tags[0, 3, 1, late] = 5
    valid[0, 3, 1, late] = True
    args = [np.array([[1, 1]], np.int32), np.array([[5, 5]], np.int32),
            np.array([[1, 0]], np.int32), np.zeros((1, 2), np.int32),
            np.zeros((1, 2), bool), tags, valid, dirty]
    plain = [x.numpy() for x in kmod.ata_probe_rank(
        *(torch.from_numpy(a) for a in args), cluster_size=Gn)]
    assert plain[0].tolist() == [[True, False]]
    assert plain[1][0, 0] == late // 2 + 1
    assert plain[3].tolist() == [[3, 1]]         # lowest peer id, own skip
    assert plain[2].tolist() == [[False, False]]  # request 1: dirty source
    _assert_equal(emulate_probe_rank(args, Gn, 1), plain, "K=1")


def test_cluster_blocks_fill_the_card_within_a_portable_cluster():
    assert kmod.cluster_blocks(46, 120) == 5      # 230 CTAs for 132 SMs
    assert kmod.cluster_blocks(7, 60) == 8
    assert kmod.cluster_blocks(200, 4096) == 1
    assert kmod.cluster_blocks(1, 1) == kmod.cluster_blocks(5000, 10**6) == 1
    for P in (1, 7, 46, 53, 133, 200):
        for R in (1, 9, 60, 120, 1500):
            K = kmod.cluster_blocks(P, R)
            assert 1 <= K <= 8 and K <= -(-R // 8)
            assert K == 1 or P * K <= 2 * 132


# ---------------------------------------------------------------------------
# ata_tag_probe
# ---------------------------------------------------------------------------
def _directory(Cn, Sn, Wn, seed):
    """The serving engine's packed directory (C * S + 1, W, 2) int32:
    [tag, LRU key] lanes, a scratch row last, empty ways tag 0."""
    rng = np.random.default_rng(seed)
    d = np.zeros((Cn * Sn + 1, Wn, 2), np.int32)
    d[..., 0] = rng.integers(1, 3 * Wn + 2, (Cn * Sn + 1, Wn))
    d[..., 0][rng.random((Cn * Sn + 1, Wn)) < 0.3] = 0
    d[..., 1] = rng.integers(Wn, 50 * Wn, (Cn * Sn + 1, Wn))
    return torch.from_numpy(d)


def emulate_tag_probe(set_idx, qtag, tags, valid):
    """The kernel's lane groups over the flat storage of a strided
    ``tags``; a set outside [0, S) reports a miss."""
    Cn, Sn, Wn = tags.shape
    flat = tags.as_strided((tags.untyped_storage().nbytes() // 4,), (1,),
                           0).numpy()
    off0 = tags.storage_offset()
    sc, ss, sw = tags.stride()
    vflat = valid.contiguous().reshape(-1).numpy()
    set_idx, qtag = set_idx.numpy(), qtag.numpy()
    lg = 0
    while (1 << lg) < Wn and lg < 5:
        lg += 1
    g = 1 << lg
    R = set_idx.shape[0]
    r = np.repeat(np.arange(R), Cn)                  # pair i = r * C + c
    c = np.tile(np.arange(Cn), R)
    s = set_idx[r]
    in_set = (s >= 0) & (s < Sn)
    s = np.where(in_set, s, 0)
    way = np.full(R * Cn, -1)
    for k in range(-(-Wn // g)):                     # slices
        ballot = np.zeros(R * Cn, np.int64)
        for j in range(g):                           # lanes of the group
            w = j + g * k
            if w >= Wn:
                continue
            t = flat[off0 + c * sc + s * ss + w * sw]
            v = vflat[(c * Sn + s) * Wn + w]
            ballot |= (in_set & v & (t == qtag[r])).astype(np.int64) << j
        way = np.where((way < 0) & (ballot != 0),
                       g * k + _lowbit(np.where(ballot, ballot, 1)), way)
    return (way >= 0).reshape(R, Cn), np.maximum(way, 0).astype(
        np.int32).reshape(R, Cn)


@pytest.mark.parametrize("Wn", [1, 6, 8, 64])
def test_strided_directory_lane_matches_contiguous_copy(Wn):
    Cn, Sn, R = 8, 16, 45
    d = _directory(Cn, Sn, Wn, seed=Wn)
    view = d[:Cn * Sn, :, 0].view(Cn, Sn, Wn)
    assert not view.is_contiguous() and view.stride() == (Sn * Wn * 2,
                                                          Wn * 2, 2)
    valid = view != 0
    assert valid.is_contiguous()      # what the wrapper requires of valid
    rng = np.random.default_rng(Wn + 1)
    set_idx = torch.from_numpy(rng.integers(0, Sn, R).astype(np.int32))
    qtag = view[torch.arange(R) % Cn, set_idx.long(),
                torch.from_numpy(rng.integers(0, Wn, R))].clone()
    qtag[::4] = torch.from_numpy(
        rng.integers(0, 3 * Wn + 2, len(qtag[::4])).astype(np.int32))
    qtag[::9] = 0
    copy = view.contiguous()
    want = tmod.ata_tag_probe_plain(set_idx, qtag, copy, copy != 0)
    assert want[0].any() and not want[0].all()
    got = tmod.ata_tag_probe(set_idx, qtag, view, valid)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    jw = ref.ata_tag_probe_ref(jnp.asarray(set_idx.numpy()),
                               jnp.asarray(qtag.numpy()),
                               jnp.asarray(copy.numpy()),
                               jnp.asarray(valid.numpy()))
    emu = emulate_tag_probe(set_idx, qtag, view, valid)
    for e, g, j in zip(emu, want, jw):
        np.testing.assert_array_equal(e, g.numpy())
        np.testing.assert_array_equal(e, np.asarray(j))
    # a set outside [0, S) reads nothing and misses in every cache
    bad = set_idx.clone()
    bad[[0, 7]] = torch.tensor([-1, Sn], dtype=torch.int32)
    hits, ways = emulate_tag_probe(bad, qtag, view, valid)
    assert not hits[[0, 7]].any() and not ways[[0, 7]].any()
    np.testing.assert_array_equal(hits[1:7], want[0].numpy()[1:7])


def test_engine_probes_the_directory_lane_in_place():
    """``_probe_all`` hands the strided lane to the kernel's wrapper as
    it stands, and agrees with the plain ``torch`` backend."""
    Cn, Sn, Wn, K = 4, 64, 8, 5
    d = _directory(Cn, Sn, Wn, seed=3)
    view = d[:Cn * Sn, :, 0].view(Cn, Sn, Wn)
    rng = np.random.default_rng(4)
    h = view[rng.integers(0, Cn, (Cn, K)), rng.integers(0, Sn, (Cn, K)),
             rng.integers(0, Wn, (Cn, K))].clone()
    h[:, -1] = 0                                   # invalid block lanes
    sets = (h % Sn).to(torch.int32)
    got = _probe_all(view, h, sets, backend="cuda")
    want = _probe_all(view, h, sets, backend="torch")
    assert got.shape == (Cn, K, Cn) and got.any()
    assert torch.equal(got, want)


def test_wrapper_check_takes_strided_tags_only():
    view = _directory(2, 4, 8, seed=0)[:8, :, 0].view(2, 4, 8)
    set_idx = torch.zeros(6, dtype=torch.int32)
    qtag = torch.ones(6, dtype=torch.int32)
    tmod._check(set_idx, qtag, view, view != 0)
    with pytest.raises(ValueError, match="only tags may be a strided"):
        tmod._check(set_idx, qtag, view, (view != 0).transpose(1, 2)
                    .contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="only tags may be a strided"):
        tmod._check(torch.zeros(12, dtype=torch.int32)[::2], qtag, view,
                    view != 0)
