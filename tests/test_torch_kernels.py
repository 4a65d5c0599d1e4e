"""Port parity: the ``ata_probe_rank`` kernel module.

On the CPU the wrapper takes the plain PyTorch version, which is held
bit-for-bit against the reference oracle ``ref.ata_probe_rank_ref`` and
the reference Pallas kernel in interpret mode, over the shape sweep of
``tests/test_kernels.py``. The CUDA kernel itself runs only on the card:
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py`` hold it
against the plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ata_probe_rank as kmod  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NAMES = ("local_hit", "hit_way", "remote_ok", "src_cache", "prank", "psize")

#: the sweep of tests/test_kernels.py::test_ata_probe_rank_sweep
SWEEP = [
    (128, 8, 8, 64, 4, 64, 0),
    (256, 12, 8, 16, 4, 128, 0),
    (64, 4, 16, 8, 2, 64, 0),
    (60, 6, 4, 8, 3, 16, 1),      # R % br != 0
    (150, 30, 8, 64, 10, 128, 0),  # paper geometry at m=5, ragged tile
]


def _inputs(R, C, S, W, G, seed=0, tag_hi=48, P=None):
    """numpy inputs; with P, a leading point axis."""
    rng = np.random.default_rng(seed)
    lead = () if P is None else (P,)
    tags = rng.integers(0, tag_hi, lead + (C, S, W)).astype(np.int32)
    valid = rng.random(lead + (C, S, W)) < 0.7
    dirty = valid & (rng.random(lead + (C, S, W)) < 0.2)
    qtag = rng.integers(0, tag_hi, lead + (R,)).astype(np.int32)
    set_idx = rng.integers(0, S, lead + (R,)).astype(np.int32)
    core = rng.integers(0, C, lead + (R,)).astype(np.int32)
    cbase = ((core // G) * G).astype(np.int32)
    deny = rng.random(lead + (R,)) < 0.2
    return set_idx, qtag, core, cbase, deny, tags, valid, dirty


def _plain(args, G):
    t = [torch.from_numpy(np.asarray(a))[None] for a in args]
    return [x[0].numpy() for x in kmod.ata_probe_rank(*t, cluster_size=G)]


def _assert_all_equal(got, want):
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize("R,C,S,W,G,br,seed", SWEEP)
def test_plain_matches_reference_oracle_and_interpret_kernel(
        R, C, S, W, G, br, seed):
    args = _inputs(R, C, S, W, G, seed)
    jargs = [jnp.asarray(a) for a in args]
    oracle = ref.ata_probe_rank_ref(*jargs, cluster_size=G)
    pallas = ops.ata_probe_rank(*jargs, cluster_size=G, impl="interpret",
                                br=br)
    before = kmod.launches
    got = _plain(args, G)
    assert kmod.launches == before       # CPU tensors: plain, no launch
    assert got[0].any() and got[2].any()
    _assert_all_equal(got, oracle)
    _assert_all_equal(got, pallas)
    assert got[0].dtype == np.bool_ and got[1].dtype == np.int32


def test_plain_batched_equals_per_point():
    P, (R, C, S, W, G) = 4, (150, 30, 8, 64, 10)
    args = _inputs(R, C, S, W, G, seed=3, P=P)
    got = kmod.ata_probe_rank_plain(*(torch.from_numpy(a) for a in args),
                                    cluster_size=G)
    for p in range(P):
        _assert_all_equal([g[p].numpy() for g in got],
                          _plain([a[p] for a in args], G))


def test_planted_arbitration():
    """Three requests hitting one peer queue 0,1,2 in request order with
    group size 3; a denied fourth stays out of the group."""
    C, S, W, G, R = 4, 4, 4, 4, 8
    tags = np.zeros((C, S, W), np.int32)
    valid = np.zeros((C, S, W), bool)
    tags[2, 1, 3], valid[2, 1, 3] = 7, True
    set_idx = np.full(R, 1, np.int32)
    qtag = np.where(np.arange(R) < 4, 7, 9).astype(np.int32)
    core = np.array([0, 1, 3, 0, 1, 2, 3, 0], np.int32)
    deny = np.array([0, 0, 0, 1, 0, 0, 0, 0], bool)
    out = _plain((set_idx, qtag, core, np.zeros(R, np.int32), deny, tags,
                  valid, np.zeros_like(valid)), G)
    local, way, rok, src, rank, size = out
    assert not local.any() and not way.any()
    assert rok.tolist() == [True, True, True] + [False] * 5
    assert src.tolist() == [2, 2, 2, 2, 0, 0, 0, 0]
    assert rank.tolist() == [0, 1, 2, 0, 0, 0, 0, 0]
    assert size.tolist() == [3, 3, 3, 0, 0, 0, 0, 0]


def test_wrapper_rejects_other_devices():
    args = [torch.from_numpy(np.asarray(a))[None]
            for a in _inputs(8, 4, 2, 4, 2)]
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="cuda or cpu"):
        kmod.ata_probe_rank(*meta, cluster_size=2)
