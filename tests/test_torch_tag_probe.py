"""Port parity: the ``ata_tag_probe`` kernel module.

On the CPU the wrapper takes the plain PyTorch version, which is held
bit for bit against the reference oracle ``ref.ata_tag_probe_ref`` and
the reference Pallas kernel in interpret mode, at the serving engine's
shapes ((C, K) in {8, 16} x {14, 18} with R = C * K block lanes, 64
sets of 8 ways), at odd R, at one cache, and at the paper geometry (30
caches of 8 sets x 64 ways). The inputs plant duplicate tags across
ways, matching tags in invalid ways, and qtag 0. The CUDA kernel itself
runs only on the card: ``tests/test_torch_kernels_gpu.py`` and
``chip_smoke.py`` hold it against the plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref  # noqa: E402
from repro.kernels.ata_tag_probe import ata_tag_probe as pallas_probe  # noqa: E402,E501
from repro_torch.kernels import ata_tag_probe as kmod  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: (R, C, S, W): the four serving shapes, odd R, one cache, paper geometry
SHAPES = [
    (8 * 14, 8, 64, 8), (8 * 18, 8, 64, 8),
    (16 * 14, 16, 64, 8), (16 * 18, 16, 64, 8),
    (1, 8, 64, 8), (37, 8, 64, 8),
    (18, 1, 64, 8),
    (120, 30, 8, 64),
]


def _inputs(R, C, S, W, seed):
    """Tags from a small range (duplicates across ways and caches), some
    valid ways and some not, a few zero tags, and queries that include 0
    and tags present only in invalid ways."""
    rng = np.random.default_rng(seed)
    hi = 3 * W
    tags = rng.integers(1, hi, (C, S, W)).astype(np.int32)
    tags[rng.random((C, S, W)) < 0.05] = 0
    valid = rng.random((C, S, W)) < 0.7
    set_idx = rng.integers(0, S, R).astype(np.int32)
    qtag = rng.integers(0, hi, R).astype(np.int32)
    qtag[::5] = 0
    return set_idx, qtag, tags, valid


def _plain(args):
    return [x.numpy() for x in kmod.ata_tag_probe(
        *(torch.from_numpy(a) for a in args))]


@pytest.mark.parametrize("R,C,S,W", SHAPES)
def test_plain_matches_oracle_and_pallas_interpret(R, C, S, W):
    args = _inputs(R, C, S, W, seed=R * 31 + C)
    hits, ways = _plain(args)
    assert hits.dtype == np.bool_ and ways.dtype == np.int32
    assert hits.shape == ways.shape == (R, C)
    jargs = [jnp.asarray(a) for a in args]
    for want in (ref.ata_tag_probe_ref(*jargs),
                 pallas_probe(*jargs, br=R, bc=8 if C % 8 == 0 else C,
                              interpret=True)):
        np.testing.assert_array_equal(hits, np.asarray(want[0]))
        np.testing.assert_array_equal(ways, np.asarray(want[1]))
    if R >= 37:
        assert hits.any() and not hits.all()


def test_planted_cases():
    """First matching way wins; invalid ways never match; 0 where none."""
    C, S, W = 2, 4, 8
    tags = np.zeros((C, S, W), np.int32)
    valid = np.zeros((C, S, W), bool)
    tags[0, 1, [2, 5]] = 7            # duplicate tag in two valid ways
    valid[0, 1, [2, 5]] = True
    tags[1, 1, 3] = 7                 # matching tag in an invalid way
    tags[1, 1, 6] = 7
    valid[1, 1, 6] = True
    valid[1, 2, 4] = True             # a valid way holding tag 0
    set_idx = np.array([1, 1, 2, 3], np.int32)
    qtag = np.array([7, 9, 0, 0], np.int32)
    hits, ways = _plain((set_idx, qtag, tags, valid))
    np.testing.assert_array_equal(
        hits, [[True, True], [False, False], [False, True], [False, False]])
    np.testing.assert_array_equal(ways, [[2, 6], [0, 0], [0, 4], [0, 0]])


def test_cpu_wrapper_counts_no_launch():
    before = kmod.launches
    _plain(_inputs(37, 8, 64, 8, seed=0))
    assert kmod.launches == before
