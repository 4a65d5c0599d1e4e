"""The CUDA ``ata_probe_rank`` kernel against its plain PyTorch version,
on the card (``gpu`` marker; each test skips where there is no card).

This file imports no JAX, so it runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ata_probe_rank as kmod  # noqa: E402

NAMES = ("local_hit", "hit_way", "remote_ok", "src_cache", "prank", "psize")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(P, R, device, seed, C=30, S=8, W=64, G=10):
    rng = np.random.default_rng(seed)
    tags = rng.integers(0, 48, (P, C, S, W)).astype(np.int32)
    valid = rng.random((P, C, S, W)) < 0.7
    dirty = valid & (rng.random((P, C, S, W)) < 0.2)
    qtag = rng.integers(0, 48, (P, R)).astype(np.int32)
    set_idx = rng.integers(0, S, (P, R)).astype(np.int32)
    core = rng.integers(0, C, (P, R)).astype(np.int32)
    cbase = ((core // G) * G).astype(np.int32)
    deny = rng.random((P, R)) < 0.2
    return [torch.from_numpy(a).to(device)
            for a in (set_idx, qtag, core, cbase, deny, tags, valid, dirty)]


@pytest.mark.gpu
@pytest.mark.parametrize("P,R", [(1, 60), (53, 120), (3, 150), (2, 1500),
                                 (4, 31)])
def test_cuda_kernel_matches_plain(cuda_device, P, R):
    args = _inputs(P, R, cuda_device, seed=R)
    before = kmod.launches
    got = kmod.ata_probe_rank(*args, cluster_size=10)
    torch.cuda.synchronize()
    assert kmod.launches == before + 1
    want = kmod.ata_probe_rank_plain(*args, cluster_size=10)
    assert want[0].any() and want[2].any()
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.gpu
def test_cuda_wrapper_checks_inputs(cuda_device):
    args = _inputs(2, 60, cuda_device, seed=0)
    bad = list(args)
    bad[1] = bad[1].to(torch.int64)
    with pytest.raises(ValueError, match="qtag must be torch.int32"):
        kmod.ata_probe_rank(*bad, cluster_size=10)
    bad = list(args)
    bad[0] = args[0].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        kmod.ata_probe_rank(*bad, cluster_size=10)
    bad = list(args)
    bad[6] = args[6].cpu()
    with pytest.raises(ValueError, match="valid is on cpu"):
        kmod.ata_probe_rank(*bad, cluster_size=10)
