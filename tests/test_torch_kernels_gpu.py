"""The CUDA kernels against their plain PyTorch versions, and the serving
engine against its numpy oracle, on the card (``gpu`` marker; each test
skips where there is no card).

This file imports no JAX, so it runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ata_probe_rank as kmod  # noqa: E402
from repro_torch.kernels import ata_tag_probe as tmod  # noqa: E402

NAMES = ("local_hit", "hit_way", "remote_ok", "src_cache", "prank", "psize")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(P, R, device, seed, C=30, S=8, W=64, G=10, one_port=False):
    """Random inputs; with ``one_port`` every request misses its own row
    and hits one clean copy in cache 2, so all R of a point queue at one
    port in arrival order."""
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
        tags[:, 2, :, W - 3] = 7
        valid[:, 2, :, W - 3] = True
        dirty[:, 2] = False
        core = rng.integers(0, G, (P, R)).astype(np.int32)
        core[core == 2] = 3
        deny[:] = False
    cbase = ((core // G) * G).astype(np.int32)
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
@pytest.mark.parametrize("P,R,C,S,W,one_port", [
    (200, 1, 30, 8, 64, False), (200, 33, 30, 8, 64, False),
    (200, 4096, 30, 8, 64, False), (200, 4096, 30, 8, 64, True),
    (2, 4096, 8192, 2, 8, False), (3, 1500, 8192, 2, 8, True),
    (5, 77, 30, 8, 63, False)])
def test_cuda_kernel_matches_plain_at_scale(cuda_device, P, R, C, S, W,
                                            one_port):
    """More points than SMs, R = 1 to 4096, C up to the 8192-cache limit
    (clusters clipped at the last cache), every request of a point at one
    port (ranks 0 .. R - 1 across the cluster's CTAs), and W = 63 (the
    kernel's path for W not a multiple of 8)."""
    args = _inputs(P, R, cuda_device, seed=R + C, C=C, S=S, W=W,
                   one_port=one_port)
    before = kmod.launches
    got = kmod.ata_probe_rank(*args, cluster_size=10)
    torch.cuda.synchronize()
    assert kmod.launches == before + 1
    want = kmod.ata_probe_rank_plain(*args, cluster_size=10)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    if one_port:
        assert bool(want[2].all())
        ranks = torch.arange(R, dtype=torch.int32, device=cuda_device)
        assert torch.equal(got[4], ranks.expand(P, R))
        assert bool((got[5] == R).all())
    elif R > 1:
        assert want[0].any() and want[2].any()


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
    # ata_tag_probe reads tags at any strides; the rest stay contiguous
    t = _tag_inputs(37, 8, 64, 8, cuda_device, seed=0)
    strided = torch.stack((t[2], t[2] + 1), dim=-1)[..., 0]
    assert not strided.is_contiguous()
    for g, w in zip(tmod.ata_tag_probe(t[0], t[1], strided, t[3]),
                    tmod.ata_tag_probe(*t)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="only tags may be a strided view"):
        tmod.ata_tag_probe(t[0], t[1], t[2],
                           t[3].transpose(1, 2).contiguous().transpose(1, 2))


def _tag_inputs(R, C, S, W, device, seed):
    """Tags from a small range (duplicates across ways), invalid ways
    holding matching tags, zero tags and qtag 0."""
    rng = np.random.default_rng(seed)
    tags = rng.integers(1, 3 * W, (C, S, W)).astype(np.int32)
    tags[rng.random((C, S, W)) < 0.05] = 0
    valid = rng.random((C, S, W)) < 0.7
    set_idx = rng.integers(0, S, R).astype(np.int32)
    qtag = rng.integers(0, 3 * W, R).astype(np.int32)
    qtag[::5] = 0
    return [torch.from_numpy(a).to(device)
            for a in (set_idx, qtag, tags, valid)]


@pytest.mark.gpu
@pytest.mark.parametrize("R,C,S,W", [(288, 16, 64, 8), (112, 8, 64, 8),
                                     (37, 8, 64, 8), (1, 1, 64, 8),
                                     (120, 30, 8, 64)])
def test_tag_probe_kernel_matches_plain(cuda_device, R, C, S, W):
    args = _tag_inputs(R, C, S, W, cuda_device, seed=R + C)
    before = tmod.launches
    got = tmod.ata_tag_probe(*args)
    torch.cuda.synchronize()
    assert tmod.launches == before + 1
    want = tmod.ata_tag_probe_plain(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("W", [6, 8, 64, 96])
def test_tag_probe_reads_the_engine_directory_lane(cuda_device, W):
    """The serving engine's packed directory (C * S + 1, W, 2): the tag
    lane dir[:C * S, :, 0] probed in place equals its contiguous copy
    and the plain version; a set outside [0, S) misses everywhere. W =
    96 takes the kernel's path for W > 64."""
    C, S, K = 16, 64, 18
    R = C * K
    rng = np.random.default_rng(W)
    d = np.zeros((C * S + 1, W, 2), np.int32)
    d[..., 0] = rng.integers(1, 3 * W + 2, (C * S + 1, W))
    d[..., 0][rng.random((C * S + 1, W)) < 0.3] = 0
    d[..., 1] = rng.integers(W, 50 * W, (C * S + 1, W))
    lane = torch.from_numpy(d).to(cuda_device)[:C * S, :, 0].view(C, S, W)
    assert lane.stride() == (S * W * 2, W * 2, 2)
    set_idx = rng.integers(0, S, R).astype(np.int32)
    qtag = d[rng.integers(0, C, R) * S + set_idx, rng.integers(0, W, R), 0]
    qtag[::4] = rng.integers(0, 3 * W + 2, len(qtag[::4]))
    qtag[::9] = 0
    set_idx[[3, 100]] = (-1, S)
    set_idx, qtag = (torch.from_numpy(a).to(cuda_device)
                     for a in (set_idx, qtag))
    valid = lane != 0
    before = tmod.launches
    hits, ways = tmod.ata_tag_probe(set_idx, qtag, lane, valid)
    torch.cuda.synchronize()
    assert tmod.launches == before + 1
    copy = lane.contiguous()
    for g, w in zip((hits, ways), tmod.ata_tag_probe(set_idx, qtag, copy,
                                                     valid)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    inr = (set_idx >= 0) & (set_idx < S)
    want = tmod.ata_tag_probe_plain(set_idx[inr], qtag[inr], copy, valid)
    assert torch.equal(hits[inr], want[0]) and torch.equal(ways[inr],
                                                           want[1])
    assert want[0].any() and not want[0].all()
    assert not hits[~inr].any() and not ways[~inr].any()


@pytest.mark.gpu
def test_serve_stream_on_card_matches_oracle(cuda_device):
    from repro_torch.core.trace.serving import ServingMix
    from repro_torch.serving import SERVING_POLICIES, ref, serve_stream
    st = ServingMix(("chat", "batch")).make_stream(n_shards=4, rounds=64,
                                                   seed=1)
    for policy in SERVING_POLICIES:
        want = ref.run_stream(policy, ref.AtaCacheConfig(), st)
        before = tmod.launches
        res = serve_stream(policy, st.batched(2))
        assert tmod.launches - before == st.rounds
        assert (res.local_hits, res.remote_hits, res.recomputed_blocks,
                res.probe_messages) == (want.local_hits, want.remote_hits,
                                        want.recomputed_blocks,
                                        want.probe_messages)
        np.testing.assert_array_equal(res.shard_load, want.shard_load)


def _assert_one_bf16_step(got, want, atol=1e-5):
    """bf16 kernel output against its plain version: both compute in f32
    and round once, so they may differ by one bf16 rounding step of the
    larger magnitude (plus f32 noise near 0), and no more."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs())
    _, e = torch.frexp(mag)
    step = torch.where(mag > 0, torch.ldexp(torch.ones_like(mag), e - 8),
                       torch.zeros_like(mag))
    err = (g - w).abs()
    assert bool(torch.isfinite(g).all()) and bool((err <= step + atol).all()), \
        float(err.max())


def _attn_inputs(B, Hq, Hkv, Tq, Tk, D, dtype, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(s, generator=g).to(device=device, dtype=dtype)
            for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D))]


#: (B, Hq, Hkv, Tq, Tk, D, dtype, causal, window, kv_len)
ATTN_CASES = [
    (1, 16, 8, 1024, 1024, 128, torch.bfloat16, True, None, None),
    (2, 4, 4, 128, 128, 64, torch.float32, True, None, None),
    (1, 4, 2, 193, 193, 32, torch.float32, True, None, None),    # odd T
    (1, 4, 2, 130, 200, 64, torch.bfloat16, True, 48, None),     # window
    (3, 4, 1, 1, 300, 128, torch.float32, False, None, (0, 17, 300)),
    (2, 2, 2, 64, 64, 32, torch.float32, False, None, None),
    (1, 4, 2, 193, 193, 160, torch.float32, True, None, None),   # stablelm
    (1, 4, 1, 130, 257, 256, torch.float32, True, 64, None),     # rg, MQA
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,dtype,causal,window,kv_len",
                         ATTN_CASES)
def test_flash_attention_kernel_matches_plain(cuda_device, B, Hq, Hkv, Tq,
                                              Tk, D, dtype, causal, window,
                                              kv_len):
    from repro_torch.kernels import flash_attention as fmod
    q, k, v = _attn_inputs(B, Hq, Hkv, Tq, Tk, D, dtype, cuda_device,
                           seed=Tq + Tk)
    kl = (None if kv_len is None else
          torch.tensor(kv_len, dtype=torch.int32, device=cuda_device))
    before = fmod.launches
    got = fmod.flash_attention(q, k, v, kl, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fmod.launches == before + 1
    want = fmod.flash_attention_plain(q, k, v, kl, causal=causal,
                                      window=window)
    assert got.dtype == dtype
    if dtype == torch.bfloat16:
        _assert_one_bf16_step(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    if kv_len is not None and 0 in kv_len:
        assert (got[kv_len.index(0)] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,K,V,bf16,init", [
    (1, 40, 512, 64, 64, True, False),
    (2, 3, 1, 64, 64, False, True),       # one decode step
    (1, 2, 77, 32, 64, False, True),      # K != V, T not a chunk multiple
])
def test_wkv6_kernel_matches_plain(cuda_device, B, H, T, K, V, bf16, init):
    from repro_torch.kernels import wkv6 as wmod
    g = torch.Generator(device="cpu").manual_seed(T + K)

    def n(*s, scale=0.5):
        return (torch.randn(s, generator=g) * scale).to(cuda_device)
    r, k, v = n(B, H, T, K), n(B, H, T, K), n(B, H, T, V)
    if bf16:
        r, k, v = (x.to(torch.bfloat16) for x in (r, k, v))
    w = -torch.exp(n(B, H, T, K, scale=1.0))
    u = n(H, K)
    s0 = n(B, H, K, V) if init else None
    before = wmod.launches
    o, s = wmod.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert wmod.launches == before + 1
    wo, ws = wmod.wkv6_plain(r, k, v, w, u, s0)
    assert o.dtype == r.dtype and s.dtype == torch.float32
    if bf16:
        _assert_one_bf16_step(o, wo)
    else:
        torch.testing.assert_close(o, wo, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(s, ws, rtol=1e-4, atol=1e-4)


#: bf16, the tensor-core kernel: (B, Hq, Hkv, Tq, Tk, D, causal, window,
#: kv_len); head dims 32/64/128, GQA groups 1/2/4, Tq 1/193/4096
BF16_ATTN_CASES = [
    (1, 16, 8, 4096, 4096, 128, True, None, None),     # qwen3 prefill
    (2, 8, 2, 193, 193, 64, True, None, None),         # group 4, ragged
    (1, 4, 4, 193, 300, 32, True, 64, None),           # group 1, window
    (3, 16, 8, 1, 300, 128, False, None, (0, 17, 300)),  # decode, 0 row
    (2, 4, 1, 100, 257, 64, False, None, (256, 3)),    # group 4, kv_len
    (1, 6, 2, 130, 130, 32, True, None, None),         # group 3 (odd)
    # the wide head dims: D=160 pads to three 128-byte boxes, D=256 runs
    # a 2-stage ring
    (1, 32, 8, 1024, 1024, 160, True, None, None),     # stablelm-12b
    (1, 6, 2, 130, 130, 160, True, None, None),        # D=160, group 3
    (3, 8, 2, 1, 300, 160, False, None, (0, 17, 300)),
    (1, 16, 1, 1024, 1024, 256, True, 256, None),      # recurrentgemma
    (1, 3, 1, 200, 200, 256, True, None, None),        # D=256, group 3
    (2, 16, 1, 1, 300, 256, False, None, (5, 300)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal,window,kv_len",
                         BF16_ATTN_CASES)
def test_flash_attention_bf16_tensor_core_kernel(cuda_device, B, Hq, Hkv,
                                                 Tq, Tk, D, causal, window,
                                                 kv_len):
    from repro_torch.kernels import flash_attention as fmod
    q, k, v = _attn_inputs(B, Hq, Hkv, Tq, Tk, D, torch.bfloat16,
                           cuda_device, seed=Tq + Tk + D)
    kl = (None if kv_len is None else
          torch.tensor(kv_len, dtype=torch.int32, device=cuda_device))
    before = fmod.launches
    got = fmod.flash_attention(q, k, v, kl, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fmod.launches == before + 1
    want = fmod.flash_attention_plain(q, k, v, kl, causal=causal,
                                      window=window)
    assert got.dtype == torch.bfloat16
    _assert_one_bf16_step(got, want)
    if kv_len is not None and 0 in kv_len:
        assert (got[kv_len.index(0)] == 0).all()


@pytest.mark.gpu
def test_flash_attention_bf16_model_views(cuda_device):
    """The model hands (B,T,H,D) tensors transposed to (B,H,T,D): the
    tensor maps take their strides, no copy is made."""
    from repro_torch.kernels import flash_attention as fmod
    g = torch.Generator(device="cpu").manual_seed(3)
    B, T, Hq, Hkv, D = 2, 300, 16, 8, 128
    q, k, v = (torch.randn((B, T, h, D), generator=g).to(
        device=cuda_device, dtype=torch.bfloat16).transpose(1, 2)
        for h in (Hq, Hkv, Hkv))
    assert not q.is_contiguous()
    got = fmod.flash_attention(q, k, v, causal=True)
    want = fmod.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _assert_one_bf16_step(got, fmod.flash_attention_plain(q, k, v))


@pytest.mark.gpu
def test_flash_attention_bf16_raises_on_tma_stride(cuda_device):
    from repro_torch.kernels import flash_attention as fmod
    q = torch.zeros((1, 2, 64, 70), dtype=torch.bfloat16,
                    device=cuda_device)[..., :64]      # t stride 140 B
    k = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        fmod.flash_attention(q, k, k)
    base = torch.zeros(2 * 64 * 64 + 1, dtype=torch.bfloat16,
                       device=cuda_device)
    q2 = base[1:].view(1, 2, 64, 64)                   # base 2 B off
    with pytest.raises(ValueError, match="16-byte"):
        fmod.flash_attention(q2, k, k)


@pytest.mark.gpu
def test_flash_attention_raises_on_a_head_dim_it_lacks(cuda_device):
    from repro_torch.kernels import flash_attention as fmod
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((1, 2, 64, 96), dtype=dtype, device=cuda_device)
        before = fmod.launches
        with pytest.raises(ValueError, match="head dims"):
            fmod.flash_attention(q, q, q)
        assert fmod.launches == before


@pytest.mark.gpu
def test_flash_attention_f32_stays_on_cuda_cores(cuda_device):
    """f32 inputs keep the f32 CUDA-core kernel, at the f32 tolerance."""
    from repro_torch.kernels import flash_attention as fmod
    q, k, v = _attn_inputs(1, 16, 8, 512, 512, 128, torch.float32,
                           cuda_device, seed=5)
    got = fmod.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = fmod.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_flash_attention_library_has_tensor_core_and_tma_code(cuda_device):
    """The built library's SASS holds wgmma (HGMMA) and TMA loads
    (UTMALDG), where the toolkit has cuobjdump."""
    import shutil
    import subprocess
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib, _ = build.build("flash_attention")
    try:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        pytest.skip("cuobjdump is not available")
    assert "HGMMA" in sass and "UTMALDG" in sass


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,K,V,init", [
    (1, 40, 1, 64, 64, True),        # a decode step
    (1, 8, 63, 64, 64, True),
    (1, 8, 64, 64, 64, False),       # the LM decode check's forward
    (2, 3, 65, 64, 64, True),        # a ragged tail of one row
    (1, 40, 4096, 64, 64, False),    # rwkv6-3b prefill
    (2, 3, 300, 32, 64, True),       # K != V
])
def test_wkv6_chunked_kernel_matches_plain(cuda_device, B, H, T, K, V, init):
    from repro_torch.kernels import wkv6 as wmod
    g = torch.Generator(device="cpu").manual_seed(T + K)

    def n(*s, scale=0.5):
        return (torch.randn(s, generator=g) * scale).to(cuda_device)
    r, k, v = (n(B, H, T, d).to(torch.bfloat16) for d in (K, K, V))
    w = -torch.exp(n(B, H, T, K, scale=1.0))
    u = n(H, K)
    s0 = n(B, H, K, V) if init else None
    o, s = wmod.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    wo, ws = wmod.wkv6_plain(r, k, v, w, u, s0)
    _assert_one_bf16_step(o, wo)
    torch.testing.assert_close(s, ws, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_wkv6_chained_halves_equal_whole(cuda_device):
    from repro_torch.kernels import wkv6 as wmod
    g = torch.Generator(device="cpu").manual_seed(11)
    B, H, T, K = 1, 8, 1000, 64
    r, k, v = (torch.randn((B, H, T, K), generator=g).mul(0.5).to(
        cuda_device, torch.bfloat16) for _ in range(3))
    w = -torch.exp(torch.randn((B, H, T, K), generator=g)).to(cuda_device)
    u = torch.randn((H, K), generator=g).to(cuda_device)
    o, s = wmod.wkv6(r, k, v, w, u)
    h = 437
    o1, s1 = wmod.wkv6(r[:, :, :h], k[:, :, :h], v[:, :, :h], w[:, :, :h], u)
    o2, s2 = wmod.wkv6(r[:, :, h:], k[:, :, h:], v[:, :, h:], w[:, :, h:], u,
                       s1)
    torch.cuda.synchronize()
    _assert_one_bf16_step(torch.cat([o1, o2], 2), o)
    torch.testing.assert_close(s2, s, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("T,split", [(64, 1), (200, 37)])
def test_wkv6_chained_calls_bit_equal_one_call(cuda_device, T, split):
    """Calls of ``split`` steps chained through the state return, bit for
    bit, what one call over T steps returns (split 1: the decode steps
    ``decode_step`` launches)."""
    from repro_torch.kernels import wkv6 as wmod
    g = torch.Generator(device="cpu").manual_seed(T)
    B, H, K = 1, 40, 64
    r, k, v = (torch.randn((B, H, T, K), generator=g).mul(0.5).to(
        cuda_device, torch.bfloat16) for _ in range(3))
    w = -torch.exp(torch.randn((B, H, T, K), generator=g)).to(cuda_device)
    u = torch.randn((H, K), generator=g).to(cuda_device)
    s0 = torch.randn((B, H, K, K), generator=g).to(cuda_device)
    o, s = wmod.wkv6(r, k, v, w, u, s0)
    state, outs = s0, []
    for t0 in range(0, T, split):
        sl = slice(t0, t0 + split)
        ot, state = wmod.wkv6(r[:, :, sl], k[:, :, sl], v[:, :, sl],
                              w[:, :, sl], u, state)
        outs.append(ot)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(outs, 2), o)
    assert torch.equal(state, s)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["attention", "wkv6"])
def test_kernel_route_raises_under_grad(cuda_device, kernel):
    """The LM kernels have no backward pass: on CUDA tensors the kernel
    route raises when grad mode is on and an input requires grad, and
    runs under ``torch.no_grad()``; the plain route differentiates."""
    from repro_torch.kernels import ops
    g = torch.Generator(cuda_device).manual_seed(0)
    if kernel == "attention":
        args = [torch.randn((1, 2, 64, 64), generator=g, device=cuda_device)
                for _ in range(3)]
        fn = ops.attention
    else:
        r, k, v = (torch.randn((1, 2, 16, 64), generator=g,
                               device=cuda_device) for _ in range(3))
        w = -torch.rand((1, 2, 16, 64), generator=g, device=cuda_device)
        args = [r, k, v, w, torch.randn((2, 64), generator=g,
                                        device=cuda_device)]
        fn = ops.wkv6
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        fn(*args, impl="kernel")
    with torch.no_grad():
        fn(*args, impl="kernel")
    out = fn(*args, impl="ref")
    out = out[0] if isinstance(out, tuple) else out
    out.float().sum().backward()
    assert args[0].grad is not None and torch.isfinite(args[0].grad).all()
