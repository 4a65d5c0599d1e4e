"""Port parity: the ``flash_attention`` kernel module.

On the CPU the wrapper takes the plain PyTorch version, which is held
against the reference Pallas kernel in interpret mode and the reference
oracles ``ref.attention_ref`` / ``ref.attention_len_ref`` over the
shapes of ``tests/test_kernels.py`` (GQA, window, bidirectional, Tq=1,
``kv_len``, bf16) and at the two wide head dims of the served configs
(160: stablelm-12b; 256 with MQA and a window: recurrentgemma-9b), at the
reference's tolerances (f32: rtol 2e-4, atol 2e-5; bf16: 5e-2). Shapes the Pallas kernel cannot tile (odd T) and
fully masked rows are held against the oracles. The CUDA kernel itself
runs only on the card: ``tests/test_torch_kernels_gpu.py`` and
``chip_smoke.py`` hold it against the plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402,E501
from repro_torch.kernels import flash_attention as kmod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.attention import blocked_attention  # noqa: E402

F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _both(a, dtype="float32"):
    """The same values as a jax array and a torch tensor."""
    j = jnp.asarray(a, dtype=jnp.bfloat16 if dtype == "bfloat16" else None)
    t = torch.from_numpy(a)
    return j, (t.to(torch.bfloat16) if dtype == "bfloat16" else t)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


#: test_kernels.py::test_flash_attention_sweep
SWEEP = [
    (1, 4, 4, 128, 128, 64, 64, 64, True, None),
    (2, 8, 2, 256, 256, 64, 128, 128, True, None),     # GQA
    (1, 4, 2, 128, 128, 32, 64, 32, True, 48),         # window
    (2, 4, 4, 64, 64, 128, 64, 64, False, None),       # bidirectional
    (1, 2, 1, 1, 128, 64, 1, 64, False, None),         # decode Tq=1
]
#: the wide head dims: stablelm-12b's 160 (GQA 4), recurrentgemma-9b's
#: 256 (MQA, window), both at Tq=1 too
SWEEP_WIDE = [
    (1, 8, 2, 128, 128, 160, 64, 64, True, None),
    (1, 4, 1, 128, 128, 256, 64, 32, True, 48),
    (2, 4, 1, 1, 128, 160, 1, 64, False, None),
    (1, 2, 1, 1, 96, 256, 1, 32, False, None),
]


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,bq,bk,causal,window",
                         SWEEP + SWEEP_WIDE)
def test_plain_matches_pallas_and_oracle(B, Hq, Hkv, Tq, Tk, D, bq, bk,
                                         causal, window):
    q, k, v = _arrays(Tq + Tk + D, (B, Hq, Tq, D), (B, Hkv, Tk, D),
                      (B, Hkv, Tk, D), scale=0.5)
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    got = kmod.flash_attention(tq, tk, tv, causal=causal, window=window)
    want_kernel = pallas_flash(jq, jk, jv, causal=causal, window=window,
                               bq=bq, bk=bk)
    want_ref = ref.attention_ref(jq, jk, jv, causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (B, Hq, Tq, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **F32)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 24)])
def test_plain_kv_len_matches_pallas_and_oracle(causal, window, D=64):
    B, Hq, Hkv, Tk = 2, 4, 2, 128
    Tq = 1 if not causal else 32
    q, k, v = _arrays(7, (B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D))
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    kl = np.asarray([37, 100], np.int32)
    got = kmod.flash_attention(tq, tk, tv, torch.from_numpy(kl),
                               causal=causal, window=window)
    want_kernel = pallas_flash(jq, jk, jv, kv_len=jnp.asarray(kl),
                               causal=causal, window=window, bq=Tq, bk=32)
    want_ref = ref.attention_len_ref(jq, jk, jv, jnp.asarray(kl),
                                     causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **F32)


@pytest.mark.parametrize("causal,window,D", [(False, None, 160),
                                             (True, 24, 256)])
def test_plain_kv_len_wide_head_dims(causal, window, D):
    test_plain_kv_len_matches_pallas_and_oracle(causal, window, D)


def test_plain_bf16_matches_pallas_and_oracle():
    q, k, v = _arrays(3, (1, 2, 64, 64), (1, 2, 64, 64), (1, 2, 64, 64))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "bfloat16") for a in (q, k, v))
    got = kmod.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    want_kernel = pallas_flash(jq, jk, jv, causal=True, bq=32, bk=32)
    want_ref = ref.attention_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(_np(got), _np(want_kernel), **BF16)
    np.testing.assert_allclose(_np(got), _np(want_ref), **BF16)


@pytest.mark.parametrize("Tq,Tk,causal,window", [
    (193, 193, True, None),     # odd T: no tiling restriction in the port
    (37, 101, True, 16),        # Tq < Tk, end-aligned, window
    (5, 67, False, 9),
])
def test_plain_untileable_shapes_match_oracle(Tq, Tk, causal, window):
    q, k, v = _arrays(Tq * Tk, (1, 4, Tq, 32), (1, 2, Tk, 32),
                      (1, 2, Tk, 32), scale=0.5)
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    got = kmod.flash_attention(tq, tk, tv, causal=causal, window=window)
    want = ref.attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_fully_masked_rows_are_zero():
    """kv_len=0 rows, and rows whose window sees no valid key, come back
    as zeros, as the TPU kernel writes them (the plain einsum oracle
    gives NaN there; attention_len_ref zeros)."""
    B, Hq, Hkv, Tq, Tk, D = 3, 4, 2, 8, 40, 32
    q, k, v = _arrays(11, (B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D))
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    kl = np.asarray([0, 20, 40], np.int32)
    got = kmod.flash_attention(tq, tk, tv, torch.from_numpy(kl),
                               causal=True, window=4)
    want = ref.attention_len_ref(jq, jk, jv, jnp.asarray(kl), causal=True,
                                 window=4)
    assert (got[0] == 0).all()
    assert (got[1] == 0).all()     # its window (keys 33..39) is past kv_len
    assert (got[2] != 0).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("causal,window,kv", [(True, None, False),
                                              (True, 16, False),
                                              (False, None, True)])
def test_routes_agree(causal, window, kv):
    """ops.attention's two routes are one function on the CPU, and the
    plain blocked route agrees with them."""
    q, k, v = _arrays(5, (2, 4, 64, 32), (2, 2, 64, 32), (2, 2, 64, 32))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kl = torch.tensor([50, 64], dtype=torch.int32) if kv else None
    a = ops.attention(tq, tk, tv, kl, causal=causal, window=window,
                      impl="kernel")
    b = ops.attention(tq, tk, tv, kl, causal=causal, window=window,
                      impl="ref")
    c = blocked_attention(tq, tk, tv, causal=causal, window=window,
                          chunk=16, kv_len=kl)
    assert torch.equal(a, b)
    np.testing.assert_allclose(c.numpy(), a.numpy(), **F32)


def test_noncontiguous_views_match_contiguous():
    """The model hands (B,T,H,D) tensors transposed to (B,H,T,D) views."""
    q, k, v = _arrays(9, (1, 24, 4, 32), (1, 24, 2, 32), (1, 24, 2, 32))
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    got = kmod.flash_attention(tq, tk, tv, causal=True)
    want = kmod.flash_attention(tq.contiguous(), tk.contiguous(),
                                tv.contiguous(), causal=True)
    assert torch.equal(got, want)


def test_wrapper_takes_plain_version_only_on_cpu():
    q = torch.zeros((1, 2, 4, 32))
    before = kmod.launches
    kmod.flash_attention(q, q, q)
    assert kmod.launches == before        # the plain version launches none
    with pytest.raises(ValueError, match="cuda or cpu"):
        kmod.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.attention(q, q, q, impl="pallas")


# ---------------------------------------------------------------------------
# The bf16 Hopper kernel's arithmetic, emulated on the CPU. The kernel
# (csrc/flash_attention.cu) computes S = QK^T from bf16 operands with f32
# accumulation, scales S by D^-0.5 in f32 after the product, runs the
# online softmax in f32 over tiles of 64 keys (base 2), and multiplies P
# by V on the tensor cores with P split as p_hi + p_lo, two bf16
# operands. The emulation below does the same, and is held within one
# bf16 rounding step of the plain version and of the Pallas kernel: the
# criterion that chip_smoke.py and the GPU tests hold the kernel to.
# ---------------------------------------------------------------------------
LOG2E = 1.4426950408889634


def _bf16(x):
    return x.to(torch.bfloat16).float()


def emulate_bf16_kernel(q, k, v, kv_len=None, *, causal=True, window=None,
                        split=True, tile=64):
    """q (B,Hq,Tq,D), k/v (B,Hkv,Tk,D) bf16 -> (B,Hq,Tq,D) bf16."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qf, kf, vf = (x.float() for x in (q, k, v))
    kf = kf.repeat_interleave(g, 1)
    vf = vf.repeat_interleave(g, 1)
    qpos = torch.arange(Tq)[:, None] + (Tk - Tq)
    lens = [Tk] * B if kv_len is None else [int(n) for n in kv_len]
    m = torch.full((B, Hq, Tq, 1), float("-inf"))
    l = torch.zeros((B, Hq, Tq, 1))
    o = torch.zeros((B, Hq, Tq, D))
    for k0 in range(0, Tk, tile):
        kpos = torch.arange(k0, min(k0 + tile, Tk))[None, :]
        s = qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)    # f32 sum
        s = s * (D ** -0.5 * LOG2E)
        ok = torch.ones((Tq, kpos.shape[1]), dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        ok = ok[None, None] & (kpos < torch.tensor(lens)[:, None, None,
                                                          None])
        s = s.masked_fill(~ok, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        mu = torch.where(m_new == float("-inf"), 0.0, m_new)
        corr = torch.exp2(m - mu)
        p = torch.exp2(s - mu)
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
        p_hi = _bf16(p)
        pv = p_hi @ vf[:, :, k0:k0 + tile]
        if split:
            pv = pv + _bf16(p - p_hi) @ vf[:, :, k0:k0 + tile]
        o = o * corr + pv
    o = torch.where(l == 0, 0.0, o / torch.where(l == 0, 1.0, l))
    return o.to(torch.bfloat16)


def bf16_steps_apart(got, want, atol=1e-5):
    """Elements of bf16 ``got`` and ``want`` more than one bf16 rounding
    step of the larger magnitude (+ atol, f32 noise near 0) apart: the
    criterion of chip_smoke.check_bf16_step."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs())
    _, e = torch.frexp(mag)
    step = torch.where(mag > 0, torch.ldexp(torch.ones_like(mag), e - 8),
                       torch.zeros_like(mag))
    return int(((g - w).abs() > step + atol).sum())


def _bf16_inputs(seed, B, Hq, Hkv, Tq, Tk, D):
    q, k, v = _arrays(seed, (B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D))
    return [_both(a, "bfloat16") for a in (q, k, v)]


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,bq,bk,causal,window",
                         SWEEP + SWEEP_WIDE)
def test_bf16_kernel_arithmetic_within_one_step(B, Hq, Hkv, Tq, Tk, D, bq,
                                                bk, causal, window):
    (jq, tq), (jk, tk), (jv, tv) = _bf16_inputs(Tq + Tk + D, B, Hq, Hkv,
                                                Tq, Tk, D)
    got = emulate_bf16_kernel(tq, tk, tv, causal=causal, window=window)
    plain = kmod.flash_attention_plain(tq, tk, tv, causal=causal,
                                       window=window)
    pallas = pallas_flash(jq, jk, jv, causal=causal, window=window, bq=bq,
                          bk=bk)
    pallas = torch.from_numpy(np.array(jnp.asarray(pallas, jnp.float32)))
    assert bf16_steps_apart(got, plain) == 0
    assert bf16_steps_apart(got, pallas) == 0


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal,window,kv_len", [
    (2, 4, 2, 32, 128, 64, True, None, (37, 100)),       # kv_len
    (2, 4, 2, 1, 128, 64, False, None, (0, 77)),         # Tq=1, a 0 row
    (1, 4, 2, 193, 193, 32, True, None, None),           # ragged T
    (1, 4, 1, 37, 101, 32, True, 16, None),              # Tq < Tk, window
])
def test_bf16_kernel_arithmetic_ragged_and_kv_len(B, Hq, Hkv, Tq, Tk, D,
                                                  causal, window, kv_len):
    (_, tq), (_, tk), (_, tv) = _bf16_inputs(Tq * Tk + D, B, Hq, Hkv, Tq,
                                             Tk, D)
    kl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    got = emulate_bf16_kernel(tq, tk, tv, kv_len, causal=causal,
                              window=window)
    plain = kmod.flash_attention_plain(tq, tk, tv, kl, causal=causal,
                                       window=window)
    assert bf16_steps_apart(got, plain) == 0
    if kv_len is not None and 0 in kv_len:
        assert (got[kv_len.index(0)] == 0).all()


def test_single_bf16_p_is_not_enough():
    """Why the kernel splits P: rounding P to one bf16 operand, as SDPA
    and FlashAttention do, leaves outputs more than one bf16 step from the
    f32 function at a small causal shape; the split leaves none."""
    (_, tq), (_, tk), (_, tv) = _bf16_inputs(17, 1, 4, 2, 512, 512, 128)
    plain = kmod.flash_attention_plain(tq, tk, tv, causal=True)
    one = emulate_bf16_kernel(tq, tk, tv, causal=True, split=False)
    two = emulate_bf16_kernel(tq, tk, tv, causal=True, split=True)
    assert bf16_steps_apart(one, plain) > 0
    assert bf16_steps_apart(two, plain) == 0
