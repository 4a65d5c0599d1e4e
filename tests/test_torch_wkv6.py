"""Port parity: the ``wkv6`` kernel module.

On the CPU the wrapper takes the plain PyTorch version, which is held
against the reference Pallas kernel in interpret mode and the oracle
``ref.wkv6_ref`` over the shapes of ``tests/test_kernels.py`` (K != V,
chaining two halves, strong decay) plus T=1 with an initial state (one
decode step), at the reference's tolerances (rtol 2e-3, atol 2e-4). The
CUDA kernel itself runs only on the card: ``tests/test_torch_kernels_gpu.py``
and ``chip_smoke.py`` hold it against the plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref  # noqa: E402
from repro.kernels.wkv6 import wkv6 as pallas_wkv6  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import wkv6 as kmod  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, H, T, K, V, decay=None):
    """(r, k, v, w, u) as numpy f32, w = -exp(normal) <= 0 unless given."""
    rng = np.random.default_rng(seed)

    def n(*s, scale=0.5):
        return (rng.standard_normal(s) * scale).astype(np.float32)
    w = (-np.exp(n(B, H, T, K, scale=1.0)) if decay is None
         else np.full((B, H, T, K), decay, np.float32))
    return n(B, H, T, K), n(B, H, T, K), n(B, H, T, V), w, n(H, K)


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _check(got, *wants):
    for want in wants:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


#: test_kernels.py::test_wkv6_sweep
SWEEP = [
    (1, 2, 128, 64, 64, 64),
    (2, 3, 192, 64, 64, 32),
    (1, 1, 64, 32, 64, 64),     # K != V
    (2, 2, 256, 64, 64, 128),
]


@pytest.mark.parametrize("B,H,T,K,V,chunk", SWEEP)
def test_plain_matches_pallas_and_oracle(B, H, T, K, V, chunk):
    x = _inputs(B * T + K, B, H, T, K, V)
    got = kmod.wkv6(*_t(x), chunk=chunk)
    assert got[0].shape == (B, H, T, V) and got[1].shape == (B, H, K, V)
    assert got[0].dtype == got[1].dtype == torch.float32
    _check(got, pallas_wkv6(*_j(x), chunk=chunk), ref.wkv6_ref(*_j(x)))


def test_initial_state_chaining():
    """Processing [first half] then [second half] == whole sequence."""
    B, H, T, K = 1, 2, 128, 64
    x = _t(_inputs(1, B, H, T, K, K))
    r, k, v, w, u = x
    o_full, s_full = kmod.wkv6(*x)
    h = T // 2
    o1, s1 = kmod.wkv6(r[:, :, :h], k[:, :, :h], v[:, :, :h], w[:, :, :h],
                       u)
    o2, s2 = kmod.wkv6(r[:, :, h:], k[:, :, h:], v[:, :, h:], w[:, :, h:],
                       u, s1)
    np.testing.assert_allclose(torch.cat([o1, o2], 2).numpy(),
                               o_full.numpy(), **TOL)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), **TOL)
    jx = _j(_inputs(1, B, H, T, K, K))
    _check((o_full, s_full), pallas_wkv6(*jx, chunk=32))


@pytest.mark.parametrize("K,V", [(64, 64), (32, 64)])
def test_single_step_with_initial_state(K, V):
    """T=1 from a mid-run state: what every decode step runs."""
    x = _inputs(K + V, 2, 3, 1, K, V)
    s0 = np.random.default_rng(0).standard_normal((2, 3, K, V)).astype(
        np.float32)
    got = kmod.wkv6(*_t(x), torch.from_numpy(s0))
    _check(got, ref.wkv6_ref(*_j(x), initial_state=jnp.asarray(s0)),
           pallas_wkv6(*_j(x), jnp.asarray(s0)))


def test_strong_decay_stable():
    x = _inputs(2, 1, 1, 128, 64, 64, decay=-20.0)
    o, s = kmod.wkv6(*_t(x))
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    _check((o, s), ref.wkv6_ref(*_j(x)))


def test_bf16_inputs_match_oracle():
    """bf16 r, k, v with f32 w (as the model passes them): o comes back
    in r's dtype, the state in f32."""
    x = _inputs(4, 1, 2, 64, 64, 64)
    t = _t(x)
    for i in range(3):
        t[i] = t[i].to(torch.bfloat16)
    o, s = kmod.wkv6(*t)
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    jx = [jnp.asarray(a, jnp.bfloat16) if i < 3 else jnp.asarray(a)
          for i, a in enumerate(x)]
    wo, ws = ref.wkv6_ref(*jx)
    np.testing.assert_allclose(o.float().numpy(), np.asarray(wo),
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), **TOL)


def test_routes():
    """The "ref" route returns o in f32 as the reference's oracle does,
    the kernel route in r's dtype; the values agree."""
    t = _t(_inputs(6, 1, 2, 16, 64, 64))
    r16 = t[0].to(torch.bfloat16)
    o_ref, s_ref = ops.wkv6(r16, *t[1:], impl="ref")
    o_k, s_k = ops.wkv6(r16, *t[1:], impl="kernel")
    assert o_ref.dtype == torch.float32 and o_k.dtype == torch.bfloat16
    assert torch.equal(o_ref.to(torch.bfloat16), o_k)
    assert torch.equal(s_ref, s_k)
    before = kmod.launches
    kmod.wkv6(*t)
    assert kmod.launches == before        # the plain version launches none
    meta = [a.to("meta") for a in t]
    with pytest.raises(ValueError, match="cuda or cpu"):
        kmod.wkv6(*meta)


# ---------------------------------------------------------------------------
# The TPU kernel's chunked form, in f32, emulated on the CPU: chunks of
# 64 steps with a ragged, zero-padded tail, w scaled to base 2 and its
# cumsum carried as two floats (emulated here by an f64 cumsum split into
# hi + lo), the intra-chunk matrix with every exponent masked before
# exp2, factored through the pivot row 31 where s < 32 <= t, the bonus
# on its diagonal, the inter-chunk product with the state and the state
# update. The Hopper kernel ran this form until it was found to round
# unlike chained decode steps (see the scan kernel's tests below); these
# tests hold the form itself against the plain version and the Pallas
# kernel.
# ---------------------------------------------------------------------------
LOG2E = 1.4426950408889634


def emulate_chunked_kernel(r, k, v, w, u, s0=None, L=64, pivot=31):
    B, H, T, K = r.shape
    V = v.shape[-1]
    r, k, v, w = (x.float() for x in (r, k, v, w))
    S = (torch.zeros(B, H, K, V) if s0 is None else s0.clone().float())
    outs = []
    for t0 in range(0, T, L):
        n = min(L, T - t0)

        def pad(x):
            return torch.nn.functional.pad(x[:, :, t0:t0 + n],
                                           (0, 0, 0, L - n))
        rc, kc, vc, wc = pad(r), pad(k), pad(v), pad(w * LOG2E)
        c64 = torch.cumsum(wc.double(), 2)
        hi = c64.float()
        lo = (c64 - hi.double()).float()

        def diff(a_hi, a_lo, b_hi, b_lo):     # (a - b) from the two floats
            return (a_hi - b_hi) + (a_lo - b_lo)
        zero = torch.zeros_like(hi[:, :, :1])
        p_hi = torch.cat([zero, hi[:, :, :-1]], 2)     # c_prev = c[t-1]
        p_lo = torch.cat([zero, lo[:, :, :-1]], 2)
        t_idx = torch.arange(L)[:, None]
        s_idx = torch.arange(L)[None, :]
        # direct terms: s < t in the same half
        e = diff(p_hi[:, :, :, None], p_lo[:, :, :, None],
                 hi[:, :, None], lo[:, :, None])          # (B,H,t,s,K)
        same = (s_idx < t_idx) & ((s_idx > pivot) == (t_idx > pivot))
        e = torch.where(same[None, None, :, :, None], e,
                        torch.tensor(float("-inf")))
        A = (rc[:, :, :, None] * kc[:, :, None] * torch.exp2(e)).sum(-1)
        # s <= pivot < t: through the pivot row, both factors <= 1
        ph, pl = hi[:, :, pivot:pivot + 1], lo[:, :, pivot:pivot + 1]
        rf = rc * torch.exp2(diff(p_hi, p_lo, ph, pl))
        kf = kc * torch.exp2(diff(ph, pl, hi, lo))
        cross = (s_idx <= pivot) & (t_idx > pivot)
        A = A + torch.where(cross[None, None], rf @ kf.transpose(-1, -2),
                            0.0)
        A = A + torch.diag_embed((rc * u[None, :, None] * kc).sum(-1))
        rd = rc * torch.exp2(p_hi + p_lo)
        outs.append((rd @ S + A @ vc)[:, :, :n])
        kd = kc * torch.exp2(diff(hi[:, :, -1:], lo[:, :, -1:], hi, lo))
        S = (torch.exp2(hi[:, :, -1] + lo[:, :, -1])[..., None] * S
             + kd.transpose(-1, -2) @ vc)
    o = torch.cat(outs, 2) if outs else torch.zeros(B, H, 0, V)
    return o, S


@pytest.mark.parametrize("T", [1, 64, 65, 128, 200])
@pytest.mark.parametrize("decay", [None, -20.0])
def test_chunked_kernel_arithmetic(T, decay):
    """The chunked form's arithmetic against the plain version and,
    where T is a multiple of the chunk, the Pallas kernel."""
    B, H, K, V = 1, 2, 64, 64
    x = _inputs(T + (7 if decay else 0), B, H, T, K, V, decay=decay)
    s0 = np.random.default_rng(T).standard_normal((B, H, K, V)).astype(
        np.float32)
    got = emulate_chunked_kernel(*_t(x), torch.from_numpy(s0))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    want = kmod.wkv6_plain(*_t(x), torch.from_numpy(s0))
    wants = [want]
    if T % 64 == 0:
        wants.append(pallas_wkv6(*_j(x), jnp.asarray(s0), chunk=64))
    _check(got, *wants)


def test_chunked_kernel_arithmetic_k_not_v():
    x = _inputs(3, 2, 3, 130, 32, 64)
    _check(emulate_chunked_kernel(*_t(x)), kmod.wkv6_plain(*_t(x)),
           ref.wkv6_ref(*_j(x)))


# ---------------------------------------------------------------------------
# The Hopper scan kernel's arithmetic (csrc/wkv6.cu), emulated on the CPU.
# Per step, with S the state before it: each group of four state rows
# adds its share of r S in row order (a product, then FMAs); the 16
# groups' shares are added in group order; the bonus v * beta is added
# by an FMA, beta = sum_i r_i u_i k_i over two rows per lane of a warp
# and a butterfly over the 32 lanes; then S = exp(w) S + k v, one FMA per
# element. Rows past K are zero. An FMA is emulated in f64 and rounded
# once to f32. Nothing depends on where a call starts or ends.
# ---------------------------------------------------------------------------
def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def emulate_scan_kernel(r, k, v, w, u, s0=None):
    B, H, T, K = r.shape
    V = v.shape[-1]
    pad = (0, 64 - K)
    r, k, w = (torch.nn.functional.pad(x.float(), pad) for x in (r, k, w))
    v = v.float()
    u = torch.nn.functional.pad(u.float(), pad)
    S = torch.zeros(B, H, 64, V)
    if s0 is not None:
        S[:, :, :K] = s0.float()
    lanes = torch.arange(32)
    outs = []
    for t in range(T):
        rt, kt, vt = r[:, :, t], k[:, :, t], v[:, :, t]
        rg, sg = rt.view(B, H, 16, 4, 1), S.view(B, H, 16, 4, V)
        p = rg[:, :, :, 0] * sg[:, :, :, 0]
        for m in range(1, 4):
            p = _fma(rg[:, :, :, m], sg[:, :, :, m], p)
        acc = p[:, :, 0]
        for g in range(1, 16):
            acc = acc + p[:, :, g]
        lane = (rt[..., :32] * u[:, :32]) * kt[..., :32]
        lane = _fma(rt[..., 32:] * u[:, 32:], kt[..., 32:], lane)
        for m in (16, 8, 4, 2, 1):
            lane = lane + lane[..., lanes ^ m]
        outs.append(_fma(vt, lane[..., :1], acc))
        S = _fma(torch.exp(w[:, :, t])[..., None], S,
                 kt[..., None] * vt[:, :, None])
    o = torch.stack(outs, 2) if outs else torch.zeros(B, H, 0, V)
    return o, S[:, :, :K]


def _bf16_steps_apart(got, want, atol=1e-5):
    """Elements of bf16 ``got`` and ``want`` more than one bf16 rounding
    step of the larger magnitude (+ atol, f32 noise near 0) apart: the
    criterion of chip_smoke.check_bf16_step."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs())
    _, e = torch.frexp(mag)
    step = torch.where(mag > 0, torch.ldexp(torch.ones_like(mag), e - 8),
                       torch.zeros_like(mag))
    return int(((g - w).abs() > step + atol).sum())


@pytest.mark.parametrize("T", [1, 33, 64, 200])
@pytest.mark.parametrize("decay", [None, -20.0])
def test_scan_kernel_arithmetic(T, decay):
    """The scan kernel's arithmetic against the plain version and, where
    T is a multiple of 64, the Pallas kernel, in f32."""
    B, H, K, V = 1, 2, 64, 64
    x = _inputs(T + (5 if decay else 0), B, H, T, K, V, decay=decay)
    s0 = np.random.default_rng(T + 1).standard_normal((B, H, K, V)).astype(
        np.float32)
    got = emulate_scan_kernel(*_t(x), torch.from_numpy(s0))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    wants = [kmod.wkv6_plain(*_t(x), torch.from_numpy(s0))]
    if T % 64 == 0:
        wants.append(pallas_wkv6(*_j(x), jnp.asarray(s0), chunk=64))
    _check(got, *wants)


@pytest.mark.parametrize("K,V", [(64, 64), (32, 64), (64, 48)])
def test_scan_kernel_bf16_within_one_step(K, V):
    """bf16 r, k, v and f32 w as the model hands them over: o rounded
    once to bf16 is within one bf16 step of the plain version's."""
    x = _t(_inputs(K + V, 2, 3, 96, K, V))
    for i in range(3):
        x[i] = x[i].to(torch.bfloat16)
    s0 = torch.from_numpy(np.random.default_rng(K).standard_normal(
        (2, 3, K, V)).astype(np.float32))
    o, s = emulate_scan_kernel(*x, s0)
    wo, ws = kmod.wkv6_plain(*x, s0)
    assert _bf16_steps_apart(o.to(torch.bfloat16), wo) == 0
    np.testing.assert_allclose(s.numpy(), ws.numpy(), **TOL)


def test_scan_kernel_chained_steps_equal_one_call():
    """T one-step calls chained through the state return, bit for bit,
    what one call over the T steps returns: the property that lets a
    forward and a decode of the same tokens agree in bf16."""
    x = _t(_inputs(8, 1, 2, 64, 64, 64))
    for i in range(3):
        x[i] = x[i].to(torch.bfloat16)
    s0 = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 2, 64, 64)).astype(np.float32))
    o, s = emulate_scan_kernel(*x, s0)
    state, outs = s0, []
    for t in range(64):
        ot, state = emulate_scan_kernel(*(y[:, :, t:t + 1] for y in x[:4]),
                                        x[4], state)
        outs.append(ot)
    assert torch.equal(torch.cat(outs, 2).to(torch.bfloat16),
                       o.to(torch.bfloat16))
    assert torch.equal(state, s)
