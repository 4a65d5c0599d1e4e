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
