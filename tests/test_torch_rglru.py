"""Port parity: the RG-LRU block (``models/recurrent.py``).

The reference's RG-LRU parameters (``rglru_init``) are copied into the
port's module, and the same numpy-seeded inputs go through both:

- ``_causal_conv`` with and without a carried state (rtol 1e-6: the
  same products added in the same order);
- the scan: the port's log-depth doubling scan against the reference's
  ``lax.associative_scan`` for T from 1 to 4096, within rtol 1e-5 +
  atol 1e-6 (the two trees add the same terms in another order; a_t in
  (0, 1) keeps every partial product and sum bounded);
- ``rglru_forward`` with and without a state (the initial h folded into
  step 1), to rtol 1e-5 + atol 1e-6;
- 12 chained ``rglru_decode`` steps against the reference's chain
  (rtol 1e-5 + atol 1e-6) and against one forward over the 12 tokens
  (rtol 1e-5 + atol 1e-5: a sequential chain against the scan's tree).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import recurrent as RR  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import recurrent as PR  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block(**over):
    rcfg = dataclasses.replace(ref_smoke("recurrentgemma-9b"), **over)
    rp = RR.rglru_init(jax.random.PRNGKey(4), rcfg)
    cfg = convert.model_config(rcfg)
    p = PR.RGLRU(cfg, device="cpu")
    for name, t in p.named_parameters():
        leaf = rp["rglru"]
        for part in name.split("."):
            leaf = leaf[part]
        t.data.copy_(torch.from_numpy(np.array(leaf)))
    return rcfg, rp, cfg, p


def _n(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rcfg, rp, cfg, p = _block()
    x = _n(2, 9, cfg.d_model)
    st = _n(2, cfg.conv_width - 1, cfg.d_model, seed=1) if with_state \
        else None
    want, wst = RR._causal_conv(rp["rglru"], jnp.asarray(x),
                                None if st is None else jnp.asarray(st))
    got, gst = PR._causal_conv(p, torch.from_numpy(x),
                               None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(gst.numpy(), np.asarray(wst))


@pytest.mark.parametrize("T", [1, 2, 3, 7, 64, 129, 1000, 4096])
def test_scan_matches_associative_scan(T):
    rng = np.random.default_rng(T)
    # decays as the block makes them: a = exp(-c r softplus(-lam)) in (0,1)
    a = np.exp(-8.0 * rng.random((2, T, 8)) * 0.1).astype(np.float32)
    gx = rng.standard_normal((2, T, 8)).astype(np.float32)
    want = RR._rglru_scan(jnp.asarray(a), jnp.asarray(gx))
    got = PR._rglru_scan(torch.from_numpy(a), torch.from_numpy(gx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and against the sequential recurrence in f64
    h, seq = np.zeros((2, 8)), []
    for t in range(T):
        h = a[:, t].astype(np.float64) * h + gx[:, t]
        seq.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(seq, 1), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_forward_matches_reference(with_state):
    rcfg, rp, cfg, p = _block()
    x = _n(2, 33, cfg.d_model, seed=2)
    st = None
    if with_state:
        st = {"conv": _n(2, cfg.conv_width - 1, cfg.d_model, seed=3),
              "h": _n(2, cfg.d_model, seed=4)}
    want, wst = RR.rglru_forward(
        rp, rcfg, jnp.asarray(x),
        None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    got, gst = PR.rglru_forward(
        p, cfg, torch.from_numpy(x),
        None if st is None else {k: torch.from_numpy(v)
                                 for k, v in st.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("conv", "h"):
        np.testing.assert_allclose(gst[k].numpy(), np.asarray(wst[k]), **TOL)


def test_rglru_decode_chain_matches_reference_and_forward():
    rcfg, rp, cfg, p = _block()
    x = _n(2, 12, cfg.d_model, seed=5)
    W, d = cfg.conv_width, cfg.d_model
    rst = {"conv": jnp.zeros((2, W - 1, d)), "h": jnp.zeros((2, d))}
    st = {"conv": torch.zeros((2, W - 1, d)), "h": torch.zeros((2, d))}
    outs = []
    for t in range(12):
        want, rst = RR.rglru_decode(rp, rcfg, jnp.asarray(x[:, t:t + 1]),
                                    rst)
        got, st = PR.rglru_decode(p, cfg, torch.from_numpy(x[:, t:t + 1]),
                                  st)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        outs.append(got)
    # one step at a time against the doubling scan's tree: the adds
    # differ in order, so near-zero outputs differ by f32 noise (atol)
    full, fst = PR.rglru_forward(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(st["h"].numpy(), fst["h"].numpy(),
                               rtol=1e-5, atol=1e-5)
    # a one-row matmul and a 12-row one round apart (BLAS blocking)
    np.testing.assert_allclose(st["conv"].numpy(), fst["conv"].numpy(),
                               **TOL)
