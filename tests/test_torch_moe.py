"""Port parity: the MoE block (``models/moe.py``).

The reference's MoE parameters (``moe_init``) are copied into the port's
module, and the same numpy-seeded activations go through both:

- ``moe_forward`` (grouped, capacity-bounded dispatch) at capacity
  factors 1.25 and 0.5, one group and two groups of ``GROUP_SIZE``:
  outputs within rtol 1e-5 + atol 1e-6 (f32 einsums in another order),
  the aux loss within rel 1e-6, and the kept/dropped (token, choice)
  mask equal to the reference's (computed with the reference's
  routing steps, ``src/repro/models/moe.py:76-95``);
- ``moe_dense_forward`` (decode's exact top-k), to the same tolerance;
- decode against forward at capacity factor 8.0, the reference's own
  check (rel < 2e-2), for both MoE configs' smoke models (granite-1b's 4
  experts and granite-3b's 5; the full granite-3b has 40).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCHS = ("granite-moe-1b-a400m", "granite-moe-3b-a800m")
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moe(arch, **over):
    rcfg = dataclasses.replace(ref_smoke(arch), **over)
    rp = RM.moe_init(jax.random.PRNGKey(3), rcfg)
    cfg = convert.model_config(rcfg)
    p = PM.MoE(cfg, device="cpu")
    for name, t in p.named_parameters():
        leaf = rp
        for part in name.split("."):
            leaf = leaf[part]
        t.data.copy_(torch.from_numpy(np.array(leaf)))
    return rcfg, rp, cfg, p


def _x(B, T, d, seed=0):
    return np.random.default_rng(seed).standard_normal((B, T, d)).astype(
        np.float32)


def _ref_keep(rp, rcfg, x):
    """The reference's kept (token, choice) pairs, by its own routing
    steps (moe.py:76-95): top-k of the f32 router's softmax, slots by a
    cumsum over the flattened (S * k) axis."""
    E, k = rcfg.n_experts, rcfg.moe_top_k
    n = x.shape[0] * x.shape[1]
    S = min(RM.GROUP_SIZE, n)
    G = n // S
    xt = jnp.asarray(x).reshape(G, S, -1)
    probs = jax.nn.softmax(xt @ rp["router"]["kernel"], axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    capacity = max(int(rcfg.capacity_factor * S * k / E), 4)
    sel = jax.nn.one_hot(idx, E, dtype=jnp.int32)
    flat = sel.reshape(G, S * k, E)
    pos = ((jnp.cumsum(flat, axis=1) - flat).reshape(G, S, k, E)
           * sel).sum(-1)
    return np.asarray(pos < capacity)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("B,T_", [(2, 24), (2, 256)])
def test_moe_forward_matches_reference(arch, cf, B, T_):
    rcfg, rp, cfg, p = _moe(arch, capacity_factor=cf)
    x = _x(B, T_, cfg.d_model, seed=T_)
    want, waux = RM.moe_forward(rp, rcfg, jnp.asarray(x))
    got, aux = PM.moe_forward(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert abs(float(aux) - float(waux)) <= 1e-6 * abs(float(waux))
    # the same (token, choice) pairs keep their slots
    S = min(PM.GROUP_SIZE, B * T_)
    xt = torch.from_numpy(x).reshape(-1, S, cfg.d_model)
    _, _, idx = PM._route(p, cfg, xt)
    _, _, keep, _ = PM.dispatch(cfg, idx, S)
    want_keep = _ref_keep(rp, rcfg, x)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if cf == 0.5:
        assert not want_keep.all()      # the check sees dropped tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_forward_matches_reference(arch):
    rcfg, rp, cfg, p = _moe(arch)
    x = _x(3, 5, cfg.d_model, seed=1)
    want, _ = RM.moe_dense_forward(rp, rcfg, jnp.asarray(x))
    got, aux = PM.moe_dense_forward(p, cfg, torch.from_numpy(x))
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_router_stays_f32_under_cast_for_compute():
    """The router sees f32 activations and its f32 kernel after the
    served model's casts: top-k picks the experts the f32 model picks."""
    cfg = dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"),
                              dtype="bfloat16")
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    served = T.cast_for_compute(params, cfg)
    for a, b in zip(params.layers, served.layers):
        assert b.moe.router.kernel is a.moe.router.kernel
        assert b.moe.router.kernel.dtype == torch.float32
        assert b.moe.wi.kernel.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_matches_forward_high_capacity(arch):
    """The reference's own check (tests/test_models.py): decode (exact
    top-k) against forward (capacity-bounded) at capacity factor 8."""
    cfg = dataclasses.replace(get_smoke_config(arch), capacity_factor=8.0)
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(1),
                           device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16)))
    full, aux = T.forward(params, cfg, tokens)
    assert float(aux) > 0.0
    cache = T.init_cache(cfg, 2, 16, device="cpu")
    outs = []
    for t in range(16):
        lg, cache = T.decode_step(params, cfg, tokens[:, t:t + 1], cache)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, 1)
    assert float((dec - full).abs().max() / full.abs().max()) < 2e-2
