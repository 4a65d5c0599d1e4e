"""Port parity: the encoder-decoder path (``whisper-tiny``'s smoke
config).

The reference's parameters are carried across with ``convert.params``
(the stacked ``encoder`` leaves, ``enc_norm``, each decoder layer's
``norm_x`` and ``xattn``), and the same numpy-seeded tokens and frame
embeddings (the stub frontend's input) go through both packages, to rel
1e-5 (max abs difference over max abs value):

- ``encode``: the non-causal encoder stack and ``enc_norm``;
- ``forward(enc_frames=)`` on the "kernel" (cross-attention reaching the
  kernel's plain version with ``causal=False`` and Tq != Tk), "ref" and
  "blocked" routes;
- ``init_cache`` with the precomputed cross keys and values, and
  ``convert.cache`` of the reference's ``cache["cross"]``;
- 12 ``decode_step`` calls against the reference's, and decode resumed
  from a converted mid-run cache; decode against ``forward`` (the
  reference's own check, rel < 2e-2);
- what needs the frames raises without them, and ``ModelServer``
  refuses an encoder-decoder.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import ref as port_cache  # noqa: E402

ARCH = "whisper-tiny"
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@functools.lru_cache(maxsize=None)
def _models(impl="ref"):
    rcfg = dataclasses.replace(ref_smoke(ARCH), attention_impl=impl)
    rparams = RT.init_params(jax.random.PRNGKey(0), rcfg)
    cfg = convert.model_config(rcfg)
    return rcfg, rparams, cfg, convert.params(rparams, cfg, device="cpu")


def _inputs(cfg, B=2, S=16, Se=12, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, Se, cfg.d_model)).astype(np.float32)
    return tokens, frames


def test_encode_matches_reference():
    rcfg, rparams, cfg, params = _models()
    _, frames = _inputs(cfg)
    want = RT.encode(rparams, rcfg, jnp.asarray(frames))
    got = T.encode(params, cfg, torch.from_numpy(frames))
    assert got.shape == (2, 12, cfg.d_model)
    assert rel_err(got, want) <= REL


@pytest.mark.parametrize("impl", ["interpret", "ref", "blocked"])
def test_forward_with_frames_matches_reference(impl):
    rcfg, rparams, cfg, params = _models(impl)
    tokens, frames = _inputs(cfg, seed=1)
    want, _ = RT.forward(rparams, rcfg, jnp.asarray(tokens),
                         enc_frames=jnp.asarray(frames))
    got, aux = T.forward(params, cfg, torch.from_numpy(tokens),
                         enc_frames=torch.from_numpy(frames))
    assert float(aux) == 0.0
    assert rel_err(got, want) <= REL


def _caches(rcfg, rparams, cfg, params, frames, max_len=16):
    rcache = RT.init_cache(rcfg, 2, max_len, params=rparams,
                           enc_frames=jnp.asarray(frames))
    cache = T.init_cache(cfg, 2, max_len, device="cpu", params=params,
                         enc_frames=torch.from_numpy(frames))
    return rcache, cache


def test_init_cache_holds_the_cross_kv():
    rcfg, rparams, cfg, params = _models()
    _, frames = _inputs(cfg, seed=2)
    rcache, cache = _caches(rcfg, rparams, cfg, params, frames)
    want = convert.cache(jax.tree.map(np.asarray, rcache), cfg,
                         device="cpu")
    assert len(cache) == cfg.n_layers
    for got_l, want_l in zip(cache, want):
        assert set(got_l) == set(want_l) == {"k", "v", "len", "cross_k",
                                             "cross_v"}
        for key in T.CROSS_KEYS:
            assert got_l[key].shape == (2, cfg.n_kv_heads, 12, cfg.head_dim)
            assert rel_err(got_l[key], want_l[key]) <= REL


def _decode_both(rcfg, rparams, cfg, params, tokens, rcache, cache):
    step = jax.jit(lambda p, t, c: RT.decode_step(p, rcfg, t, c))
    worst = 0.0
    for t in range(tokens.shape[1]):
        want, rcache = step(rparams, jnp.asarray(tokens[:, t:t + 1]), rcache)
        got, cache = T.decode_step(params, cfg,
                                   torch.from_numpy(tokens[:, t:t + 1]),
                                   cache)
        worst = max(worst, rel_err(got, want))
    return worst, rcache, cache


def _check_cache(cache, rcache, cfg):
    want = convert.cache(jax.tree.map(np.asarray, rcache), cfg, device="cpu")
    for got_l, want_l in zip(cache, want):
        assert set(got_l) == set(want_l)
        for name, w in want_l.items():
            if name == "len":
                assert torch.equal(got_l[name], w)
            else:
                assert rel_err(got_l[name], w) <= REL, name


def test_decode_matches_reference():
    rcfg, rparams, cfg, params = _models()
    tokens, frames = _inputs(cfg, S=12, seed=3)
    rcache, cache = _caches(rcfg, rparams, cfg, params, frames)
    worst, rcache, cache = _decode_both(rcfg, rparams, cfg, params, tokens,
                                        rcache, cache)
    assert worst <= REL
    _check_cache(cache, rcache, cfg)


def test_decode_resumes_from_converted_cross_cache():
    rcfg, rparams, cfg, params = _models()
    tokens, frames = _inputs(cfg, S=12, seed=4)
    rcache, _ = _caches(rcfg, rparams, cfg, params, frames)
    step = jax.jit(lambda p, t, c: RT.decode_step(p, rcfg, t, c))
    for t in range(6):
        _, rcache = step(rparams, jnp.asarray(tokens[:, t:t + 1]), rcache)
    cache = convert.cache(jax.tree.map(np.asarray, rcache), cfg,
                          device="cpu")
    worst, rcache, cache = _decode_both(rcfg, rparams, cfg, params,
                                        tokens[:, 6:], rcache, cache)
    assert worst <= REL
    _check_cache(cache, rcache, cfg)


def test_decode_matches_forward():
    """The reference's own consistency check, in the port."""
    _, _, cfg, params = _models()
    tokens, frames = _inputs(cfg, S=16, seed=5)
    full, _ = T.forward(params, cfg, torch.from_numpy(tokens),
                        enc_frames=torch.from_numpy(frames))
    cache = T.init_cache(cfg, 2, 16, device="cpu", params=params,
                         enc_frames=torch.from_numpy(frames))
    outs = []
    for t in range(16):
        lg, cache = T.decode_step(params, cfg,
                                  torch.from_numpy(tokens[:, t:t + 1]), cache)
        outs.append(lg[:, 0])
    assert rel_err(torch.stack(outs, 1), full.numpy()) < 2e-2


def test_frames_are_required_and_the_server_refuses():
    _, _, cfg, params = _models()
    tokens, _ = _inputs(cfg)
    with pytest.raises(ValueError, match="enc_frames"):
        T.forward(params, cfg, torch.from_numpy(tokens))
    with pytest.raises(ValueError, match="enc_frames"):
        T.init_cache(cfg, 2, 16, device="cpu")
    ata = port_cache.AtaPrefixCache(port_cache.AtaCacheConfig(n_shards=1))
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve.ModelServer(cfg, params, ata, 0, device="cpu")
