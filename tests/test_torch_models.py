"""Port parity: the LM substrate's inference path.

For the smoke configs of all ten architectures (dense, MoE, RWKV6,
RG-LRU hybrid, encoder-decoder), the reference's parameters are carried
across with ``convert.params`` and the same tokens (and, for
``whisper-tiny``, frame embeddings) go through both packages:

- prefill ``forward`` logits, the reference at "interpret" (its Pallas
  kernels) against the port's "kernel" route (the kernels' plain
  versions on the CPU), and "ref"/"blocked" against the same route, to
  rel 1e-5 (max abs difference over max abs logit);
- 20 ``decode_step`` calls, logits and caches, and decode resumed from a
  mid-run cache carried over with ``convert.cache``;
- an int8-KV variant, a ``local_attn`` (ring-buffer) variant and a long
  mixed block pattern (the reference runs a period's blocks in
  ``sorted(name)`` order) of the qwen3 smoke config;
- decode against ``forward``, the reference's own check (rel < 2e-2;
  MoE at capacity factor 8, where prefill drops no token);
- the ``layers`` functions, the configs (``ARCH_IDS`` in the
  reference's order, every value, ``paper_gpu`` and ``shapes``), and
  ``convert.params``' leaf accounting.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCHS = configs.ARCH_IDS
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
def _ref_model(arch, over=()):
    rcfg = dataclasses.replace(ref_smoke(arch), **dict(over))
    return rcfg, RT.init_params(jax.random.PRNGKey(0), rcfg)


def _port_model(arch, over=()):
    rcfg, rparams = _ref_model(arch, over)
    cfg = convert.model_config(rcfg)
    return cfg, convert.params(rparams, cfg, device="cpu")


def _tokens(cfg, B=2, S=32, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _frames(cfg, B=2, Se=12, seed=7):
    """The encoder's frame embeddings of an encoder-decoder (the stub
    frontend's input) as (jax kwargs, torch kwargs); empty otherwise."""
    if not cfg.is_enc_dec:
        return {}, {}
    f = np.random.default_rng(seed).standard_normal(
        (B, Se, cfg.d_model)).astype(np.float32)
    return {"enc_frames": jnp.asarray(f)}, {"enc_frames": torch.from_numpy(f)}


def _init_caches(rcfg, rparams, cfg, params, B, max_len):
    """Empty decode caches of both packages (an encoder-decoder's with
    its cross keys and values)."""
    jkw, tkw = _frames(cfg, B)
    if cfg.is_enc_dec:
        jkw["params"], tkw["params"] = rparams, params
    return (RT.init_cache(rcfg, B, max_len, **jkw),
            T.init_cache(cfg, B, max_len, device="cpu", **tkw))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["interpret", "ref", "blocked"])
def test_forward_matches_reference(arch, impl):
    rcfg, rparams = _ref_model(arch)
    rcfg = dataclasses.replace(rcfg, attention_impl=impl)
    cfg = convert.model_config(rcfg)
    assert cfg.attention_impl == ("kernel" if impl == "interpret" else impl)
    params = convert.params(rparams, cfg, device="cpu")
    tokens = _tokens(cfg)
    jkw, tkw = _frames(cfg)
    want, waux = RT.forward(rparams, rcfg, jnp.asarray(tokens), **jkw)
    got, aux = T.forward(params, cfg, torch.from_numpy(tokens), **tkw)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    assert abs(float(aux) - float(waux)) <= REL * abs(float(waux))
    assert float(aux) == 0.0 or cfg.is_moe
    assert got.shape == (2, 32, T.padded_vocab(cfg))
    assert rel_err(got, want) <= REL


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
    assert len(cache) == len(want) == cfg.n_layers
    for got_l, want_l in zip(cache, want):
        assert set(got_l) == set(want_l)
        for name, w in want_l.items():
            g = got_l[name]
            assert g.dtype == w.dtype and g.shape == w.shape, name
            if name == "len":
                assert torch.equal(g, w)
            elif w.dtype == torch.int8:     # quantized: a rounding flip
                assert (g.int() - w.int()).abs().max() <= 1, name
            else:
                assert rel_err(g, w) <= REL, name


@pytest.mark.parametrize("arch,over", [
    *((a, ()) for a in ARCHS),
    ("rwkv6-3b", (("attention_impl", "interpret"),)),
    ("qwen3-0.6b", (("kv_cache_dtype", "int8"),)),
    ("qwen3-0.6b", (("block_pattern", ("local_attn",)), ("window", 8))),
])
def test_decode_matches_reference(arch, over):
    """20 steps from an empty cache: logits each step, then the caches
    (a local_attn ring of 8 wraps twice)."""
    rcfg, rparams = _ref_model(arch, over)
    cfg, params = _port_model(arch, over)
    tokens = _tokens(cfg, S=20, seed=1)
    worst, rcache, cache = _decode_both(
        rcfg, rparams, cfg, params, tokens,
        *_init_caches(rcfg, rparams, cfg, params, 2, 24))
    assert worst <= REL
    _check_cache(cache, rcache, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_resumes_from_converted_cache(arch):
    rcfg, rparams = _ref_model(arch)
    cfg, params = _port_model(arch)
    tokens = _tokens(cfg, S=16, seed=2)
    step = jax.jit(lambda p, t, c: RT.decode_step(p, rcfg, t, c))
    rcache, _ = _init_caches(rcfg, rparams, cfg, params, 2, 16)
    for t in range(8):
        _, rcache = step(rparams, jnp.asarray(tokens[:, t:t + 1]), rcache)
    cache = convert.cache(jax.tree.map(np.asarray, rcache), cfg,
                          device="cpu")
    worst, rcache, cache = _decode_both(rcfg, rparams, cfg, params,
                                        tokens[:, 8:], rcache, cache)
    assert worst <= REL
    _check_cache(cache, rcache, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The reference's own consistency check, in the port; MoE at
    capacity factor 8, as the reference's own MoE check (prefill's
    capacity drops no token there; decode has none)."""
    over = (("capacity_factor", 8.0),) if "moe" in arch else ()
    rcfg, rparams = _ref_model(arch, over)
    cfg, params = _port_model(arch, over)
    tokens = torch.from_numpy(_tokens(cfg, S=20, seed=3))
    _, tkw = _frames(cfg)
    full, _ = T.forward(params, cfg, tokens, **tkw)
    _, cache = _init_caches(rcfg, rparams, cfg, params, 2, 20)
    outs = []
    for t in range(20):
        lg, cache = T.decode_step(params, cfg, tokens[:, t:t + 1], cache)
        outs.append(lg[:, 0])
    assert rel_err(torch.stack(outs, 1), full.numpy()) < 2e-2


def test_period_order_of_a_long_pattern():
    """An 11-block pattern runs its blocks in sorted(name) order
    (p0, p10, p1, p2, ...), then a remainder layer."""
    pat = tuple("attn" if j % 2 else "local_attn" for j in range(11))
    over = (("block_pattern", pat), ("window", 6), ("n_layers", 12),
            ("attention_impl", "ref"))
    rcfg, rparams = _ref_model("qwen3-0.6b", over)
    cfg, params = _port_model("qwen3-0.6b", over)
    keys = T.layer_keys(cfg)
    assert [n for _, n, _ in keys[:4]] == ["p0_local_attn", "p10_local_attn",
                                           "p1_attn", "p2_local_attn"]
    assert keys[-1] == ("layers_rem", "r0_local_attn", None)
    tokens = _tokens(cfg, S=16)
    want, _ = RT.forward(rparams, rcfg, jnp.asarray(tokens))
    got, _ = T.forward(params, cfg, torch.from_numpy(tokens))
    assert rel_err(got, want) <= REL


def test_bf16_forward_within_reference_bf16_tolerance():
    over = (("dtype", "bfloat16"), ("attention_impl", "interpret"))
    rcfg, rparams = _ref_model("qwen3-0.6b", over)
    cfg, params = _port_model("qwen3-0.6b", over)
    tokens = _tokens(cfg)
    want, _ = RT.forward(rparams, rcfg, jnp.asarray(tokens))
    got, _ = T.forward(params, cfg, torch.from_numpy(tokens))
    assert rel_err(got, want) <= 5e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_cast_for_compute_is_bit_identical(arch):
    """Casting the matmul operands to bf16 once at load gives the logits
    of the per-call cast, bit for bit, and shares the f32 parameters."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="bfloat16")
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    served = T.cast_for_compute(params, cfg)
    for (name, p), q in zip(params.named_parameters(), served.parameters()):
        leaf = name.rsplit(".", 1)[-1]
        if (leaf in ("scale", "u", "w_base", "ln_scale", "ln_bias", "lam")
                or ".router." in name):
            assert q is p, name
        else:
            assert q.dtype == torch.bfloat16, name
    tokens = torch.from_numpy(_tokens(cfg, S=16))
    _, tkw = _frames(cfg)
    assert torch.equal(T.forward(served, cfg, tokens, **tkw)[0],
                       T.forward(params, cfg, tokens, **tkw)[0])
    caches = [T.init_cache(cfg, 2, 16, device="cpu",
                           **(dict(tkw, params=m) if cfg.is_enc_dec else {}))
              for m in (served, params)]
    for t in range(4):
        tok = tokens[:, t:t + 1]
        a, caches[0] = T.decode_step(served, cfg, tok, caches[0])
        b, caches[1] = T.decode_step(params, cfg, tok, caches[1])
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("name", ["silu_glu", "gelu_glu", "gelu",
                                  "sq_relu"])
def test_activation_matches_reference(name):
    x, g = _x(4, 16), _x(4, 16, seed=1)
    want = RL.activation(name, jnp.asarray(x), jnp.asarray(g))
    got = PL.activation(name, torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_norms_rope_dense_match_reference():
    x = _x(2, 5, 3, 16)
    scale = _x(16, seed=2)
    p = PL.RMSNorm(16)
    p.scale.data.copy_(torch.from_numpy(scale))
    np.testing.assert_allclose(
        PL.rmsnorm(p, torch.from_numpy(x), 1e-6).numpy(),
        np.asarray(RL.rmsnorm({"scale": jnp.asarray(scale)},
                              jnp.asarray(x), 1e-6)), rtol=1e-6, atol=1e-6)
    xs, b = _x(2, 5, 48, seed=3), _x(48, seed=4)
    s48 = _x(48, seed=5)
    np.testing.assert_allclose(
        PL.groupnorm(torch.from_numpy(s48), torch.from_numpy(b),
                     torch.from_numpy(xs), 3).numpy(),
        np.asarray(RL.groupnorm(jnp.asarray(s48), jnp.asarray(b),
                                jnp.asarray(xs), 3)), rtol=1e-5, atol=1e-5)
    pos = np.asarray([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]], np.int32)
    np.testing.assert_allclose(
        PL.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(RL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=1e-5)
    d = PL.Dense(16, (3, 4), bias=True)
    kern, bias = _x(16, 3, 4, seed=6), _x(3, 4, seed=7)
    d.kernel.data.copy_(torch.from_numpy(kern))
    d.bias.data.copy_(torch.from_numpy(bias))
    np.testing.assert_allclose(
        PL.dense(d, torch.from_numpy(x)).numpy(),
        np.asarray(RL.dense({"kernel": jnp.asarray(kern),
                             "bias": jnp.asarray(bias)}, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


def test_truncated_normal_draws_within_two_stddevs():
    g = torch.Generator().manual_seed(0)
    t = PL.truncated_normal((4096,), 0.5, generator=g, device="cpu")
    assert float(t.abs().max()) <= 1.0 and 0.3 < float(t.std()) < 0.5


# ---------------------------------------------------------------------------
# configs and conversion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copy_the_reference_value_for_value(arch):
    for port, ref in ((configs.get_config(arch), ref_config(arch)),
                      (configs.get_smoke_config(arch), ref_smoke(arch))):
        for f in dataclasses.fields(port):
            if f.name != "attention_impl":
                assert getattr(port, f.name) == getattr(ref, f.name), f.name
        assert port.attention_impl == "kernel"
        assert port.param_count() == ref.param_count()
        assert port.blocks == ref.blocks
        assert port.sub_quadratic == ref.sub_quadratic


def test_arch_ids_and_the_other_config_modules_copy_the_reference():
    from repro.configs import paper_gpu as ref_paper
    from repro.configs import shapes as ref_shapes
    from repro_torch.configs import paper_gpu, shapes
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert list(configs.all_configs()) == list(ref_configs.all_configs())
    assert dataclasses.asdict(paper_gpu.CONFIG) == dataclasses.asdict(
        ref_paper.CONFIG)
    assert ({k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()}
            == {k: dataclasses.asdict(v)
                for k, v in ref_shapes.SHAPES.items()})
    for arch in ARCHS:
        for name, spec in shapes.SHAPES.items():
            assert (shapes.applicable(configs.get_config(arch), spec)
                    == ref_shapes.applicable(ref_config(arch),
                                             ref_shapes.SHAPES[name]))
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("llama")
    with pytest.raises(ValueError, match="unknown block kinds"):
        T.Transformer(dataclasses.replace(configs.get_smoke_config(
            "qwen3-0.6b"), block_pattern=("mamba",)))


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_params_consumes_every_leaf(arch):
    rcfg, rparams = _ref_model(arch)
    cfg, params = _port_model(arch)
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(rparams))
    assert sum(p.numel() for p in params.parameters()) == n_ref
    fresh = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    assert ({k: v.shape for k, v in fresh.named_parameters()}
            == {k: v.shape for k, v in params.named_parameters()})
    extra = dict(rparams, extra={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="extra.kernel"):
        convert.params(extra, cfg, device="cpu")
    short = dict(rparams)
    del short["final_norm"]
    with pytest.raises(KeyError, match="final_norm.scale"):
        convert.params(short, cfg, device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    cfg = configs.get_smoke_config("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_params(cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_cache(cfg, 1, 8)
    with pytest.raises(ValueError, match="generator"):
        T.init_params(cfg, generator=torch.Generator(), device="meta")
