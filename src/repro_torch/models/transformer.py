"""Model assembly: block zoo -> layer stack -> LM / enc-dec.

The port of the reference's ``models/transformer.py``.
Parameters are one :class:`Transformer` module whose parameter names
carry the reference's leaf names (``embed.table``, ``lm_head.kernel``,
``layers.<i>.attn.wq.kernel``, ``layers.<i>.rwkv.u``,
``layers.<i>.moe.wi.kernel``, ``layers.<i>.rglru.lam``,
``layers.<i>.xattn.wq.kernel``, ``encoder.<i>.attn.wq.kernel``, ...).
``layers`` holds the decoder blocks in the order they run: the reference
stacks them by pattern period and runs a period's blocks in
``sorted(name)`` order, then the remainder layers, and :func:`layer_keys`
names each layer's place there (``repro_torch.convert.params`` maps one
onto the other). ``encoder`` holds an encoder-decoder's encoder blocks.
A Python loop over layers takes the place of ``lax.scan``. With
``cfg.remat == "layer"``, a forward that gradients will flow through
(grad mode on, the blocks' parameters requiring grad: training) runs each
pattern period, as the reference scans them, under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): its
activations are recomputed in backward, not kept. The numbers are the
same either way; inference runs the plain loop.

Public API:
  init_params(cfg, generator=..., device=...)   -> Transformer
  cast_for_compute(params, cfg)                  -> Transformer (serving)
  encode(params, cfg, enc_frames)                -> encoder output
  forward(params, cfg, tokens, enc_frames=None)  -> (logits, aux)
  init_cache(cfg, batch, max_len, device=..., params=, enc_frames=)
                                                 -> decode cache
  decode_step(params, cfg, tokens, cache)        -> (logits, new cache)

The cache is a list with one dict per decoder layer, in run order;
decode_step returns a new list and leaves the one it was given as it
was. An encoder-decoder's cache also holds each stacked layer's
precomputed cross-attention keys and values (``cross_k``/``cross_v``,
(B, KV, Se, hd)), as the reference's ``cache["cross"]``.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.simulator import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, recurrent
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import annotate, place_new

Cache = List[Dict[str, torch.Tensor]]


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // 128) * 128


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a block kind the model does not know."""
    unknown = set(cfg.blocks) - {"attn", "local_attn", "rwkv6", "rglru"}
    if unknown:
        raise ValueError(f"{cfg.name}: unknown block kinds {sorted(unknown)}")


def _pattern_layout(cfg: ModelConfig):
    """(period_kinds, n_periods, remainder_kinds)."""
    pat = tuple(cfg.block_pattern)
    n, per = cfg.n_layers, len(pat)
    return pat, n // per, tuple(pat[i] for i in range(n % per))


def layer_keys(cfg: ModelConfig) -> List[Tuple[str, str, Optional[int]]]:
    """Each layer's place in the reference's parameter tree, in run
    order: ("layers", "p<j>_<kind>", period) for the stacked periods,
    ("layers_rem", "r<i>_<kind>", None) for the remainder."""
    pat, n_per, rem = _pattern_layout(cfg)
    names = sorted(f"p{j}_{kind}" for j, kind in enumerate(pat))
    keys = [("layers", name, g) for g in range(n_per) for name in names]
    keys += [("layers_rem", name, None)
             for name in sorted(f"r{i}_{k}" for i, k in enumerate(rem))]
    return keys


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        kw = dict(dtype=layers.dtype_of(cfg.param_dtype),
                  generator=generator, device=device)
        self.wi = layers.Dense(d, f, **kw)
        self.wo = layers.Dense(f, d, **kw)
        self.wg = (layers.Dense(d, f, **kw)
                   if cfg.activation.endswith("_glu") else None)


class Block(nn.Module):
    """One layer: ``norm1``, the mixer (``attn``, ``rwkv`` or ``rglru``),
    with ``cross`` ``norm_x`` and ``xattn``, ``norm2`` and the feed-forward
    (``moe`` or ``mlp``); ``kind`` is the reference's block kind."""

    def __init__(self, cfg: ModelConfig, kind: str, *, cross: bool = False,
                 generator=None, device=None):
        super().__init__()
        self.kind = kind
        dt = layers.dtype_of(cfg.param_dtype)
        kw = dict(generator=generator, device=device)
        self.norm1 = layers.RMSNorm(cfg.d_model, dt, device)
        self.norm2 = layers.RMSNorm(cfg.d_model, dt, device)
        if kind in ("attn", "local_attn"):
            self.attn = attn.Attention(cfg, **kw)
        elif kind == "rwkv6":
            self.rwkv = recurrent.RWKV6(cfg, **kw)
        elif kind == "rglru":
            self.rglru = recurrent.RGLRU(cfg, **kw)
        self.norm_x = layers.RMSNorm(cfg.d_model, dt, device) if cross \
            else None
        self.xattn = attn.Attention(cfg, cross=True, **kw) if cross else None
        if cfg.is_moe:
            self.moe = moe.MoE(cfg, **kw)
        else:
            self.mlp = MLP(cfg, **kw)


class Embed(nn.Module):
    #: the gather and the tied output projection cast the table to the
    #: compute dtype
    compute_cast = ("table",)

    def __init__(self, V: int, d: int, dtype, *, generator=None,
                 device=None):
        super().__init__()
        self.table = layers.param(layers.truncated_normal(
            (V, d), 1.0, generator=generator, device=device, dtype=dtype))


class Transformer(nn.Module):
    """All parameters of an LM (decoder-only or encoder-decoder). With
    ``generator=None`` the weights are left uninitialised (to be filled by
    a converter)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        check_supported(cfg)
        dt = layers.dtype_of(cfg.param_dtype)
        kw = dict(generator=generator, device=device)
        V = padded_vocab(cfg)
        self.embed = Embed(V, cfg.d_model, dt, **kw)
        self.final_norm = layers.RMSNorm(cfg.d_model, dt, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else layers.Dense(cfg.d_model, V, dtype=dt, **kw))
        self.layers = nn.ModuleList(
            Block(cfg, name.split("_", 1)[1], cross=cfg.is_enc_dec, **kw)
            for _, name, _ in layer_keys(cfg))
        if cfg.is_enc_dec:
            self.encoder = nn.ModuleList(
                Block(cfg, "attn", **kw) for _ in range(cfg.encoder_layers))
            self.enc_norm = layers.RMSNorm(cfg.d_model, dt, device)


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device="cuda") -> Transformer:
    """Random weights drawn from ``generator``, which must live on
    ``device`` (the CUDA card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"weights go to {device}")
    return Transformer(cfg, generator=generator, device=device)


def cast_for_compute(params: Transformer, cfg: ModelConfig) -> Transformer:
    """The same model with the operands that each call casts to
    ``cfg.dtype`` stored in it once: the results are bit for bit those of
    ``params`` (the cast is the same rounding, made once at load instead
    of on every call), for a fraction of the launches and bytes a decode
    step spends on casts. Which leaves those are, each module declares
    beside the code that casts them (``compute_cast``); the others, used
    in f32, are shared, not copied.
    """
    dt = layers.dtype_of(cfg.dtype)
    memo = {id(p): p for p in params.parameters()}
    for mod in params.modules():
        for leaf in getattr(mod, "compute_cast", ()):
            p = getattr(mod, leaf)
            if p is not None and p.dtype != dt:
                memo[id(p)] = layers.param(p.detach().to(dt))
    # deepcopy copies the module tree and takes each parameter from memo
    return copy.deepcopy(params, memo)


def _device_of(params: Transformer) -> torch.device:
    return params.embed.table.device


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _mlp_forward(p: MLP, cfg: ModelConfig, x):
    h = annotate(layers.dense(p.wi, x), "batch", "seq", "mlp")
    if p.wg is not None:
        h = layers.activation(cfg.activation, h, layers.dense(p.wg, x))
    else:
        h = layers.activation(cfg.activation, h)
    return layers.dense(p.wo, h)


def _block_forward(p: Block, cfg: ModelConfig, x, *, positions,
                   causal=True, enc_out=None, kv_repeat=1):
    """Returns (x, aux): the block's output and its MoE aux loss."""
    h = layers.rmsnorm(p.norm1, x, cfg.norm_eps)
    # Megatron-SP transition: the boundary residual is sequence-sharded;
    # gather the sequence here (one all-gather) so head/expert sharding
    # inside the block never straddles a sequence-sharded tensor
    h = annotate(h, "batch", "seq", "embed")
    if p.kind == "rwkv6":
        a, _ = recurrent.rwkv6_forward(p.rwkv, cfg, h)
    elif p.kind == "rglru":
        a, _ = recurrent.rglru_forward(p.rglru, cfg, h)
    else:
        window = cfg.window if p.kind == "local_attn" else None
        a = attn.attention_forward(p.attn, cfg, h, positions=positions,
                                   causal=causal, window=window,
                                   kv_repeat=kv_repeat)
    # the block's output sequence-sharded before the residual add: the
    # tensor-parallel partial sum becomes a reduce-scatter
    a = annotate(a, "batch", "seq_boundary", "embed")
    x = x + a
    if p.xattn is not None:
        hx = layers.rmsnorm(p.norm_x, x, cfg.norm_eps)
        c = attn.attention_forward(p.xattn, cfg, hx, positions=None,
                                   kv_x=enc_out, causal=False, rope_on=False)
        # sequence-sharded before the residual add, as the mixer's output
        # (its gradient then reaches the projection whole along the
        # sequence, whose (B, T) flatten torch 2.11 needs)
        x = x + annotate(c, "batch", "seq_boundary", "embed")
    h2 = annotate(layers.rmsnorm(p.norm2, x, cfg.norm_eps),
                  "batch", "seq", "embed")
    if cfg.is_moe:
        m, aux = moe.moe_forward(p.moe, cfg, h2)
    else:
        m, aux = _mlp_forward(p.mlp, cfg, h2), None
    m = annotate(m, "batch", "seq_boundary", "embed")
    return annotate(x + m, "batch", "seq_boundary", "embed"), aux


def _run_blocks(blocks, cfg: ModelConfig, x, **kw):
    """x through ``blocks`` in order; returns (x, the summed aux loss)."""
    aux = torch.zeros((), device=x.device)
    for p in blocks:
        x, a = _block_forward(p, cfg, x, **kw)
        if a is not None:
            aux = aux + a
    return x, aux


def _run_stack(blocks, cfg: ModelConfig, x, *, period: int, n_stacked: int,
               **kw):
    """x through ``blocks``; returns (x, the summed aux loss). The first
    ``n_stacked`` blocks are the reference's scanned periods of
    ``period`` blocks each; under remat (see the module docstring) each
    period runs in ``torch.utils.checkpoint``, the rest as they are."""
    if not (cfg.remat == "layer" and torch.is_grad_enabled()
            and any(p.requires_grad for p in blocks.parameters())):
        return _run_blocks(blocks, cfg, x, **kw)
    aux = torch.zeros((), device=x.device)
    for i in range(0, n_stacked, period):
        x, a = checkpoint(_run_blocks, blocks[i:i + period], cfg, x,
                          use_reentrant=False, **kw)
        aux = aux + a
    x, a = _run_blocks(blocks[n_stacked:], cfg, x, **kw)
    return x, aux + a


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------
def embed_tokens(params: Transformer, cfg: ModelConfig, tokens):
    tokens = torch.as_tensor(tokens, device=_device_of(params)).long()
    # under tensor parallelism the gather runs on a whole table and whole
    # token ids: its backward (an index_put into the vocab-sharded
    # table's gradient, from batch-sharded ids) has no working rule in
    # torch 2.11 (no-ops outside a rules context)
    table = annotate(params.embed.table, None, None)
    x = table[annotate(tokens, None, None)].to(layers.dtype_of(cfg.dtype))
    return annotate(x, "batch", "seq_boundary", "embed")


def lm_logits(params: Transformer, cfg: ModelConfig, x):
    # under tensor parallelism the residual stream is sequence-sharded;
    # the head's flatten of (B, T) with T sharded has no rule in torch
    # 2.11: the sequence is gathered first (as the loss does)
    x = annotate(layers.rmsnorm(params.final_norm, x, cfg.norm_eps),
                 "batch", "seq", "embed")
    if params.lm_head is None:
        logits = x @ params.embed.table.to(x.dtype).T
    else:
        logits = layers.dense(params.lm_head, x)
    return annotate(logits, "batch", "seq", "vocab").float()


def encode(params: Transformer, cfg: ModelConfig, enc_frames):
    """The encoder over precomputed frame embeddings (B, Se, d) (the
    frontend is a stub, as in the reference): a non-causal stack, then
    ``enc_norm``."""
    x = torch.as_tensor(enc_frames, device=_device_of(params)).to(
        layers.dtype_of(cfg.dtype))
    pos = torch.arange(x.shape[1], device=x.device)
    x, _ = _run_stack(params.encoder, cfg, x, period=1,
                      n_stacked=len(params.encoder), positions=pos,
                      causal=False)
    # whole along the sequence: the cross keys and values project it
    return annotate(layers.rmsnorm(params.enc_norm, x, cfg.norm_eps),
                    "batch", "seq", "embed")


def _enc_out(params: Transformer, cfg: ModelConfig, enc_frames):
    if not cfg.is_enc_dec:
        return None
    if enc_frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                         "enc_frames")
    return encode(params, cfg, enc_frames)


def forward_hidden(params: Transformer, cfg: ModelConfig, tokens, *,
                   enc_frames=None):
    """Backbone only: final hidden states (pre final-norm), and the MoE
    aux loss (f32 scalar; zero without MoE)."""
    enc_out = _enc_out(params, cfg, enc_frames)
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    pat, n_per, _ = _pattern_layout(cfg)
    return _run_stack(params.layers, cfg, x, period=len(pat),
                      n_stacked=n_per * len(pat), positions=positions,
                      enc_out=enc_out, kv_repeat=cfg.kv_repeat)


def forward(params: Transformer, cfg: ModelConfig, tokens, *,
            enc_frames=None):
    """Prefill forward: tokens (B, T) -> (logits (B, T, V) f32, aux);
    an encoder-decoder also takes ``enc_frames`` (B, Se, d).

    Runs where ``params`` live (the card, as :func:`init_params` puts
    them by default)."""
    x, aux = forward_hidden(params, cfg, tokens, enc_frames=enc_frames)
    return lm_logits(params, cfg, x), aux


# ---------------------------------------------------------------------------
# decode (one token, O(1) per step given the cache)
# ---------------------------------------------------------------------------
def _block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 start_len: int, device) -> Dict[str, torch.Tensor]:
    dt = layers.dtype_of(cfg.dtype)
    if kind in ("attn", "local_attn"):
        size = max_len
        if kind == "local_attn" and cfg.window is not None:
            size = min(max_len, cfg.window)
        c = attn.init_kv_cache(cfg, batch, size, cfg.kv_repeat, dtype=dt,
                               device=device)
        c["len"].fill_(start_len)
        return c
    if kind == "rglru":
        return {"conv": place_new(torch.zeros(
                    (batch, cfg.conv_width - 1, cfg.d_model), dtype=dt,
                    device=device), *STATE_AXES["conv"]),
                "h": place_new(torch.zeros((batch, cfg.d_model), dtype=dt,
                                           device=device),
                               *STATE_AXES["h"])}
    K = cfg.rwkv_head_dim
    H = cfg.d_model // K
    return {"shift": place_new(torch.zeros((batch, cfg.d_model), dtype=dt,
                                           device=device),
                               *STATE_AXES["shift"]),
            "wkv": place_new(torch.zeros((batch, H, K, K), device=device),
                             *STATE_AXES["wkv"])}


#: the logical axes of the recurrent blocks' decode state (the
#: reference's cache patterns, ``launch/specs.py``); under a rules
#: context the leaves are DTensors placed by them
STATE_AXES = {"shift": ("batch", "embed"),
              "wkv": ("batch", "rheads", "rkey", "rvalue"),
              "conv": ("batch", None, "rnn"),
              "h": ("batch", "rnn")}


CROSS_KEYS = ("cross_k", "cross_v")


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               start_len: int = 0, device="cuda", params=None,
               enc_frames=None) -> Cache:
    """Decode cache: one dict per layer, in run order. An
    encoder-decoder needs ``params`` and ``enc_frames``: each stacked
    layer's cross-attention keys and values over the encoder's output are
    computed here once (the reference's ``cache["cross"]``; remainder
    layers get none, as there). Under a rules context every leaf is a
    DTensor, placed as the reference's cache shardings place it
    (:data:`~repro_torch.models.attention.CACHE_AXES`,
    :data:`STATE_AXES`)."""
    check_supported(cfg)
    device = resolve_device(device)
    keys = layer_keys(cfg)
    cache = [_block_cache(cfg, name.split("_", 1)[1], batch, max_len,
                          start_len, device) for _, name, _ in keys]
    if cfg.is_enc_dec:
        if params is None or enc_frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: "
                             "init_cache needs params and enc_frames")
        enc_out = encode(params, cfg, enc_frames)
        for (stack, _, _), p, c in zip(keys, params.layers, cache):
            if stack == "layers":
                for key, w in zip(CROSS_KEYS, (p.xattn.wk, p.xattn.wv)):
                    c[key] = annotate(layers.dense(w, enc_out).transpose(
                        1, 2), *attn.CACHE_AXES)
    return cache


def _block_decode(p: Block, cfg: ModelConfig, x, bcache):
    h = layers.rmsnorm(p.norm1, x, cfg.norm_eps)
    cross = {k: bcache[k] for k in CROSS_KEYS if k in bcache}
    if p.kind == "rwkv6":
        a, bcache = recurrent.rwkv6_decode(p.rwkv, cfg, h, bcache)
    elif p.kind == "rglru":
        a, bcache = recurrent.rglru_decode(p.rglru, cfg, h, bcache)
    else:
        window = cfg.window if p.kind == "local_attn" else None
        a, bcache = attn.attention_decode(p.attn, cfg, h, bcache,
                                          window=window,
                                          kv_repeat=cfg.kv_repeat)
    if p.kind in ("rwkv6", "rglru"):
        # the state keeps the cache's placements (the reference's
        # out_shardings)
        bcache = {k: annotate(t, *STATE_AXES[k]) for k, t in bcache.items()}
    x = x + a
    if p.xattn is not None and cross:
        hx = layers.rmsnorm(p.norm_x, x, cfg.norm_eps)
        x = x + attn.cross_attention_decode(p.xattn, cfg, hx,
                                            cross["cross_k"],
                                            cross["cross_v"])
        bcache = dict(bcache, **cross)
    h2 = layers.rmsnorm(p.norm2, x, cfg.norm_eps)
    if cfg.is_moe:
        m, _ = moe.moe_dense_forward(p.moe, cfg, h2)
    else:
        m = _mlp_forward(p.mlp, cfg, h2)
    return x + m, bcache


def decode_step(params: Transformer, cfg: ModelConfig, tokens, cache: Cache
                ) -> Tuple[torch.Tensor, Cache]:
    """tokens (B, 1) -> (logits (B, 1, V) f32, updated cache)."""
    x = embed_tokens(params, cfg, tokens)
    new_cache = []
    for p, c in zip(params.layers, cache, strict=True):
        x, c = _block_decode(p, cfg, x, c)
        new_cache.append(c)
    return lm_logits(params, cfg, x), new_cache
