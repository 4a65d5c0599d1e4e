"""GQA attention: parameters, prefill forward, decode step, KV cache.

The port of the reference's ``models/attention.py``. Routes
(``cfg.attention_impl``):

  - "kernel": the flash-attention kernel through ``ops.attention``
    (the Hopper kernel on CUDA tensors, its plain version on CPU ones);
  - "blocked": online-softmax over (q-chunk, kv-chunk) tiles in plain
    PyTorch;
  - "ref": plain einsum attention.

Decode never reaches the kernel, as in the reference: one query row
against the cache is a plain einsum softmax. The cache is rewritten out
of place each step, as the reference's ``jnp.where`` does, so a cache a
caller holds never changes under it. Cross-attention (the
encoder-decoder's) is :func:`attention_forward` with ``kv_x`` (the
encoder's output), ``causal=False`` and ``rope_on=False``, on parameters
made with ``cross=True`` (no qk-norm). The reference's sharding
annotations (:func:`repro_torch.sharding.annotate`) sit where the
reference's do; outside a rules context they return their input.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import annotate, place_new

NEG_INF = -1e30


class Attention(nn.Module):
    """Parameters ``wq``, ``wk``, ``wv`` (Dense), ``wo.kernel`` (H, hd, d)
    and, with ``qk_norm`` and not ``cross``, ``q_norm``/``k_norm``
    (RMSNorm over hd)."""

    def __init__(self, cfg: ModelConfig, *, cross: bool = False,
                 generator=None, device=None):
        super().__init__()
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = layers.dtype_of(cfg.param_dtype)
        kw = dict(dtype=dt, generator=generator, device=device)
        self.wq = layers.Dense(d, (H, hd), bias=cfg.qkv_bias, **kw)
        self.wk = layers.Dense(d, (KV, hd), bias=cfg.qkv_bias, **kw)
        self.wv = layers.Dense(d, (KV, hd), bias=cfg.qkv_bias, **kw)
        self.wo = layers.Dense(H, (hd, d), stddev=(H * hd) ** -0.5, **kw)
        self.qk_norm = cfg.qk_norm and not cross
        if self.qk_norm:
            self.q_norm = layers.RMSNorm(hd, dt, device)
            self.k_norm = layers.RMSNorm(hd, dt, device)


def _project_qkv(p: Attention, cfg: ModelConfig, x, kv_x=None, *,
                 positions=None, rope_on: bool = True, kv_repeat: int = 1):
    # whole along the sequence (the cross-attention's inputs come from a
    # sequence-sharded residual stream, whose (B, T) flatten in the
    # projections has no rule in torch 2.11)
    x = annotate(x, "batch", "seq", "embed")
    kv_x = x if kv_x is None else annotate(kv_x, "batch", "seq", "embed")
    q = layers.dense(p.wq, x)                         # (B,T,H,hd)
    k = layers.dense(p.wk, kv_x)                      # (B,Tk,KV,hd)
    v = layers.dense(p.wv, kv_x)
    if p.qk_norm:
        q = layers.rmsnorm(p.q_norm, q, cfg.norm_eps)
        k = layers.rmsnorm(p.k_norm, k, cfg.norm_eps)
    if rope_on and positions is not None:
        half = cfg.head_dim // 2
        cos, sin = layers.rope_angles(positions, half, cfg.rope_theta,
                                      x.device)
        q = layers.apply_rope(q, cos, sin)
        if k.shape[1] != q.shape[1]:      # keys at their own positions
            cos, sin = layers.rope_angles(
                torch.arange(k.shape[1], device=x.device), half,
                cfg.rope_theta, x.device)
        k = layers.apply_rope(k, cos, sin)
    if kv_repeat > 1:
        k = k.repeat_interleave(kv_repeat, dim=2)
        v = v.repeat_interleave(kv_repeat, dim=2)
    q = annotate(q, "batch", "seq", "heads", "head_dim")
    k = annotate(k, "batch", "seq", "kv_heads_act", "head_dim")
    v = annotate(v, "batch", "seq", "kv_heads_act", "head_dim")
    return q, k, v


def _out_proj(p: Attention, o):
    """o (B, T, H, hd) @ wo (H, hd, d) -> (B, T, d)."""
    B, T, H, hd = o.shape
    w = p.wo.kernel.reshape(H * hd, -1).to(o.dtype)
    y = o.reshape(B, T, H * hd) @ w
    if p.wo.bias is not None:
        y = y + p.wo.bias.to(y.dtype)
    return y


def blocked_attention(q, k, v, *, causal: bool, window: Optional[int],
                      chunk: int, kv_len=None):
    """Online-softmax tiled attention, (B,H,T,D) layout, plain PyTorch."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    scale = D ** -0.5
    dev = q.device

    def best_chunk(T, c):
        c = min(c, T)
        while T % c:
            c -= 1
        return c

    cq = best_chunk(Tq, chunk)
    ck = best_chunk(Tk, chunk)
    offset = Tk - Tq                     # end-aligned positions
    outs = []
    for qi in range(Tq // cq):
        qc = (q[:, :, qi * cq:(qi + 1) * cq] * scale).float()
        qpos = qi * cq + torch.arange(cq, device=dev)[:, None] + offset
        m = torch.full((B, Hq, cq, 1), NEG_INF, device=dev)
        l = torch.zeros((B, Hq, cq, 1), device=dev)
        acc = torch.zeros((B, Hq, cq, D), device=dev)
        for ki in range(Tk // ck):
            kc = k[:, :, ki * ck:(ki + 1) * ck].float()
            vc = v[:, :, ki * ck:(ki + 1) * ck]
            s = torch.einsum("bhqd,bhkd->bhqk", qc, kc)
            kpos = ki * ck + torch.arange(ck, device=dev)[None, :]
            mask = torch.ones((cq, ck), dtype=torch.bool, device=dev)
            if causal:
                mask &= kpos <= qpos
            if window is not None:
                mask &= kpos > qpos - window
            if kv_len is not None:
                mask = (mask[None] & (kpos[None] < kv_len[:, None, None]))
                mask = mask[:, None]
            else:
                mask = mask[None, None]
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            pexp = torch.where(mask, torch.exp(s - m_new), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + pexp.sum(-1, keepdim=True)
            acc = acc * corr + torch.einsum(
                "bhqk,bhkd->bhqd", pexp.to(v.dtype).float(), vc.float())
            m = m_new
        outs.append((acc / torch.where(l == 0.0, 1.0, l)).to(q.dtype))
    return torch.cat(outs, dim=2)


def _per_shard(fn, q, k, v, *, whole_ok: bool = False, **kw):
    """``fn(q, k, v, **kw)`` on (B, H, T, D) tensors. Under tensor
    parallelism (DTensors) it runs on each rank's shards and rewraps the
    result: attention is independent per (batch, head), and the rules
    shard q, k and v over those two axes only, alike (the query heads'
    blocks use the matching blocks of KV heads), so the shards are
    exact. Where the query heads are sharded and the KV heads are whole
    (a KV head count the model axis does not divide), each rank takes the
    KV heads its query heads use. DTensor keyword arguments (per-row
    lengths) are taken as their shards. DTensor's own rule for the score
    einsum's flatten of a head-sharded (B, H) fails in torch 2.11. Other
    placements raise, or with ``whole_ok`` run ``fn`` on the DTensors."""
    if not hasattr(q, "to_local"):
        return fn(q, k, v, **kw)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    pl, kpl = tuple(q.placements), tuple(k.placements)
    if (tuple(v.placements) != kpl
            or any(p != Replicate()
                   and not (isinstance(p, Shard) and p.dim in (0, 1))
                   for p in pl)
            or any(a != b and not (a == Shard(1) and b == Replicate())
                   for a, b in zip(pl, kpl))):
        if whole_ok:
            return fn(q, k, v, **kw)
        raise ValueError(f"attention over q {pl}, k {k.placements}, v "
                         f"{v.placements}: only batch and heads may be "
                         "sharded, alike in all three")
    # a rank's gradient of KV heads it takes a part of is a partial sum
    gpl = tuple(Partial() if a != b else b for a, b in zip(pl, kpl))
    kl, vl = k.to_local(grad_placements=gpl), v.to_local(grad_placements=gpl)
    ql = q.to_local()
    if kpl != pl:
        _, off = compute_local_shape_and_global_offset(
            q.shape, q.device_mesh, pl)
        g, h = q.shape[1] // k.shape[1], ql.shape[1]
        kl = kl.repeat_interleave(g, dim=1)[:, off[1]:off[1] + h]
        vl = vl.repeat_interleave(g, dim=1)[:, off[1]:off[1] + h]
    kw = {n: a.to_local() if isinstance(a, DTensor) else a
          for n, a in kw.items()}
    o = fn(ql, kl, vl, **kw)
    shape = tuple(q.shape[:3]) + tuple(v.shape[3:])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(o, q.device_mesh, pl, run_check=False,
                              shape=shape, stride=stride)


def attention_forward(p: Attention, cfg: ModelConfig, x, *, positions,
                      kv_x=None, causal=True, window=None, rope_on=True,
                      kv_repeat: int = 1):
    """Full-sequence attention (prefill, encoder, cross): x (B, T, d) ->
    (B, T, d); keys and values from ``kv_x`` (B, Tk, d) when given."""
    q, k, v = _project_qkv(p, cfg, x, kv_x, positions=positions,
                           rope_on=rope_on, kv_repeat=kv_repeat)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))     # (B,H,T,hd)
    if cfg.attention_impl == "blocked":
        o = _per_shard(blocked_attention, qt, kt, vt, causal=causal,
                       window=window, chunk=cfg.attn_chunk)
    else:
        o = _per_shard(ops.attention, qt, kt, vt, causal=causal,
                       window=window, impl=cfg.attention_impl)
    o = annotate(o.transpose(1, 2), "batch", "seq", "heads", "head_dim")
    return _out_proj(p, o)


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------
#: the logical axes of a KV cache leaf (k, v and the int8 scales)
CACHE_AXES = ("batch", "cache_kv_heads", "cache_seq", "head_dim")


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  kv_repeat: int = 1, dtype=torch.bfloat16, *,
                  device) -> Dict[str, torch.Tensor]:
    """KV cache; cfg.kv_cache_dtype == "int8" stores scale-quantized int8
    payloads with per-(pos, head) f32 scales. Under a rules context the
    leaves are DTensors placed by :data:`CACHE_AXES` (heads over "model"
    when head-TP, else the cache sequence)."""
    kvh = cfg.n_kv_heads * kv_repeat
    shape = (batch, kvh, max_len, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        cache = {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1] + (1,), device=device),
            "v_scale": torch.zeros(shape[:-1] + (1,), device=device),
        }
    else:
        cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)}
    cache = {n: place_new(t, *CACHE_AXES) for n, t in cache.items()}
    cache["len"] = place_new(
        torch.zeros((batch,), dtype=torch.int32, device=device), "batch")
    return cache


def _quantize(x, dim=-1):
    x32 = x.float()
    scale = x32.abs().amax(dim=dim, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def attention_decode(p: Attention, cfg: ModelConfig, x, cache: Dict, *,
                     window=None, kv_repeat: int = 1
                     ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode: x (B, 1, d), cache from init_kv_cache.

    When the cache is smaller than the logical sequence (local-attention
    ring buffer, size == window), writes wrap modulo the cache length;
    a write past the end of a full-length cache is dropped, as in the
    reference.
    """
    S = cache["k"].shape[2]
    ring = window is not None and S <= window
    pos = cache["len"][:, None]                       # (B,1) logical pos
    q, k, v = _project_qkv(p, cfg, x, positions=pos, kv_repeat=kv_repeat)
    write_pos = cache["len"] % S if ring else cache["len"]
    sel = (torch.arange(S, device=x.device)[None, :]
           == write_pos[:, None])                     # (B,S)
    sel4 = sel[:, None, :, None]
    knew = k.transpose(1, 2)                          # (B,KV,1,hd)
    vnew = v.transpose(1, 2)
    new_cache: Dict = {}
    if "k_scale" in cache:
        kq, ks = _quantize(knew)
        vq, vs = _quantize(vnew)
        ck = torch.where(sel4, kq, cache["k"])
        cv = torch.where(sel4, vq, cache["v"])
        cks = torch.where(sel4, ks, cache["k_scale"])
        cvs = torch.where(sel4, vs, cache["v_scale"])
        new_cache["k_scale"] = cks = annotate(cks, *CACHE_AXES)
        new_cache["v_scale"] = cvs = annotate(cvs, *CACHE_AXES)
        kk_full = ck.float() * cks
        vv_full = cv.float() * cvs
    else:
        ck = torch.where(sel4, knew.to(cache["k"].dtype), cache["k"])
        cv = torch.where(sel4, vnew.to(cache["v"].dtype), cache["v"])
        kk_full, vv_full = ck, cv
    new_cache["k"] = ck = annotate(ck, *CACHE_AXES)
    new_cache["v"] = cv = annotate(cv, *CACHE_AXES)
    new_len = cache["len"] + 1
    valid = torch.clamp_max(new_len, S) if ring else new_len
    o = _per_shard(_decode_attend, q.transpose(1, 2), kk_full, vv_full,
                   whole_ok=True, valid=valid, new_len=new_len,
                   window=None if ring else window,
                   scale=cfg.head_dim ** -0.5)
    o = o.transpose(1, 2).to(x.dtype)                 # (B,1,H,hd)
    new_cache["len"] = new_len
    return _out_proj(p, o), new_cache


def _decode_attend(q, kk, vv, *, valid, new_len, window, scale):
    """One query row per (batch, head) against the cache: q (B, H, 1, hd),
    kk and vv (B, KV, S, hd); positions at and past ``valid`` (B,) and,
    with ``window``, before it are masked. Returns (B, H, 1, hd) in vv's
    dtype."""
    B, Hq, _, hd = q.shape
    Hkv, S = kk.shape[1], kk.shape[2]
    g = Hq // Hkv
    qt = q.reshape(B, Hkv, g, 1, hd)                  # query head h -> h//g
    s = torch.einsum("bhgqd,bhkd->bhgqk", qt.float(), kk.float()) * scale
    kpos = torch.arange(S, device=q.device)[None, None, None, None, :]
    mask = kpos < valid[:, None, None, None, None]
    if window is not None:
        mask &= kpos > (new_len[:, None, None, None, None] - 1 - window)
    s = torch.where(mask, s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", pr.to(vv.dtype), vv)
    return o.reshape(B, Hq, 1, hd)


def _cross_attend(q, k, v, *, scale):
    """q (B, H, 1, hd) against k and v (B, H, Se, hd), unmasked; the
    result in v's dtype."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    pr = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", pr.to(v.dtype), v)


def cross_attention_decode(p: Attention, cfg: ModelConfig, x, k, v):
    """One decode row x (B, 1, d) against an encoder-decoder's
    precomputed cross keys and values (B, KV, Se, hd): the reference's
    einsum path (no kernel, no rope, no mask), per shard under tensor
    parallelism (the scores' flatten of a batch- and head-sharded (B, H)
    fails in torch 2.11)."""
    q = layers.dense(p.wq, x).transpose(1, 2)               # (B,H,1,hd)
    o = _per_shard(_cross_attend, q, k, v, whole_ok=True,
                   scale=cfg.head_dim ** -0.5)
    return _out_proj(p, o.transpose(1, 2))
