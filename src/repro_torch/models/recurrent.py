"""Recurrent blocks: RWKV6 (Finch) time-mix and RG-LRU (RecurrentGemma).

The port of the reference's ``models/recurrent.py``. Both decode in O(1)
state: RWKV6 {"shift": (B, d), "wkv": (B, H, K, K) f32}, RG-LRU {"conv":
(B, W-1, d), "h": (B, d)} in the compute dtype. The WKV recurrence goes
through ``ops.wkv6``: the "kernel" route takes the Hopper kernel's
wrapper, "ref" and "blocked" its plain version, as the reference maps its
routes. The RG-LRU recurrence has no TPU kernel in the reference (a
``lax.associative_scan``); here it is a log-depth doubling scan in plain
PyTorch (:func:`_rglru_scan`). The reference's sharding annotations sit
where its do (RWKV6's r, v, o; the RG-LRU's ``xb`` and ``h``); under
tensor parallelism both recurrences run on each rank's shards.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import annotate, grad_as_placed

MIX_NAMES = ("r", "k", "v", "w", "g")


class RWKV6(nn.Module):
    """Parameters with the reference's leaf names: Dense ``w_r``, ``w_k``,
    ``w_v``, ``w_g``, ``w_w``, ``w_out``; ``lora_a`` (d, rank), ``lora_b``
    (rank, d), ``u`` (H, K), ``mix_{r,k,v,w,g}``, ``w_base``,
    ``ln_scale``, ``ln_bias`` (d,)."""

    #: leaves that every use casts to the activations' dtype (the token
    #: shift's mixes and the LoRA factors); ``u``, ``w_base`` and the
    #: group norm's ``ln_*`` are used in f32
    compute_cast = ("lora_a", "lora_b", *(f"mix_{n}" for n in MIX_NAMES))

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        d, K, rank = cfg.d_model, cfg.rwkv_head_dim, cfg.rwkv_lora_rank
        H = d // K
        dt = layers.dtype_of(cfg.param_dtype)
        kw = dict(dtype=dt, generator=generator, device=device)
        for name in ("w_r", "w_k", "w_v", "w_g"):
            setattr(self, name, layers.Dense(d, d, **kw))
        self.w_w = layers.Dense(d, d, stddev=1e-3, **kw)
        self.w_out = layers.Dense(d, d, **kw)

        def normal(shape, std):
            return layers.param(layers.truncated_normal(shape, std, **kw))

        def full(value):
            return layers.param(torch.full((d,), value, dtype=dt,
                                           device=device))
        self.lora_a = normal((d, rank), d ** -0.5)
        self.lora_b = normal((rank, d), 1e-3)
        self.u = normal((H, K), 0.5)
        # static token-shift mix coefficients for r, k, v, w, g
        for name in MIX_NAMES:
            setattr(self, f"mix_{name}", full(0.5))
        self.w_base = full(-1.5)      # softplus-ish base log decay
        self.ln_scale = full(1.0)
        self.ln_bias = full(0.0)


def _rwkv_mix(p: RWKV6, x, x_prev):
    """Token shift: per-channel lerp between x_{t-1} and x_t."""
    xx = torch.cat([x_prev[:, None], x[:, :-1]], dim=1) - x
    mixed = {name: x + xx * getattr(p, f"mix_{name}").to(x.dtype)
             for name in MIX_NAMES}
    return mixed, x[:, -1]


def _rwkv_rkvwg(p: RWKV6, cfg: ModelConfig, mixed):
    d = cfg.d_model
    K = cfg.rwkv_head_dim
    H = d // K
    B, T = mixed["r"].shape[:2]

    def heads(t):
        # under tensor parallelism v's (B, T, d) is sharded over its flat
        # channels (H * V); those shards need not hold whole heads (40
        # heads over 16), which DTensor cannot unflatten: the channels are
        # gathered first, and v is sharded again over V (its annotation).
        # The gradient comes back sharded over V, which torch 2.11 cannot
        # flatten into (B, T, d): it is gathered at the split
        t = annotate(t, "batch", "seq", "embed")
        return grad_as_placed(t.reshape(B, T, H, K)).transpose(1, 2)

    r = heads(layers.dense(p.w_r, mixed["r"]))
    k = heads(layers.dense(p.w_k, mixed["k"]))
    v = heads(layers.dense(p.w_v, mixed["v"]))
    g = layers.dense(p.w_g, mixed["g"])                      # (B,T,d)
    # data-dependent log decay (LoRA): w = -softplus(base + lora) - eps
    mw = mixed["w"]
    ww = (torch.tanh(mw) @ p.lora_a.to(mw.dtype)) @ p.lora_b.to(mw.dtype)
    w = -F.softplus(p.w_base.float() + layers.dense(p.w_w, mw).float()
                    + ww.float()) - 1e-3
    return r, k, v, heads(w), g


def rwkv6_forward(p: RWKV6, cfg: ModelConfig, x, state: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """x (B,T,d); state {"shift": (B,d), "wkv": (B,H,K,K)} or None."""
    B, T, d = x.shape
    K = cfg.rwkv_head_dim
    H = d // K
    if state is None:
        state = {"shift": torch.zeros((B, d), dtype=x.dtype, device=x.device),
                 "wkv": torch.zeros((B, H, K, K), device=x.device)}
    mixed, new_shift = _rwkv_mix(p, x, state["shift"])
    r, k, v, w, g = _rwkv_rkvwg(p, cfg, mixed)
    impl = "ref" if cfg.attention_impl in ("ref", "blocked") else "kernel"
    r = annotate(r, "batch", "rheads", "seq", "rkey")
    v = annotate(v, "batch", "rheads", "seq", "rvalue")
    o, wkv = _wkv6_per_shard(
        r, k, v, w, p.u.float(), state["wkv"], impl=impl,
        **({"chunk": cfg.wkv_chunk} if impl != "ref" else {}))
    o = annotate(o, "batch", "rheads", "seq", "rvalue")
    # torch 2.11 refuses to flatten (H, V) with V sharded: V is gathered
    # first; the flat output's gradient is kept whole (see heads())
    o = annotate(o, "batch", "rheads", "seq", None)
    o = grad_as_placed(o.transpose(1, 2).reshape(B, T, d))   # (B,T,d)
    # the group norm's (d,) scale and bias are sharded over "model" like
    # v's flat channels: taken whole, so that its reshapes (and their
    # backward) never split channels that do not hold whole heads
    o = grad_as_placed(layers.groupnorm(
        annotate(p.ln_scale.float(), None), annotate(p.ln_bias.float(), None),
        o, H))
    o = o.to(x.dtype) * F.silu(g)
    y = layers.dense(p.w_out, o)
    return y.to(x.dtype), {"shift": new_shift, "wkv": wkv}


def _wkv6_per_shard(r, k, v, w, u, s0, **kw):
    """``ops.wkv6`` on each rank's shards under tensor parallelism
    (DTensors), exact: the recurrence is independent per (batch, head,
    value channel), and the rules shard v, the state and o over the batch
    and the value channel ("rvalue") only. r, k, w and u are taken whole
    along the value channel, so a rank's gradient of them is a partial
    sum over the ranks that split it. DTensor has no cheap way through
    the T-step loop: this runs it on plain tensors."""
    if not hasattr(v, "to_local"):
        return ops.wkv6(r, k, v, w, u, s0, **kw)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, vpl = v.device_mesh, tuple(v.placements)
    if any(p != Replicate() and p not in (Shard(0), Shard(3)) for p in vpl):
        raise ValueError(f"wkv6 over v {vpl}: only the batch and the value "
                         "channel may be sharded")
    # r, k, w: v's batch shards, whole along the value channel
    rpl = tuple(p if p == Shard(0) else Replicate() for p in vpl)
    gpl = tuple(p if p == Shard(0) else
                Partial() if p == Shard(3) else Replicate() for p in vpl)
    rl, kl, wl = (t.redistribute(mesh, rpl).to_local(grad_placements=gpl)
                  for t in (r, k, w))
    upl = tuple(Partial() if p != Replicate() else Replicate() for p in vpl)
    ul = u.redistribute(mesh, (Replicate(),) * mesh.ndim).to_local(
        grad_placements=upl)
    sl = (None if s0 is None else s0.redistribute(mesh, vpl).to_local()
          if isinstance(s0, DTensor) else None)
    o, sf = ops.wkv6(rl, kl, v.to_local(), wl, ul, sl, **kw)
    B, H, T, _ = r.shape
    V, K = v.shape[-1], r.shape[-1]

    def wrap(t, shape):
        return DTensor.from_local(
            t, mesh, vpl, run_check=False, shape=shape,
            stride=torch.empty(shape, device="meta").stride())
    return wrap(o, (B, H, T, V)), wrap(sf, (B, H, K, V))


def rwkv6_decode(p: RWKV6, cfg: ModelConfig, x, state
                 ) -> Tuple[torch.Tensor, Dict]:
    """Single-token step, reusing the T=1 forward (O(1) state)."""
    return rwkv6_forward(p, cfg, x, state)


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma recurrent block)
# ---------------------------------------------------------------------------
class RGLRU(nn.Module):
    """Parameters with the reference's leaf names: Dense ``w_x``,
    ``w_gate``, ``w_out`` and, with bias, ``wi``, ``wr`` (d, d);
    ``conv_w`` (W, d), ``conv_b`` (d,), ``lam`` (d,)."""

    #: the causal conv casts its weights to the activations' dtype;
    #: ``lam`` is used in f32
    compute_cast = ("conv_w", "conv_b")

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        d, W = cfg.d_model, cfg.conv_width
        dt = layers.dtype_of(cfg.param_dtype)
        kw = dict(dtype=dt, generator=generator, device=device)
        self.w_x = layers.Dense(d, d, **kw)
        self.w_gate = layers.Dense(d, d, **kw)
        self.w_out = layers.Dense(d, d, **kw)
        self.conv_w = layers.param(layers.truncated_normal(
            (W, d), W ** -0.5, **kw))
        self.conv_b = layers.param(torch.zeros((d,), dtype=dt,
                                               device=device))
        self.wi = layers.Dense(d, d, bias=True, **kw)
        self.wr = layers.Dense(d, d, bias=True, **kw)
        # Lambda param: a = sigmoid(lam) in ~(0.9, 0.999)
        self.lam = layers.param(torch.linspace(
            2.2, 6.9, d, device=device).to(dt))


def _causal_conv(p: RGLRU, x, conv_state=None):
    """Per-channel causal conv, width W. x (B,T,d) -> (y, new state
    (B,W-1,d)), in x's dtype."""
    W = p.conv_w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((x.shape[0], W - 1, x.shape[-1]),
                                 dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_state, x], dim=1)                   # (B,T+W-1,d)
    w = p.conv_w.to(x.dtype)
    T = x.shape[1]
    y = sum(xp[:, i:i + T] * w[i] for i in range(W))
    y = y + p.conv_b.to(x.dtype)
    return y, xp[:, -(W - 1):]


def _rglru_scan(a, gx):
    """h_t = a_t * h_{t-1} + gx_t (h_0 = 0) over T (dim 1), as a
    log-depth doubling scan: after the step of offset o, (a_t, b_t)
    holds the composition of steps t-2o+1 .. t, so ceil(log2 T)
    elementwise steps give every prefix. The reference composes the
    same steps in its associative scan's tree: the adds differ in order,
    not in what they add."""
    T = a.shape[1]
    b = gx
    o = 1
    while o < T:
        b = torch.cat([b[:, :o], b[:, o:] + a[:, o:] * b[:, :-o]], dim=1)
        if 2 * o < T:
            a = torch.cat([a[:, :o], a[:, o:] * a[:, :-o]], dim=1)
        o *= 2
    return b


def _scan_per_shard(a, gx):
    """:func:`_rglru_scan` on each rank's shards under tensor parallelism
    (DTensors; exact: the scan is elementwise along the batch and
    channels, and a and gx share their placements, whole along T). The
    doubling scan's slices and ``torch.cat`` along T would take a
    DTensor dispatch each."""
    if not hasattr(a, "to_local"):
        return _rglru_scan(a, gx)
    from torch.distributed.tensor import DTensor, Replicate
    mesh, pl = a.device_mesh, tuple(a.placements)
    if any(p != Replicate() and p.dim == 1 for p in pl):
        pl = tuple(Replicate() if p != Replicate() and p.dim == 1 else p
                   for p in pl)
        a = a.redistribute(mesh, pl)
    b = _rglru_scan(a.to_local(), gx.redistribute(mesh, pl).to_local())
    return DTensor.from_local(b, mesh, pl, run_check=False,
                              shape=a.shape, stride=a.stride())


def rglru_forward(p: RGLRU, cfg: ModelConfig, x, state: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """x (B,T,d); state {"conv": (B,W-1,d), "h": (B,d)} or None."""
    gate = F.gelu(layers.dense(p.w_gate, x), approximate="tanh")
    xb = annotate(layers.dense(p.w_x, x), "batch", "seq", "rnn")
    conv_state = None if state is None else state["conv"]
    xb, new_conv = _causal_conv(p, xb, conv_state)

    # the gates' input whole along "rnn" (their kernels shard the output
    # channels): DTensor's own plan for the contraction over a sharded
    # dim would add the sharded bias to a partial sum, which torch 2.11
    # cannot place
    xw = annotate(xb, "batch", "seq", "embed")
    i_t = torch.sigmoid(layers.dense(p.wi, xw).float())
    r_t = torch.sigmoid(layers.dense(p.wr, xw).float())
    # a = sigmoid(lam)^(c * r): log a = -c * r * softplus(-lam)
    log_a = -cfg.lru_c * r_t * F.softplus(-p.lam.float())
    a_t = torch.exp(log_a)
    gx = torch.sqrt(torch.clamp_min(1.0 - a_t * a_t, 1e-12)) \
        * (i_t * xb.float())
    if state is not None:
        # fold initial h into the first step: h_1 = a_1 h_0 + gx_1
        gx = torch.cat([gx[:, :1] + (a_t[:, 0] * state["h"].float())[:, None],
                        gx[:, 1:]], dim=1)
    h = annotate(_scan_per_shard(a_t, gx).to(x.dtype),
                 "batch", "seq", "rnn")                        # (B,T,d)
    y = layers.dense(p.w_out, h * gate)
    return y, {"conv": new_conv, "h": h[:, -1]}


def rglru_decode(p: RGLRU, cfg: ModelConfig, x, state
                 ) -> Tuple[torch.Tensor, Dict]:
    """Single-token step, reusing the T=1 forward (O(1) state)."""
    return rglru_forward(p, cfg, x, state)
