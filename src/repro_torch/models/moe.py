"""Top-k MoE with grouped, capacity-bounded einsum dispatch (GShard/t5x).

The port of the reference's ``models/moe.py``. Tokens are split into
groups of :data:`GROUP_SIZE`; each group competes for per-group capacity
C = max(int(capacity_factor * S * k / E), 4). Which of a group's (token,
choice) pairs keep their slot is decided in s-major order over the
flattened (S * k) axis, the reference's ``cumsum``; overflowed tokens fall
through the residual. A Switch-style aux loss is returned. Decode takes
:func:`moe_dense_forward`, every token's exact top-k with no capacity.

The router runs in f32 on f32 activations (its kernel is never cast to
the compute dtype, so ``torch.topk`` and the reference's ``top_k`` see the
same probabilities); the experts' ``wi``, ``wg``, ``wo`` are cast to the
activations' dtype. The reference has no Pallas kernel here: the
dispatch and the experts are einsums, as there. Its sharding annotations
are not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

GROUP_SIZE = 256


class Router(layers.Dense):
    """The router's Dense (d, E). Used in f32 (the activations are cast
    to f32 for it), so ``cast_for_compute`` leaves it as it is."""

    compute_cast = ()


class MoE(nn.Module):
    """Parameters with the reference's leaf names: ``router`` (Dense d ->
    E), ``wi``/``wg`` (E, d, f) and ``wo`` (E, f, d), each a ``kernel``
    (a bias-free Dense holds the stacked experts: its kernel is (E, *out)
    with the experts' fan-in as its stddev, cast to the activations'
    dtype on every use)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        kw = dict(dtype=layers.dtype_of(cfg.param_dtype),
                  generator=generator, device=device)
        self.router = Router(d, E, **kw)
        self.wi = layers.Dense(E, (d, f), stddev=d ** -0.5, **kw)
        self.wg = layers.Dense(E, (d, f), stddev=d ** -0.5, **kw)
        self.wo = layers.Dense(E, (f, d), stddev=f ** -0.5, **kw)


def _route(p: MoE, cfg: ModelConfig, x):
    """Router probabilities and each token's normalised top-k:
    (probs, gate_vals, expert_idx), all f32 but the int64 indices."""
    probs = torch.softmax(layers.dense(p.router, x.float()), dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    return probs, gate_vals, expert_idx


def _experts(p: MoE, x, eq: str):
    """The experts' silu_glu hidden activations silu(x wg) * (x wi), and
    ``wo``, both in x's dtype."""
    h = torch.einsum(eq, x, p.wi.kernel.to(x.dtype))
    g = torch.einsum(eq, x, p.wg.kernel.to(x.dtype))
    return layers.activation("silu_glu", h, g), p.wo.kernel.to(x.dtype)


def moe_dense_forward(p: MoE, cfg: ModelConfig, x
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-free MoE (decode path): every token gets its exact top-k.

    Computes all experts for the token batch (T is 1 at decode, so the
    E/k-fold extra FLOPs are negligible)."""
    B, T, d = x.shape
    xt = x.reshape(B * T, d)
    probs, gate_vals, expert_idx = _route(p, cfg, xt)
    gates = torch.zeros_like(probs).scatter(1, expert_idx, gate_vals)
    h, wo = _experts(p, xt, "nd,edf->nef")
    y = torch.einsum("nef,efd,ne->nd", h, wo, gates.to(xt.dtype))
    return y.reshape(B, T, d), torch.zeros((), device=x.device)


def dispatch(cfg: ModelConfig, expert_idx, S: int):
    """The capacity-bounded slots of a group: (sel (G,S,k,E) int, pos
    (G,S,k), keep (G,S,k) bool, capacity). A (token, choice) pair's slot
    is the count of earlier pairs routed to its expert, in s-major order
    over the flattened (S * k) axis; it keeps its slot when that count is
    below the capacity."""
    E, k = cfg.n_experts, cfg.moe_top_k
    G = expert_idx.shape[0]
    capacity = max(int(cfg.capacity_factor * S * k / E), 4)
    sel = F.one_hot(expert_idx, E).to(torch.int32)             # (G,S,k,E)
    flat = sel.reshape(G, S * k, E)
    pos = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat  # (G,S*k,E)
    pos = (pos.reshape(G, S, k, E) * sel).sum(-1)               # (G,S,k)
    return sel, pos, pos < capacity, capacity


def moe_forward(p: MoE, cfg: ModelConfig, x
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, d) -> (y (B, T, d), aux_loss scalar f32)."""
    B, T, d = x.shape
    E = cfg.n_experts
    n = B * T
    S = min(GROUP_SIZE, n)
    G = n // S
    xt = x.reshape(G, S, d)
    probs, gate_vals, expert_idx = _route(p, cfg, xt)         # (G,S,*)

    # Switch aux loss: E * mean_e(frac routed to e) * mean_e(router prob e)
    top1 = F.one_hot(expert_idx[..., 0], E).float()
    aux = E * torch.sum(top1.mean((0, 1)) * probs.mean((0, 1)))

    sel, pos, keep, capacity = dispatch(cfg, expert_idx, S)
    gate_vals = gate_vals * keep
    pos_oh = F.one_hot(torch.where(keep, pos, capacity).long(),
                       capacity + 1)[..., :capacity]           # (G,S,k,C)
    disp = torch.einsum("gske,gskc->gsec", sel.to(xt.dtype),
                        pos_oh.to(xt.dtype))
    comb = torch.einsum("gske,gskc,gsk->gsec", sel.float(), pos_oh.float(),
                        gate_vals.float()).to(xt.dtype)

    ex_in = torch.einsum("gsec,gsd->gecd", disp, xt)           # (G,E,C,d)
    h, wo = _experts(p, ex_in, "gecd,edf->gecf")
    ex_out = torch.einsum("gecf,efd->gecd", h, wo)
    y = torch.einsum("gsec,gecd->gsd", comb, ex_out)
    return y.reshape(B, T, d), aux
