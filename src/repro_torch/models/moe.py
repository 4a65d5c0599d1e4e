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
dispatch and the experts are einsums, as there.

The groups, capacities and aux loss are those of the global batch
wherever the batch is split (:func:`repro_torch.sharding.rules.batch_slices`:
the "dp" step's plain slices, or a "tp" DTensor's shards over the data
axes). Each slice routes and dispatches only its own tokens, with the
group size taken from the global token count; where a group spans
slices, a slice's capacity slots start after the earlier slices'
per-expert counts (one exclusive prefix, E integers a layer), and the
aux loss takes the global top-1 fractions (E counts summed over the
slices, no gradient). Under "tp" the routing runs on each data shard
(``topk``, ``one_hot`` and the capacity ``cumsum`` on plain tensors) and
the experts on DTensors, with the reference's annotations of ``xt``,
``ex_in``, ``h`` and ``ex_out``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import annotate, batch_slices, slices_of

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


def _batch_local(t):
    """A DTensor's shard over the batch axis alone (whole along every
    other axis), as a plain tensor; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor):
        return t
    pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
               for p in t.placements)
    return t.redistribute(t.device_mesh, pl).to_local()


def _route(p: MoE, cfg: ModelConfig, x):
    """Router probabilities and each token's normalised top-k:
    (probs, gate_vals, expert_idx), all f32 but the int64 indices, plain
    tensors (a DTensor ``x``'s batch shard)."""
    probs = torch.softmax(_batch_local(layers.dense(p.router, x.float())),
                          dim=-1)
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
    xt = annotate(x.reshape(B * T, d), "batch", "embed")
    probs, gate_vals, expert_idx = _route(p, cfg, xt)
    gates = _like(torch.zeros_like(probs).scatter(1, expert_idx, gate_vals),
                  xt)
    # the experts as a batch axis of bmm: an einsum that flattens (e, f)
    # with f sharded (per-expert d_ff over "model") has no rule in torch
    # 2.11, and the expand costs nothing at decode's T = 1
    h, wo = _experts(p, xt.expand(cfg.n_experts, *xt.shape), "end,edf->enf")
    y = torch.einsum("end,ne->nd", torch.bmm(h, wo), gates.to(xt.dtype))
    return y.reshape(B, T, d), torch.zeros((), device=x.device)


def dispatch(cfg: ModelConfig, expert_idx, S: int, offset=None):
    """The capacity-bounded slots of a group: (sel (G,S',k,E) int, pos
    (G,S',k), keep (G,S',k) bool, capacity) for groups of ``S`` tokens of
    which ``expert_idx`` (G,S',k) holds S' (all of them on one device). A
    (token, choice) pair's slot is the count of earlier pairs routed to
    its expert, in s-major order over the flattened (S * k) axis, plus
    ``offset`` (E,), the pairs of the group's earlier slices; it keeps
    its slot when that count is below the capacity."""
    E, k = cfg.n_experts, cfg.moe_top_k
    G, Sl = expert_idx.shape[:2]
    capacity = max(int(cfg.capacity_factor * S * k / E), 4)
    sel = F.one_hot(expert_idx, E).to(torch.int32)             # (G,S',k,E)
    flat = sel.reshape(G, Sl * k, E)
    pos = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat  # (G,S'k,E)
    if offset is not None:
        pos = pos + offset.to(torch.int32)
    pos = (pos.reshape(G, Sl, k, E) * sel).sum(-1)              # (G,S',k)
    return sel, pos, pos < capacity, capacity


def _like(t, ref):
    """Plain per-slice ``t`` as a DTensor placed as ``ref`` along the
    batch axis (replicated along the others, and along mesh axes of size
    1), when ``ref`` is one."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    pl = tuple(p if isinstance(p, Shard) and p.dim == 0
               and mesh.mesh.shape[i] > 1 else Replicate()
               for i, p in enumerate(ref.placements))
    return DTensor.from_local(t, mesh, pl, run_check=False)


def _group_offset(sl, sel, S: int, n_loc: int):
    """The per-expert (token, choice) count of the earlier slices in this
    slice's group (E,): each slice holds ``n_loc`` tokens, a group S."""
    per = S // n_loc                                  # slices per group
    counts = sl.gather(sel.sum((0, 1, 2)))            # (n, E)
    first = sl.index - sl.index % per
    return counts[first:sl.index].sum(0)


def moe_forward(p: MoE, cfg: ModelConfig, x
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, d) -> (y (B, T, d), aux_loss scalar f32)."""
    B, T, d = x.shape
    E = cfg.n_experts
    x = annotate(x, "batch", "seq", "embed")
    sl = batch_slices(x)
    xl = _batch_local(x)
    n_loc = xl.shape[0] * T
    n = n_loc * (sl.n if sl is not None else 1)      # global tokens
    S = min(GROUP_SIZE, n)
    if n_loc % S == 0:
        G, Sl = n_loc // S, S
    elif S % n_loc == 0:                              # a group spans slices
        G, Sl = 1, n_loc
    else:
        raise ValueError(f"{n_loc} tokens a slice neither hold whole "
                         f"groups of {S} nor divide one")
    xt = xl.reshape(G, Sl, d)
    probs, gate_vals, expert_idx = _route(p, cfg, annotate(
        _like(xt, x), "batch", None, "embed"))         # (G,S',*)

    # Switch aux loss: E * mean_e(frac routed to e) * mean_e(router prob e)
    # (with slices, this slice's share: the global top-1 fractions, its
    # own probabilities over the global count)
    top1 = F.one_hot(expert_idx[..., 0], E).sum((0, 1))
    frac = (sl.gather(top1).sum(0) if sl is not None else top1).float() / n
    aux = E * torch.sum(frac * probs.sum((0, 1)) / n)
    if hasattr(x, "device_mesh"):
        # "tp": the slices' shares summed, as a DTensor (a plain aux would
        # take the loss's DTensor gradient into the plain routing)
        aux = (sl or slices_of(x.device_mesh, ())).total(aux)

    offset = (_group_offset(sl, F.one_hot(expert_idx, E), S, n_loc)
              if sl is not None and Sl < S else None)
    sel, pos, keep, capacity = dispatch(cfg, expert_idx, S, offset)
    gate_vals = gate_vals * keep
    pos_oh = F.one_hot(torch.where(keep, pos, capacity).long(),
                       capacity + 1)[..., :capacity]           # (G,S',k,C)
    disp = torch.einsum("gske,gskc->gsec", sel.to(xt.dtype),
                        pos_oh.to(xt.dtype))
    comb = torch.einsum("gske,gskc,gsk->gsec", sel.float(), pos_oh.float(),
                        gate_vals.float()).to(xt.dtype)

    ex_in = _like(torch.einsum("gsec,gsd->gecd", disp, xt), x)  # (G,E,C,d)
    ex_in = annotate(ex_in, "batch", "experts", "capacity", "embed")
    h, wo = _experts(p, ex_in, "gecd,edf->gecf")
    h = annotate(h, "batch", "experts", "capacity", "mlp")
    ex_out = annotate(torch.einsum("gecf,efd->gecd", h, wo),
                      "batch", "experts", "capacity", "embed")
    y = _combine(_like(comb, x), ex_out)
    y = _like(_batch_local(y).reshape(xl.shape), x)
    return y, aux


def _combine(comb, ex_out):
    """y (G,S,d) = sum over (e, c) of comb (G,S,E,C) ex_out (G,E,C,d). With
    the experts sharded over "model" each rank takes its experts' slice
    of ``comb`` (a local chunk, its gradient gathered back) and sums
    them: the partial sums make y ``Partial`` over those mesh axes. The
    einsum's flatten of (e, c) with e sharded has no rule in torch
    2.11."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    if not (isinstance(ex_out, DTensor) and Shard(1) in ex_out.placements):
        return torch.einsum("gsec,gecd->gsd", comb, ex_out)
    mesh = ex_out.device_mesh
    epl = tuple(Shard(2) if p == Shard(1) else p for p in ex_out.placements)
    cl = comb.redistribute(mesh, epl).to_local()
    y = torch.einsum("gsec,gecd->gsd", cl, ex_out.to_local())
    pl = tuple(Partial() if p == Shard(1) else p for p in ex_out.placements)
    shape = tuple(comb.shape[:2]) + tuple(ex_out.shape[-1:])
    return DTensor.from_local(y, mesh, pl, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())
