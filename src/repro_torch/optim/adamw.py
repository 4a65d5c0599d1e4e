"""AdamW with warmup + cosine schedule and global-norm clipping.

The port of the reference's ``optim/adamw.py``: the same formulas, an
f32 first and second moment per parameter and an int32 step counter.
Parameters are a :class:`torch.nn.Module` (its named parameters) or a
mapping of names to tensors; ``m``, ``v`` and the gradients are mappings
keyed by the same names. :func:`apply_updates` writes the new values
into the parameters and the moments in place (a training step holds one
copy of each) and returns them.

ZeRO-1 (the reference's ``zero1_shardings``) over a ``DeviceMesh``:
:func:`zero1_placements` gives m and v the parameter's placements plus
the data axes on the first tensor dimension that no mesh axis shards and
that the data size divides, so optimizer memory scales 1/DP (the train
step's ``place_train_state`` makes them DTensors so placed), and
:func:`apply_updates_sharded` reduce-scatters each gradient onto them,
takes the clipping norm from the shards' sums of squares (one
all-reduce, so clipping sees the whole gradient), updates the local
shard of each parameter, m and v, and all-gathers the parameters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def named(params: Params) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a module's parameters or of a mapping."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (f32): linear warmup, then a cosine
    down to ``min_lr_frac``."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Params) -> Dict[str, object]:
    """Zero moments in f32 beside each parameter, and step 0 (int32)."""
    p = named(params)
    dev = next(iter(p.values())).device

    def zeros():
        return {k: torch.zeros(t.shape, dtype=torch.float32,
                               device=t.device) for k, t in p.items()}
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    sq = sum(torch.sum(torch.square(x.float())) for x in tree.values())
    return torch.sqrt(sq)


def _step_scalars(cfg: AdamWConfig, step: torch.Tensor,
                  gnorm: torch.Tensor):
    """(clip scale, lr, bias corrections 1 - b1^t and 1 - b2^t) of
    ``step`` (the new step count) at gradient norm ``gnorm``."""
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-6), max=1.0)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())
    return scale, schedule(cfg, step), b1c, b2c


def _adamw_leaf(cfg: AdamWConfig, p: torch.Tensor, g: torch.Tensor,
                m: torch.Tensor, v: torch.Tensor, lr, b1c, b2c
                ) -> torch.Tensor:
    """AdamW on one leaf, or one shard of it: ``g`` is the clipped f32
    gradient, ``m`` and ``v`` (f32) are updated in place; returns the
    new value of ``p`` in its dtype."""
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
    d = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
        + cfg.weight_decay * p.float()
    return (p.float() - lr * d).to(p.dtype)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Params,
                  grads: Mapping[str, torch.Tensor], opt_state
                  ) -> Tuple[Params, Dict[str, object],
                             Dict[str, torch.Tensor]]:
    """One AdamW step; returns (params, opt_state, {"grad_norm", "lr"}),
    the gradient norm before clipping. ``params`` and the moments are
    updated in place."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale, lr, b1c, b2c = _step_scalars(cfg, step, gnorm)
    m_all, v_all = opt_state["m"], opt_state["v"]
    for name, p in named(params).items():
        p.copy_(_adamw_leaf(cfg, p, grads[name].float() * scale,
                            m_all[name], v_all[name], lr, b1c, b2c))
    opt_state = {"m": m_all, "v": v_all, "step": step}
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# ZeRO-1 over a DeviceMesh
# ---------------------------------------------------------------------------
def _data_dims(mesh) -> Tuple[int, ...]:
    names = tuple(mesh.mesh_dim_names)
    return tuple(names.index(a) for a in ("pod", "data") if a in names)


def zero1_placements(param_placements: Mapping[str, tuple], mesh,
                     params, stacked: Optional[Mapping[str, int]] = None
                     ) -> Dict[str, object]:
    """m/v placements = the parameter's, plus the data axes on the first
    tensor dimension that no mesh axis shards and the data size divides
    (the reference's ``zero1_shardings``); ``params`` gives the shapes
    (a module or {name: tensor}, ``meta`` tensors too). The step is
    replicated.

    The reference stacks a layer's leaf over the layers of its stack
    (``stacked``: {name: that count}); when the data size divides the
    count, its ZeRO-1 takes that axis, which the port's one-layer leaf
    lacks. Such a leaf with no free dimension the data size divides (a
    vector sharded over "model") then has the data axes split its model
    shards further (nested), so that a device holds the reference's
    bytes."""
    from torch.distributed.tensor import Replicate, Shard
    ddims = _data_dims(mesh)
    dsize = 1
    for d in ddims:
        dsize *= mesh.mesh.shape[d]

    def extend(name, shape):
        pl = list(param_placements[name])
        ways = {}
        for d, p in enumerate(pl):
            if isinstance(p, Shard):
                ways[p.dim] = ways.get(p.dim, 1) * mesh.mesh.shape[d]
        if dsize == 1:
            return tuple(pl)
        for i, dim in enumerate(shape):
            if i not in ways and dim % dsize == 0:
                for d in ddims:
                    pl[d] = Shard(i)
                return tuple(pl)
        if stacked and stacked.get(name, 1) % dsize == 0:
            for i, w in sorted(ways.items()):
                if shape[i] % (w * dsize) == 0:
                    for d in ddims:
                        pl[d] = Shard(i)
                    break
        return tuple(pl)

    mv = {k: extend(k, tuple(t.shape)) for k, t in named(params).items()}
    return {"m": mv, "v": dict(mv),
            "step": (Replicate(),) * mesh.ndim}


def _owns(mesh, placements) -> bool:
    """Whether this rank holds the copy of its shard that counts: the
    first along every mesh dimension that replicates the tensor."""
    from torch.distributed.tensor import Replicate
    return all(mesh.get_local_rank(d) == 0
               for d, p in enumerate(placements) if p == Replicate())


@torch.no_grad()
def apply_updates_sharded(cfg: AdamWConfig, params: Params,
                          grads: Mapping[str, torch.Tensor], opt_state, *,
                          mesh, param_placements: Mapping[str, tuple],
                          grad_placements: Optional[tuple] = None
                          ) -> Tuple[Params, Dict[str, object],
                                     Dict[str, torch.Tensor]]:
    """One AdamW step under ZeRO-1 on ``mesh``: m and v in ``opt_state``
    are DTensors of their ZeRO-1 placements. ``grads`` are DTensors (any
    placements, partial sums included), or plain per-rank tensors whose
    placements ``grad_placements`` gives (``Partial`` over the mesh
    dimensions the batch is split over). Each gradient is redistributed
    onto its m/v placements (a reduce-scatter over the data ranks); the
    global norm is the square root of the shards' sums of squares,
    all-reduced, each shard counted once; the local shards of the
    parameter, m and v are updated with :func:`apply_updates`' formulas;
    the parameter is redistributed back to ``param_placements`` (an
    all-gather) and copied into ``params`` (DTensors, or plain replicated
    tensors). Returns what :func:`apply_updates` returns; the metrics are
    the same on every rank."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate
    step = opt_state["step"] + 1
    m_all, v_all = opt_state["m"], opt_state["v"]
    shards, sq = {}, None
    for name, g in grads.items():
        zp = m_all[name].placements
        if not isinstance(g, DTensor):
            g = DTensor.from_local(g, mesh, grad_placements, run_check=False)
        g = _local(g.redistribute(mesh, zp)).float()
        shards[name] = g
        if _owns(mesh, zp):
            s = torch.sum(torch.square(g))
            sq = s if sq is None else sq + s
    sq = sq if sq is not None else torch.zeros(
        (), device=next(iter(shards.values())).device)
    dist.all_reduce(sq)
    gnorm = torch.sqrt(sq)
    scale, lr, b1c, b2c = _step_scalars(cfg, step, gnorm)
    replicated = (Replicate(),) * mesh.ndim
    for name, p in named(params).items():
        zp = m_all[name].placements
        pd = p if isinstance(p, DTensor) else DTensor.from_local(
            p, mesh, replicated, run_check=False)
        ps = _local(pd.redistribute(mesh, zp))
        new = _adamw_leaf(cfg, ps, shards[name] * scale,
                          _local(m_all[name]), _local(v_all[name]),
                          lr, b1c, b2c)
        new = DTensor.from_local(new, mesh, zp, run_check=False)
        new = new.redistribute(mesh, tuple(param_placements[name])
                               if isinstance(p, DTensor) else replicated)
        p.copy_(new if isinstance(p, DTensor) else new.to_local())
    opt_state = {"m": m_all, "v": v_all, "step": step}
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
