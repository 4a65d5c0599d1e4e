"""AdamW with warmup + cosine schedule and global-norm clipping.

The port of the reference's ``optim/adamw.py``: the same formulas, an
f32 first and second moment per parameter and an int32 step counter.
Parameters are a :class:`torch.nn.Module` (its named parameters) or a
mapping of names to tensors; ``m``, ``v`` and the gradients are mappings
keyed by the same names. :func:`apply_updates` writes the new values
into the parameters and the moments in place (a training step holds one
copy of each) and returns them. The reference's ``zero1_shardings``
(optimizer state sharded over data-parallel replicas) has no counterpart
on one card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple, Union

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


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    sq = sum(torch.sum(torch.square(x.float())) for x in tree.values())
    return torch.sqrt(sq)


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
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-6), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())
    m_all, v_all = opt_state["m"], opt_state["v"]
    for name, p in named(params).items():
        g = grads[name].float() * scale
        m = m_all[name].mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v = v_all[name].mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        d = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * d).to(p.dtype))
    opt_state = {"m": m_all, "v": v_all, "step": step}
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
