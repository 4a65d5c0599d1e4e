"""Training step: loss -> grad -> clip -> AdamW, with optional microbatch
gradient accumulation.

The port of the reference's ``train/step.py``. Gradients come from
autograd through the plain routes (``attention_impl`` "blocked" or
"ref"), as the reference's training reaches no Pallas kernel. The
kernel route raises here: the Hopper kernels have no backward pass, so
its gradients would be wrong.

The train state is ``{"params": Transformer, "opt": {"m", "v", "step"}}``
(see :mod:`repro_torch.optim.adamw`); a step updates it in place and
returns it.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                     init_opt_state)
from repro_torch.train.loss import chunked_cross_entropy

AUX_WEIGHT = 0.01

State = Dict[str, Any]


def loss_fn(params: T.Transformer, cfg: ModelConfig, batch) -> torch.Tensor:
    """Mean token cross-entropy plus ``AUX_WEIGHT`` x the MoE aux loss;
    ``batch`` holds ``tokens``, ``labels`` and, for an encoder-decoder,
    ``enc_frames``."""
    h, aux = T.forward_hidden(params, cfg, batch["tokens"],
                              enc_frames=batch.get("enc_frames"))
    loss = chunked_cross_entropy(params, cfg, h, batch["labels"])
    return loss + AUX_WEIGHT * aux


def check_trainable(cfg: ModelConfig) -> None:
    """Raise for a route that autograd cannot differentiate."""
    if cfg.attention_impl == "kernel":
        raise ValueError(
            f"{cfg.name}: attention_impl='kernel' cannot train (the Hopper "
            "kernels have no backward pass); use 'blocked' (the reference's "
            "default) or 'ref'")


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    accum_steps: int = 1):
    """Returns train_step(state, batch) -> (state, metrics), metrics
    ``loss``, ``grad_norm`` and ``lr`` (f32 scalars on the card). With
    ``accum_steps`` > 1 the batch is split along its first axis into that
    many microbatches whose losses and gradients are summed, then divided
    by ``accum_steps``."""
    check_trainable(cfg)

    def train_step(state: State, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[State, Dict[str, torch.Tensor]]:
        params = state["params"]
        params.zero_grad(set_to_none=True)
        n = next(iter(batch.values())).shape[0]
        if n % accum_steps:
            raise ValueError(f"batch of {n} does not split into "
                             f"{accum_steps} microbatches")
        mb = n // accum_steps
        loss = torch.zeros((), device=params.embed.table.device)
        for i in range(accum_steps):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            with torch.enable_grad():
                l = loss_fn(params, cfg, micro)
                l.backward()          # sums into .grad across microbatches
            loss = loss + l.detach()
        grads = {name: torch.zeros_like(p) if p.grad is None else p.grad
                 for name, p in params.named_parameters()}
        if accum_steps > 1:
            loss = loss / accum_steps
            grads = {k: g / accum_steps for k, g in grads.items()}
        params, opt, metrics = apply_updates(opt_cfg, params, grads,
                                             state["opt"])
        params.zero_grad(set_to_none=True)
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    return train_step


def init_train_state(cfg: ModelConfig, *, generator: torch.Generator,
                     device="cuda") -> State:
    """Random parameters from ``generator`` (on ``device``), made
    trainable, and a zero optimizer state."""
    params = T.init_params(cfg, generator=generator, device=device)
    params.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(params)}
