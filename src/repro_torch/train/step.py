"""Training step: loss -> grad -> clip -> AdamW, with optional microbatch
gradient accumulation, on one device or over a ``DeviceMesh``.

The port of the reference's ``train/step.py``. Gradients come from
autograd through the plain routes (``attention_impl`` "blocked" or
"ref"), as the reference's training reaches no Pallas kernel. The
kernel route raises here: the Hopper kernels have no backward pass, so
its gradients would be wrong.

The train state is ``{"params": Transformer, "opt": {"m", "v", "step"}}``
(see :mod:`repro_torch.optim.adamw`); a step updates it in place and
returns it.

Over a mesh (``make_train_step(..., mesh=, rules=)``, one process per
device; :mod:`repro_torch.sharding`), the state is placed by
:func:`train_state_shardings` (the reference's
``specs.train_state_shardings``): the parameters by the rules'
``param_placements``, m and v by ZeRO-1 (:func:`zero1_placements`).
Each rank passes its own slice of the global batch (:func:`local_batch`
cuts it: with accumulation, its share of each microbatch), and the loss
is the reference's: microbatch i is global rows [i mb, (i+1) mb), each
with its own mean loss.

  * Rules that shard no parameter ("dp", the reference's pure data
    parallelism) keep the parameters plain, replicated tensors: each rank
    runs the one-device forward and backward on its slice, weighting its
    loss by the microbatch's global count of unpadded tokens, and the
    gradients are reduce-scattered onto the ZeRO-1 shards
    (:func:`~repro_torch.optim.adamw.apply_updates_sharded`). The model
    sees the slices (``slices_context``): MoE's groups, capacities and
    aux loss are the global batch's, each rank adding its share.
  * Rules that shard parameters ("tp") make them DTensors and the batch
    a DTensor sharded over the data axes; the forward runs under the
    rules (``annotate``) with plain tensors made inside the model
    (positions, masks) taken as replicated
    (``implicit_replication``). The one op with no working rule, the
    loss's gather of the gold token from vocab-sharded logits, runs on
    logits made whole first (:mod:`repro_torch.train.loss`).

Remat (``torch.utils.checkpoint``) and the chunked loss run under both.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                     apply_updates_sharded, init_opt_state,
                                     zero1_placements)
from repro_torch.sharding.rules import (Rules, logical_to_spec,
                                        param_placements, place,
                                        place_params, rules_context,
                                        slices_context,
                                        slices_of)
from repro_torch.train.loss import chunked_xent_sum

AUX_WEIGHT = 0.01

State = Dict[str, Any]


def loss_terms(params: T.Transformer, cfg: ModelConfig, batch):
    """(summed token cross-entropy, count of unpadded tokens, MoE aux
    loss) of ``batch``, which holds ``tokens``, ``labels`` and, for an
    encoder-decoder, ``enc_frames``."""
    h, aux = T.forward_hidden(params, cfg, batch["tokens"],
                              enc_frames=batch.get("enc_frames"))
    tot, cnt = chunked_xent_sum(params, cfg, h, batch["labels"])
    return tot, cnt, aux


def loss_fn(params: T.Transformer, cfg: ModelConfig, batch) -> torch.Tensor:
    """Mean token cross-entropy plus ``AUX_WEIGHT`` x the MoE aux loss
    (see :func:`loss_terms`)."""
    tot, cnt, aux = loss_terms(params, cfg, batch)
    return tot / torch.clamp(cnt, min=1).float() + AUX_WEIGHT * aux


def check_trainable(cfg: ModelConfig) -> None:
    """Raise for a route that autograd cannot differentiate."""
    if cfg.attention_impl == "kernel":
        raise ValueError(
            f"{cfg.name}: attention_impl='kernel' cannot train (the Hopper "
            "kernels have no backward pass); use 'blocked' (the reference's "
            "default) or 'ref'")


def _microbatches(batch: Mapping[str, torch.Tensor], accum_steps: int):
    n = next(iter(batch.values())).shape[0]
    if n % accum_steps:
        raise ValueError(f"batch of {n} does not split into "
                         f"{accum_steps} microbatches")
    mb = n // accum_steps
    return [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            for i in range(accum_steps)]


def _grads(params: nn.Module) -> Dict[str, torch.Tensor]:
    return {name: torch.zeros_like(p) if p.grad is None else p.grad
            for name, p in params.named_parameters()}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    accum_steps: int = 1, *, mesh=None,
                    rules: Optional[Rules] = None):
    """Returns train_step(state, batch) -> (state, metrics), metrics
    ``loss``, ``grad_norm`` and ``lr`` (f32 scalars on the card). With
    ``accum_steps`` > 1 the batch is split along its first axis into that
    many microbatches whose losses and gradients are summed, then divided
    by ``accum_steps``. With ``mesh`` and ``rules`` the state must be
    placed by :func:`place_train_state` and ``batch`` is this rank's
    slice (see the module docstring); the metrics are the same on every
    rank."""
    check_trainable(cfg)
    if mesh is not None:
        return _sharded_step(cfg, opt_cfg, accum_steps, mesh, rules)

    def train_step(state: State, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[State, Dict[str, torch.Tensor]]:
        params = state["params"]
        params.zero_grad(set_to_none=True)
        micros = _microbatches(batch, accum_steps)
        loss = torch.zeros((), device=params.embed.table.device)
        for micro in micros:
            with torch.enable_grad():
                l = loss_fn(params, cfg, micro)
                l.backward()          # sums into .grad across microbatches
            loss = loss + l.detach()
        grads = _grads(params)
        if accum_steps > 1:
            loss = loss / accum_steps
            grads = {k: g / accum_steps for k, g in grads.items()}
        params, opt, metrics = apply_updates(opt_cfg, params, grads,
                                             state["opt"])
        params.zero_grad(set_to_none=True)
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    return train_step


# ---------------------------------------------------------------------------
# over a mesh
# ---------------------------------------------------------------------------
def train_state_shardings(params, cfg: ModelConfig, mesh, rules: Rules
                          ) -> Dict[str, Any]:
    """{"params": {name: placements}, "opt": {"m", "v": {name:
    placements}, "step": placements}} of a train state on ``mesh``: the
    rules' parameter placements, and ZeRO-1's for the moments.
    ``params`` gives the names and shapes (``meta`` tensors do)."""
    psh = param_placements(params, mesh, rules)
    return {"params": psh, "opt": zero1_placements(
        psh, mesh, params, stacked=_stack_lengths(cfg, params))}


def _stack_lengths(cfg: ModelConfig, params) -> Dict[str, int]:
    """{parameter name: the length of the reference's stack that holds
    it}: a decoder layer's pattern periods (``T.layer_keys``), the
    encoder's layers; 1 for the rest."""
    keys = T.layer_keys(cfg)
    periods = 1 + max((g for stack, _, g in keys if stack == "layers"),
                      default=-1)
    names = (dict(params.named_parameters()) if isinstance(params, nn.Module)
             else params)
    out = {}
    for n in names:
        head, _, rest = n.partition(".")
        if head == "layers" and keys[int(rest.split(".")[0])][0] == "layers":
            out[n] = periods
        elif head == "encoder":
            out[n] = cfg.encoder_layers
        else:
            out[n] = 1
    return out


def shards_params(placements: Mapping[str, tuple]) -> bool:
    """Whether any parameter is sharded (the "tp" profile's DTensor
    parameters) rather than replicated on every rank."""
    from torch.distributed.tensor import Replicate
    return any(p != Replicate() for pl in placements.values() for p in pl)


def state_placements(params, cfg: ModelConfig, mesh, rules: Rules
                     ) -> Dict[str, Any]:
    """The placements :func:`place_train_state` gives a state, shaped as
    the state (``CheckpointStore.restore``'s ``placements=``): the
    parameters' only when the rules shard one of them (else they stay
    plain tensors), m's and v's always; the step stays a plain tensor."""
    sh = train_state_shardings(params, cfg, mesh, rules)
    psh = sh["params"] if shards_params(sh["params"]) else {}
    return {"params": psh, "opt": {"m": sh["opt"]["m"],
                                   "v": sh["opt"]["v"]}}


def place_train_state(state: State, cfg: ModelConfig, mesh, rules: Rules
                      ) -> State:
    """A one-device train state (the same on every rank: made from one
    seed, or restored) placed on ``mesh`` (:func:`state_placements`):
    the parameters made DTensors when the rules shard any of them, m and
    v ZeRO-1 DTensors holding this rank's shard of the given moments.
    ``state`` is left as it was."""
    params = state["params"]
    sh = state_placements(params, cfg, mesh, rules)
    if sh["params"]:
        params = place_params(params, mesh, sh["params"])
    opt = {key: {k: place(t, mesh, sh["opt"][key][k])
                 for k, t in state["opt"][key].items()}
           for key in ("m", "v")}
    opt["step"] = state["opt"]["step"].clone()
    return {"params": params, "opt": opt}


def batch_placements(mesh, rules: Rules) -> tuple:
    """The DTensor placements of a batch tensor (batch axis first)."""
    return logical_to_spec(("batch",), rules, mesh)


def batch_shard(mesh, rules: Rules) -> Tuple[int, int]:
    """(number of batch slices, this rank's slice): the global batch is
    split along its first axis over the mesh dimensions the rules'
    ``batch`` axes name, in mesh order; ranks that differ only along the
    other dimensions take the same slice."""
    from torch.distributed.tensor import Replicate
    n, i = 1, 0
    for d, p in enumerate(batch_placements(mesh, rules)):
        if p != Replicate():
            size = mesh.mesh.shape[d]
            n, i = n * size, i * size + mesh.get_local_rank(d)
    return n, i


def local_batch(batch: Mapping[str, torch.Tensor], mesh, rules: Rules,
                accum_steps: int = 1) -> Dict[str, torch.Tensor]:
    """This rank's slice of a global batch (see :func:`batch_shard`): its
    share of each of the ``accum_steps`` microbatches (global rows
    [i mb, (i+1) mb), the reference's), one after another, so that the
    step's microbatch i on every rank is its part of global microbatch
    i."""
    n, i = batch_shard(mesh, rules)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % (n * accum_steps):
            raise ValueError(f"a batch of {v.shape[0]} does not split into "
                             f"{accum_steps} microbatches over {n} ranks")
        mb = v.shape[0] // accum_steps
        s = mb // n
        out[k] = torch.cat([v[j * mb + i * s:j * mb + (i + 1) * s]
                            for j in range(accum_steps)])
    return out


def _sharded_step(cfg: ModelConfig, opt_cfg: AdamWConfig, accum_steps: int,
                  mesh, rules: Rules):
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import implicit_replication
    bp = batch_placements(mesh, rules)
    # a per-rank value summed over the batch slices
    over_batch = tuple(Replicate() if p == Replicate() else Partial()
                       for p in bp)
    slices = slices_of(mesh, bp)

    def summed(t: torch.Tensor) -> torch.Tensor:
        return DTensor.from_local(t, mesh, over_batch,
                                  run_check=False).full_tensor()

    def train_step(state: State, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[State, Dict[str, torch.Tensor]]:
        params = state["params"]
        placements = param_placements(params, mesh, rules)
        params.zero_grad(set_to_none=True)
        micros = _microbatches(batch, accum_steps)
        sharded = shards_params(placements)
        loss = None
        if sharded:
            ctx = contextlib.ExitStack()
            ctx.enter_context(rules_context(mesh, rules))
            ctx.enter_context(implicit_replication())
            with ctx, torch.enable_grad():
                for micro in micros:
                    micro = {k: DTensor.from_local(
                        v, mesh, bp, run_check=False)
                        for k, v in micro.items()}
                    l = loss_fn(params, cfg, micro) / accum_steps
                    l.backward()
                    l = l.detach().full_tensor()
                    loss = l if loss is None else loss + l
            grads, grad_pl = _grads(params), None
        else:
            # each microbatch's loss over the global batch: each slice's
            # summed cross-entropy over the microbatch's global count of
            # unpadded tokens, and its share of the MoE aux loss (the
            # model reads the slices from the context)
            counts = summed(torch.stack([(m["labels"] >= 0).sum()
                                         for m in micros])).float()
            with slices_context(slices), torch.enable_grad():
                for micro, count in zip(micros, counts):
                    tot, _, aux = loss_terms(params, cfg, micro)
                    l = (tot / torch.clamp(count, min=1)
                         + AUX_WEIGHT * aux) / accum_steps
                    l.backward()
                    loss = l.detach() if loss is None else loss + l.detach()
            loss = summed(loss)
            grads, grad_pl = _grads(params), over_batch
        params, opt, metrics = apply_updates_sharded(
            opt_cfg, params, grads, state["opt"], mesh=mesh,
            param_placements=placements, grad_placements=grad_pl)
        params.zero_grad(set_to_none=True)
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    return train_step


def init_train_state(cfg: ModelConfig, *, generator: torch.Generator,
                     device="cuda", mesh=None,
                     rules: Optional[Rules] = None) -> State:
    """Random parameters from ``generator`` (on ``device``), made
    trainable, and a zero optimizer state; with ``mesh`` and ``rules``,
    placed on the mesh (:func:`place_train_state`; every rank draws the
    same weights from the same seed)."""
    params = T.init_params(cfg, generator=generator, device=device)
    params.requires_grad_(True)
    state = {"params": params, "opt": init_opt_state(params)}
    if mesh is not None:
        state = place_train_state(state, cfg, mesh, rules)
    return state
