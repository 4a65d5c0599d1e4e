"""Sequence-chunked softmax cross-entropy.

The port of the reference's ``train/loss.py``. The (B, S, V) logits of a
large-vocab model are never held whole: the final hidden states are
taken in sequence chunks, and each chunk projects to the (padded) vocab
and takes its loss under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``), so backward recomputes a chunk's logits instead of
keeping them. Like the reference, the log-sum-exp runs over the padded
vocab as ``lm_logits`` returns it.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import annotate


def _chunk_xent(params, cfg: ModelConfig, h_chunk, labels_chunk):
    from repro_torch.models.transformer import lm_logits
    logits = lm_logits(params, cfg, h_chunk)          # (B, c, V) f32
    # under tensor parallelism the vocab is sharded; the gold-token
    # gather has no working rule there, so the chunk's logits are
    # gathered whole first (a no-op outside a rules context)
    logits = annotate(logits, "batch", "seq", None)
    mask = labels_chunk >= 0
    labels_safe = torch.where(mask, labels_chunk, 0)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum(), mask.sum()


def chunked_xent_sum(params, cfg: ModelConfig, h, labels,
                     chunk: int = 128):
    """(the summed token cross-entropy over the unpadded positions (f32),
    their count (int64)) of h (B, S, d) final hidden states against
    labels (B, S) with -1 = pad. The chunk is ``min(chunk, S)``, shrunk
    until it divides S."""
    # under tensor parallelism the residual stream is sequence-sharded;
    # slicing a sharded sequence and flattening (B, T) in the head's
    # matmul have no rule that redistributes (torch 2.11 refuses the
    # flatten), so the hidden states are gathered over the sequence
    # first (a no-op outside a rules context)
    h = annotate(h, "batch", "seq", "embed")
    S = h.shape[1]
    labels = torch.as_tensor(labels, device=h.device).long()
    c = min(chunk, S)
    while S % c:
        c -= 1
    tot = torch.zeros((), device=h.device)
    cnt = torch.zeros((), dtype=torch.int64, device=h.device)
    for i in range(S // c):
        hc, lc = h[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        if torch.is_grad_enabled() and h.requires_grad:
            s, m = checkpoint(_chunk_xent, params, cfg, hc, lc,
                              use_reentrant=False)
        else:
            s, m = _chunk_xent(params, cfg, hc, lc)
        tot = tot + s
        cnt = cnt + m
    return tot, cnt


def chunked_cross_entropy(params, cfg: ModelConfig, h, labels,
                          chunk: int = 128) -> torch.Tensor:
    """h (B, S, d) final hidden states; labels (B, S) with -1 = pad.
    Returns the mean loss over the unpadded positions (f32 scalar)."""
    tot, cnt = chunked_xent_sum(params, cfg, h, labels, chunk)
    return tot / torch.clamp(cnt, min=1).float()
