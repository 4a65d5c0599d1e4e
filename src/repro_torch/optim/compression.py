"""Int8 error-feedback gradient compression.

The port of the reference's ``optim/compression.py``: before a
data-parallel gradient reduction each replica quantizes its gradient to
int8 with a per-tensor scale and keeps the quantization residual in a
local error-feedback buffer that is added back the next step (EF-SGD
semantics, int8 variant). ``torch.round``, like ``jnp.round``, rounds
half to even, so the payloads are the reference's bit for bit.

:func:`all_reduce_compressed` is the collective across data-parallel
ranks (the reference's, a ``shard_map`` ``psum``): the per-tensor scales
are made one with an ``all_reduce(MAX)``, every rank re-quantizes
against the shared scale, and the int8 payloads are summed exactly as
int32 by an ``all_reduce`` (``torch.distributed``; NCCL on the cards).
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

Tree = Mapping[str, torch.Tensor]


def compress(g: torch.Tensor, err: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(grad, error_buffer) -> (q int8, scale f32 scalar, new_error)."""
    g32 = g.float() + err
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    new_err = g32 - q.float() * scale
    return q, scale, new_err


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_buffers(grads: Tree) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}


def ef_compress_tree(grads: Tree, errors: Tree
                     ) -> Tuple[Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor]]:
    """:func:`compress` of every leaf: ({name: q}, {name: scale},
    {name: new error})."""
    qs, scales, errs = {}, {}, {}
    for k, g in grads.items():
        qs[k], scales[k], errs[k] = compress(g, errors[k])
    return qs, scales, errs


def all_reduce_compressed(grads: Tree, errors: Tree, group=None
                          ) -> Tuple[Dict[str, torch.Tensor],
                                     Dict[str, torch.Tensor]]:
    """Mean-reduce int8-compressed gradients over the ranks of ``group``
    (default: every rank); each rank passes its own ``grads`` and error
    buffers. Returns (the reduced f32 gradients, the same on every rank;
    this rank's new error buffers).

    Per leaf: the scale of :func:`compress` is shared by an
    ``all_reduce(MAX)``; the gradient plus its error is re-quantized
    against the shared scale, so the sum of the int8 payloads, taken as
    int32 (exact for up to 2**24 ranks), is every rank's to the last
    bit; the result is ``total * s_shared / n`` and the new error
    ``g32 - q * s_shared`` (the reference's formulas)."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    out, errs = {}, {}
    for k, g in grads.items():
        _, s, _ = compress(g, errors[k])
        s_shared = s.clone()
        dist.all_reduce(s_shared, op=dist.ReduceOp.MAX, group=group)
        g32 = g.float() + errors[k]
        q = torch.clamp(torch.round(g32 / s_shared), -127, 127).to(
            torch.int8)
        errs[k] = g32 - q.float() * s_shared
        total = q.int()
        dist.all_reduce(total, group=group)
        out[k] = total.float() * s_shared / n
    return out, errs
