"""Int8 error-feedback gradient compression.

The port of the reference's ``optim/compression.py``: before a
data-parallel gradient reduction each replica quantizes its gradient to
int8 with a per-tensor scale and keeps the quantization residual in a
local error-feedback buffer that is added back the next step (EF-SGD
semantics, int8 variant). ``torch.round``, like ``jnp.round``, rounds
half to even, so the payloads are the reference's bit for bit. The
reference's ``all_reduce_compressed`` (a collective across replicas)
has no counterpart on one card.
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
