"""Contention primitives over a leading simulation-point axis.

The paper's contention effects (decoupled-sharing bank conflicts, ATA
remote-port conflicts, remote-sharing probe queues, L2 partition queues)
are all instances of one primitive: requests arriving at a keyed resource
in the same round are served serially, so request *i* waits
``rank_i * svc`` cycles where ``rank_i`` is its position within its
conflict group, in arrival (request-index) order.

:func:`group_rank` counts with an exclusive cumulative sum over a
(P, R, n_keys) one-hot matrix: integer arithmetic, so its ranks equal
the reference's sort/segment-sum ranks bit for bit, at the sizes the
simulator uses (R <= a few hundred, n_keys <= n_cores * l1_banks).
:func:`group_prefix_sum` keeps the reference's sort/segment-sum
algorithm, because its float32 sums must round the same way.
"""
from __future__ import annotations

from typing import Tuple

import torch


def group_rank(keys, mask, n_keys: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank of each masked request within its key group, and group size.

    keys : (P, R) integer in [0, n_keys); mask : (P, R) bool.
    rank : (P, R) int32 — #earlier masked requests with the same key
           (0 if unmasked); size : (P, R) int32 — masked requests in the
           group (0 if unmasked).
    """
    k = keys.long()
    onehot = ((k[..., None] == torch.arange(n_keys, device=k.device))
              & mask[..., None]).to(torch.int32)            # (P, R, K)
    before = onehot.cumsum(dim=-2) - onehot                 # exclusive
    rank = before.gather(-1, k[..., None])[..., 0]
    size = onehot.sum(dim=-2).gather(-1, k)
    rank = torch.where(mask, rank, 0).to(torch.int32)
    size = torch.where(mask, size, 0).to(torch.int32)
    return rank, size


def group_prefix_sum(keys, values, mask, n_keys: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-request exclusive prefix sum and total of ``values`` by key.

    keys   : (P, R) integer in [0, n_keys); values : (P, R) float32 >= 0;
    mask   : (P, R) bool.
    before : (P, R) float32 — sum of earlier masked requests' values in
             the same key group (0 if unmasked);
    total  : (P, R) float32 — group total (0 if unmasked).

    The weighted generalization of :func:`group_rank`. Like the
    reference it sorts by a composite (key, index) key — masked-out
    requests last, arrival order kept inside a group — takes one global
    exclusive cumulative sum in that order, and subtracts each segment's
    base (recovered with a running max, since the sum never decreases).
    """
    P, R = keys.shape
    k = keys.long()
    v = torch.where(mask, values, 0.0).to(torch.float32)
    totals = torch.zeros((P, n_keys), dtype=torch.float32,
                         device=v.device).scatter_add(-1, k, v)
    total = torch.where(mask, totals.gather(-1, k), 0.0)
    if R == 0:
        return v, total
    ks = torch.where(mask, k, n_keys)
    composite = ks * R + torch.arange(R, device=k.device)
    order = composite.argsort(dim=-1)
    ks, vs = ks.gather(-1, order), v.gather(-1, order)
    csum = vs.cumsum(dim=-1) - vs
    is_new = torch.ones_like(ks, dtype=torch.bool)
    is_new[:, 1:] = ks[:, 1:] != ks[:, :-1]
    base = torch.where(is_new, csum, 0.0).cummax(dim=-1).values
    before = torch.zeros_like(v).scatter(-1, order, csum - base)
    return torch.where(mask, before, 0.0), total
