"""Ideal interconnect: infinite bandwidth, zero added latency.

``transit`` adds zero delay and zero occupancy (``x + 0.0`` and
``max(x, 0.0)`` are exact for the non-negative timing values) and only
folds the flit totals into the conservation counters: everything
injected is delivered in the same round, nothing queues.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.noc.base import (NocModel, NocState, NocTraffic,
                                       NocTransit)


@dataclasses.dataclass(frozen=True)
class IdealNoc(NocModel):
    name: str = "ideal"

    def transit(self, geom, state: NocState,
                traffic: NocTraffic) -> NocTransit:
        zeros = torch.zeros_like(traffic.flits)
        total = torch.where(traffic.crossing, traffic.flits, 0.0).sum(dim=-1)
        state = self._count(state, traffic, zeros,
                            injected=total, delivered=total)
        return NocTransit(state=state, delay=zeros, occupancy=zeros)
