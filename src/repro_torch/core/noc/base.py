"""Interconnect-model interface for the cache-hierarchy simulator.

The L1-complex interconnect carries remote-*probe* and remote-*data*
flits between the caches of a cluster. A :class:`NocModel` receives one
round's NoC traffic (one entry per request: serving core, requesting
core, flits) plus the NoC state carried across rounds, and returns
extra per-request delay, extra serial-resource occupancy, and the
updated state. The policies' own memoryless per-round contention stays
where it is; a model adds topology effects on top — or, for ``ideal``,
nothing at all.

State (every tensor has the leading simulation-point axis P):

    queue      : (P, L) float32  flits waiting per injection port
    link_flits : (P, L) float32  cumulative flits forwarded per link/port
    link_busy  : (P, L) float32  cumulative service cycles per link/port
    injected   : (P,) float32    cumulative flits entering the NoC
    delivered  : (P,) float32    cumulative flits leaving the NoC
    delay_sum  : (P,) float32    summed per-request NoC delay
    delay_n    : (P,) float32    requests that crossed the NoC

with ``L = NocModel.n_links(geom)`` (0 for ``ideal``). Conservation:
``injected == delivered + queue.sum()`` after every round.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import torch

NocState = Dict[str, torch.Tensor]


class NocTraffic(NamedTuple):
    """One round's L1-complex NoC traffic, one (P, R) entry per request.

    ``src`` is the core whose cache serves the request (``== dst`` when
    nothing crosses), ``dst`` the requesting core; ``flits`` counts the
    request's probe + data flits on this network; ``mask`` selects the
    requests whose critical path includes the NoC.
    """
    src: torch.Tensor      # (P, R) int serving core
    dst: torch.Tensor      # (P, R) int requesting core
    cluster: torch.Tensor  # (P, R) int cluster of the requesting core
    flits: torch.Tensor    # (P, R) float32 flits injected by this request
    mask: torch.Tensor     # (P, R) bool request traverses the NoC

    @property
    def crossing(self) -> torch.Tensor:
        """(P, R) bool — entries that actually enter the network: masked,
        carrying flits, and between *distinct* cores."""
        return self.mask & (self.flits > 0) & (self.src != self.dst)


class NocTransit(NamedTuple):
    """What the NoC did with one round's traffic."""
    state: NocState            # updated carried state
    delay: torch.Tensor        # (P, R) float32 extra cycles on the path
    occupancy: torch.Tensor    # (P, R) float32 extra serial busy time


def init_noc_state(n_links: int, *, batch: int = 1,
                   device="cpu") -> NocState:
    """The carried NoC state (uniform keys; see module docstring)."""
    f = dict(dtype=torch.float32, device=device)
    return {
        "queue": torch.zeros((batch, n_links), **f),
        "link_flits": torch.zeros((batch, n_links), **f),
        "link_busy": torch.zeros((batch, n_links), **f),
        "injected": torch.zeros((batch,), **f),
        "delivered": torch.zeros((batch,), **f),
        "delay_sum": torch.zeros((batch,), **f),
        "delay_n": torch.zeros((batch,), **f),
    }


@dataclasses.dataclass(frozen=True)
class NocModel:
    """A pluggable interconnect model: subclasses implement
    :meth:`transit` and declare the link/port lanes of carried state
    they need with :meth:`n_links`."""
    name: str

    def n_links(self, geom) -> int:
        """Link/port lanes of carried state this model uses (0 = none)."""
        return 0

    def transit(self, geom, state: NocState,
                traffic: NocTraffic) -> NocTransit:
        raise NotImplementedError

    @staticmethod
    def _count(state: NocState, traffic: NocTraffic, delay, *,
               injected, delivered) -> NocState:
        """Fold one round's conservation + delay accounting into state."""
        crossed = traffic.crossing
        return dict(
            state,
            injected=state["injected"] + injected,
            delivered=state["delivered"] + delivered,
            delay_sum=state["delay_sum"]
            + torch.where(crossed, delay, 0.0).sum(dim=-1),
            delay_n=state["delay_n"] + crossed.sum(dim=-1).to(torch.float32),
        )
