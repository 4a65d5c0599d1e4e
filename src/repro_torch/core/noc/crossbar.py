"""Crossbar interconnect: per-port arbitration with carried backpressure.

Each core's remote-data port is a crossbar output with a finite
injection queue. Flits a request moves across the NoC arrive at the
*serving* core's port; the port forwards at
``port_rate = noc_bw / cluster_size`` flits/cycle for a drain window of
``noc_drain`` cycles per round. What the window cannot forward stays in
the port queue **across rounds**, and occupancy beyond the
``noc_queue`` capacity stalls the port's sources for the overflow's
drain time on top.

Per-request delay =

    standing backlog ahead of me   queue[port] / rate
  + same-round flits ahead of me   group_prefix_sum(...) / rate
  + backpressure stall             overflow[port] / rate

and the port's whole supply is a serial-resource occupancy bound.
Conservation — ``injected == delivered + queued`` — holds round by
round.

The port-arrival scatter-add runs as atomics on a card, in no fixed
order. Flit counts are small whole numbers (4 per line or block), so
the float32 sums are exact in any order; the fractional ``sent``
amounts of a non-power-of-two rate only enter elementwise arithmetic
and the ``delivered`` total.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.contention import group_prefix_sum
from repro_torch.core.noc.base import (NocModel, NocState, NocTraffic,
                                       NocTransit, port_rate)


@dataclasses.dataclass(frozen=True)
class CrossbarNoc(NocModel):
    name: str = "crossbar"

    def n_links(self, geom) -> int:
        return geom.n_cores          # one injection port per core

    def transit(self, geom, state: NocState,
                traffic: NocTraffic) -> NocTransit:
        queue = state["queue"]                       # (P, L)
        L = queue.shape[-1]
        f32 = dict(dtype=torch.float32, device=queue.device)
        rate = port_rate(geom)
        use = traffic.crossing       # src == dst never enters the network
        flits = torch.where(use, traffic.flits, 0.0)
        port = traffic.src.long()

        arrivals = torch.zeros(queue.shape, **f32).scatter_add(-1, port,
                                                               flits)
        supply = queue + arrivals
        avail = torch.as_tensor(rate * geom.noc_drain, **f32)
        sent = torch.minimum(supply, avail)
        queued = supply - sent
        overflow = torch.clamp_min(queued - geom.noc_queue, 0.0)

        ahead, _ = group_prefix_sum(port, flits, use, L)
        delay = torch.where(
            use,
            (queue.gather(-1, port) + ahead + overflow.gather(-1, port))
            / rate,
            0.0)
        occupancy = torch.where(use, supply.gather(-1, port) / rate, 0.0)

        new_state = dict(
            state,
            queue=queued,
            link_flits=state["link_flits"] + sent,
            link_busy=state["link_busy"] + sent / rate,
        )
        new_state = self._count(new_state, traffic, delay,
                                injected=arrivals.sum(dim=-1),
                                delivered=sent.sum(dim=-1))
        return NocTransit(state=new_state, delay=delay,
                          occupancy=occupancy)
