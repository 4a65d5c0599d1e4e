"""Ring interconnect: hop-distance latency + per-link flit accounting.

Each cluster's cores sit on a bidirectional ring (one position per
cluster slot); a remote transfer from serving core to requesting core
travels the shorter arc, paying ``ring_hop`` cycles per hop, and its
flits occupy every link along that arc. Link ``c * G + p`` connects
cluster ``c``'s positions ``p`` and ``(p+1) % G``.

Delay is the pure hop latency; the contention signal is *occupancy*:
the busiest link on a request's path serializes the round's flit-hops
at ``port_rate = noc_bw / cluster_size`` flits/cycle. ``src == dst``
traffic has hop distance zero and never enters the ring.

Everything injected is delivered within the round, so conservation
holds with an always-empty carried queue. ``link_flits`` counts
flit-*hops* per link; ``injected``/``delivered`` count at injection
granularity like every other model.

The per-link scatter-add runs as atomics on a card, in no fixed order;
its terms are whole flit counts, so the float32 sums are exact. The
delays (hops times ``ring_hop``) need not be whole, so their round total
adds in float64 (``base.point_sum``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.noc.base import (NocModel, NocState, NocTraffic,
                                       NocTransit, point_sum, port_rate)


@dataclasses.dataclass(frozen=True)
class RingNoc(NocModel):
    name: str = "ring"

    def n_links(self, geom) -> int:
        return geom.n_cores          # G links per cluster ring

    def transit(self, geom, state: NocState,
                traffic: NocTraffic) -> NocTransit:
        P, R = traffic.src.shape
        G = geom.cluster_size
        rate = port_rate(geom)
        use = traffic.crossing       # src == dst never enters the network
        flits = torch.where(use, traffic.flits, 0.0)

        s = (traffic.src % G).long()[..., None]              # (P, R, 1)
        d = (traffic.dst % G).long()[..., None]
        fwd = (d - s) % G
        bwd = (s - d) % G
        go_fwd = fwd <= bwd
        dist = torch.minimum(fwd, bwd)[..., 0].to(torch.float32)

        # Links on the shorter arc, within the request's own cluster:
        # forward from s uses ring links s..s+fwd-1, backward uses
        # s-1..s-bwd (all mod G), offset into the cluster's link block.
        lpos = torch.arange(G, device=s.device)               # (G,)
        on_path = torch.where(go_fwd, (lpos - s) % G < fwd,
                              (s - 1 - lpos) % G < bwd)       # (P, R, G)
        link = (traffic.cluster.long()[..., None] * G
                + lpos).reshape(P, R * G)
        hop_flits = torch.where(on_path & use[..., None],
                                flits[..., None], 0.0)
        link_load = torch.zeros_like(state["queue"]).scatter_add(
            -1, link, hop_flits.reshape(P, R * G))

        # Bottleneck serialization: the busiest link on my path this
        # round bounds my cluster-ring throughput.
        path_load = torch.where(
            on_path, link_load.gather(-1, link).reshape(P, R, G),
            0.0).amax(dim=-1)
        delay = torch.where(use, dist * geom.ring_hop, 0.0)
        occupancy = torch.where(use, path_load / rate, 0.0)

        total = flits.sum(dim=-1)
        new_state = dict(
            state,
            link_flits=state["link_flits"] + link_load,
            link_busy=state["link_busy"] + link_load / rate,
        )
        new_state = self._count(new_state, traffic, delay,
                                injected=total, delivered=total,
                                sum_delays=point_sum)
        return NocTransit(state=new_state, delay=delay,
                          occupancy=occupancy)
