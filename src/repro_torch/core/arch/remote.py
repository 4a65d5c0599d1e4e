"""Remote sharing: broadcast probes to cluster peers [Dublish'16, Ibrahim'19].

A local miss queries every peer L1 in the cluster; the probe service
queue and NoC load delay sit on the critical path even when the line
ends up coming from L2.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import tagarray
from repro_torch.core.arch.base import (TAG_CHECK, ArchPolicy, L1Outcome,
                                        RequestBatch)
from repro_torch.core.contention import group_rank


@dataclasses.dataclass(frozen=True)
class RemotePolicy(ArchPolicy):
    name: str = "remote"

    def l1_stage(self, geom, l1: tagarray.TagState, reqs: RequestBatch, t,
                 *, backend=None) -> L1Outcome:
        del backend   # no probe chain to lower
        G = geom.cluster_size
        addr, set_idx = reqs.addr, reqs.set_idx
        hit, way, _ = tagarray.probe(l1, reqs.core, set_idx, addr,
                                     policy=self.replacement)
        miss = ~hit
        # broadcast probes: each miss queries all peers; probe service
        # queue per cluster + NoC load delay sit on the critical path.
        rank, n_miss = group_rank(reqs.cluster, miss, geom.n_clusters)
        probe_flits = n_miss.to(torch.float32) * (G - 1)
        noc_delay = probe_flits / geom.noc_bw
        probe_wait = (geom.lat_probe + rank.to(torch.float32)
                      * geom.svc_probe + noc_delay)
        rhits, _, _ = tagarray.probe_many(l1, reqs.peers, set_idx, addr)
        rhits = rhits & (torch.arange(G, device=addr.device)
                         != reqs.self_slot[..., None])
        remote_hit = miss & rhits.any(dim=-1)
        src_slot = rhits.to(torch.uint8).argmax(dim=-1)
        src_cache = reqs.cluster * G + src_slot
        prank, psize = group_rank(src_cache, remote_hit, geom.n_cores)
        xfer = geom.lat_xbar + prank.to(torch.float32) * geom.svc_port
        # every peer cache's tag port serves every probe in the cluster
        occupancy = torch.where(
            miss, n_miss.to(torch.float32) * geom.svc_probe, 0.0)
        occupancy = torch.maximum(
            occupancy,
            torch.where(remote_hit,
                        psize.to(torch.float32) * geom.svc_port, 0.0))
        l1 = tagarray.touch(l1, reqs.core, set_idx, way, t, hit,
                            set_dirty=reqs.is_write)
        return L1Outcome(
            l1=l1,
            served=hit | remote_hit,
            l1_time=torch.where(hit, geom.lat_l1,
                                TAG_CHECK + probe_wait
                                + torch.where(remote_hit, xfer, 0.0)),
            go_l2=miss & ~remote_hit,
            pre_l2=TAG_CHECK + probe_wait,   # probes extend the L2 path
            occupancy=occupancy,
            fill_cache=reqs.core,
            fill_set=set_idx,
            local_hits=hit,
            remote_hits=remote_hit,
            noc_flits=(miss.sum(dim=-1) * (G - 1) + remote_hit.sum(dim=-1)
                       * geom.point("flits_per_line")),
            # Topology models see only the point-to-point data transfers;
            # the broadcast probes are priced above, on their own channels.
            noc_src=torch.where(remote_hit, src_cache, reqs.core),
            noc_req_flits=remote_hit * geom.flits_per_line,
        )
