"""Decoupled sharing: address-sliced home L1 caches [Ibrahim'20/'21].

Every request — hit or miss — is routed to the home cache its address
hashes to and pays that home's bank-port queue.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import tagarray
from repro_torch.core.arch.base import (TAG_CHECK, ArchPolicy, L1Outcome,
                                        RequestBatch)
from repro_torch.core.contention import group_rank


@dataclasses.dataclass(frozen=True)
class DecoupledPolicy(ArchPolicy):
    name: str = "decoupled"

    def l1_stage(self, geom, l1: tagarray.TagState, reqs: RequestBatch, t,
                 *, backend=None) -> L1Outcome:
        del backend   # no probe chain to lower
        G = geom.cluster_size
        addr = reqs.addr
        home = reqs.cluster * G + addr % G
        home_set = (addr // G) % geom.l1_sets
        home_bank = home_set % geom.l1_banks
        hit, way, _ = tagarray.probe(l1, home, home_set, addr,
                                     policy=self.replacement)
        # every request, hit or miss, pays the home bank-port queue; the
        # bank is a serial resource, so its busy time is also a
        # throughput (occupancy) bound warps cannot hide.
        key = home * geom.l1_banks + home_bank
        rank, size = group_rank(key, torch.ones_like(hit),
                                geom.n_cores * geom.l1_banks)
        delay = rank.to(torch.float32) * geom.svc_bank
        occupancy = size.to(torch.float32) * geom.svc_bank
        l1 = tagarray.touch(l1, home, home_set, way, t, hit,
                            set_dirty=reqs.is_write)
        return L1Outcome(
            l1=l1,
            served=hit,
            l1_time=torch.where(hit, geom.lat_l1 + geom.lat_home + delay,
                                TAG_CHECK + delay),
            go_l2=~hit,
            pre_l2=TAG_CHECK + delay,
            occupancy=occupancy,
            fill_cache=home,
            fill_set=home_set,
            local_hits=hit,
            remote_hits=torch.zeros_like(hit),
            noc_flits=hit.sum(dim=-1) * geom.point("flits_per_line"),
            # home-cache hits ship the line from the home core's port; a
            # line whose home is the requesting core never leaves it
            noc_src=home,
            noc_req_flits=(hit & (home != reqs.core)) * geom.flits_per_line,
        )
