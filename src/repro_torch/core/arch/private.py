"""Baseline architecture: per-core private L1, misses go straight to L2."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import tagarray
from repro_torch.core.arch.base import (TAG_CHECK, ArchPolicy, L1Outcome,
                                        RequestBatch)


@dataclasses.dataclass(frozen=True)
class PrivatePolicy(ArchPolicy):
    name: str = "private"

    def l1_stage(self, geom, l1: tagarray.TagState, reqs: RequestBatch, t,
                 *, backend=None) -> L1Outcome:
        del backend   # no probe chain to lower
        hit, way, _ = tagarray.probe(l1, reqs.core, reqs.set_idx, reqs.addr,
                                     policy=self.replacement)
        l1 = tagarray.touch(l1, reqs.core, reqs.set_idx, way, t, hit,
                            set_dirty=reqs.is_write)
        f32 = dict(dtype=torch.float32, device=hit.device)
        return L1Outcome(
            l1=l1,
            served=hit,
            l1_time=torch.where(hit, geom.lat_l1, float(TAG_CHECK)),
            go_l2=~hit,
            pre_l2=torch.full(hit.shape, float(TAG_CHECK), **f32),
            occupancy=torch.zeros(hit.shape, **f32),
            fill_cache=reqs.core,
            fill_set=reqs.set_idx,
            local_hits=hit,
            remote_hits=torch.zeros_like(hit),
            noc_flits=torch.zeros(hit.shape[:1], **f32),
        )
