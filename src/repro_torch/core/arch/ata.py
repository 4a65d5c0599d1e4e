"""ATA: aggregated tag array probed in parallel at zero added latency.

Only *known* remote hits cross the crossbar; writes are local-only with
dirty-bit L2 diversion [the paper's coherence rule]. The tag-side
filtering — no probe traffic, no speculative data movement — is the
paper's core contention win.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import tagarray
from repro_torch.core.arch.base import (TAG_CHECK, ArchPolicy, L1Outcome,
                                        RequestBatch)
from repro_torch.core.probe import fused_probe_rank


@dataclasses.dataclass(frozen=True)
class AtaPolicy(ArchPolicy):
    name: str = "ata"

    @property
    def stack_key(self) -> str:
        # the whole ATA family (base, FIFO replacement, fill bypass,
        # victim buffer) shares one round dataflow
        return "ata"

    def _victim_prefilter(self, l1: tagarray.TagState, reqs: RequestBatch):
        """Hook: mask of requests a victim structure can serve locally.

        Probed on L1 miss *before* the remote path — a hit here is
        served inside the core's own L1 complex (one extra sequential
        tag check) and never enters the remote-port contention group or
        crosses the crossbar. The base policy has no victim structure:
        ``None`` leaves the stage as it is.
        """
        return None

    def l1_stage(self, geom, l1: tagarray.TagState, reqs: RequestBatch, t,
                 *, backend=None) -> L1Outcome:
        # victim prefilter: read misses served by a victim structure
        # (when the subclass provides one) skip the remote path.
        pre = self._victim_prefilter(l1, reqs)
        # aggregated tag array: all cluster tags compared in parallel,
        # zero added latency, zero probe traffic — plus winner pick and
        # remote-port arbitration, fused under the selected backend
        # (repro_torch.core.probe; the backends are bit-exact).
        pr = fused_probe_rank(geom, l1, reqs, pre_served=pre,
                              replacement=self.replacement,
                              backend=backend)
        local_hit, remote_ok = pr.local_hit, pr.remote_ok
        # only *actual* remote hits occupy the remote data port — the
        # filtering that is the paper's core contention win.
        occupancy = torch.where(
            remote_ok, pr.psize.to(torch.float32) * geom.svc_port, 0.0)
        served = local_hit | remote_ok
        l1_time = torch.where(
            local_hit, geom.lat_l1,
            torch.where(remote_ok,
                        geom.lat_l1 + geom.lat_xbar
                        + pr.prank.to(torch.float32) * geom.svc_port,
                        float(TAG_CHECK)))
        local_hits = local_hit
        if pre is not None:
            vserved = pre & ~local_hit & ~reqs.is_write
            served = served | vserved
            local_hits = local_hits | vserved
            l1_time = torch.where(vserved, geom.lat_l1 + float(TAG_CHECK),
                                  l1_time)
        l1 = tagarray.touch(l1, reqs.core, reqs.set_idx, pr.touch_way, t,
                            local_hit, set_dirty=reqs.is_write)
        return L1Outcome(
            l1=l1,
            served=served,
            l1_time=l1_time,
            go_l2=~served,
            pre_l2=torch.full(served.shape, float(TAG_CHECK),
                              dtype=torch.float32, device=served.device),
            occupancy=occupancy,
            fill_cache=reqs.core,
            fill_set=reqs.set_idx,
            local_hits=local_hits,
            remote_hits=remote_ok,
            noc_flits=remote_ok.sum(dim=-1) * geom.point("flits_per_line"),
            # only known remote hits put flits on the interconnect —
            # the tag-side filtering that is the paper's core win
            noc_src=torch.where(remote_ok, pr.src_cache, reqs.core),
            noc_req_flits=remote_ok * geom.flits_per_line,
        )
