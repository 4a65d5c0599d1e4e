"""ATA + per-core victim tag buffer (shared-resource survey, arXiv
1803.06958 §victim/insertion variants).

A small fully-associative FIFO buffer next to each L1 keeps the tags of
recently evicted lines. On an L1 miss it is probed *before* the
remote/aggregated path (the ``_victim_prefilter`` hook of
:class:`~repro_torch.core.arch.ata.AtaPolicy`): a read that hits a
victim entry is served inside the core's own L1 complex — one extra
sequential tag check (:data:`~repro_torch.core.arch.base.TAG_CHECK`
cycles) on top of the L1 latency — and never enters the remote-port
contention group or crosses the crossbar, even when a peer copy exists.
On the ``cuda`` probe backend those reads reach the probe kernel as
denied lanes. The hit line is promoted back into the L1 proper, its
buffer entry invalidated and swapped with whatever the promotion
evicted. Misses past the buffer behave exactly like the base ATA
policy, and writes never hit the buffer.

Entries come from evictions: the policy predicts the shared fill
stage's replacement decision (the same ``probe`` the fill stage runs on
the returned state) and captures the outgoing valid tags. Within a
round, duplicate evictions from one cache resolve last-writer-wins —
the buffer has a single fill port (``tagarray.victim_insert``).

``victim_ways=0`` disables the buffer; the policy is then bit-exact
with :class:`~repro_torch.core.arch.ata.AtaPolicy`.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import tagarray
from repro_torch.core.arch.ata import AtaPolicy
from repro_torch.core.arch.base import L1Outcome, RequestBatch


@dataclasses.dataclass(frozen=True)
class VictimPolicy(AtaPolicy):
    name: str = "victim"
    victim_ways: int = 8

    def _victim_prefilter(self, l1: tagarray.TagState, reqs: RequestBatch):
        if tagarray.victim_ways(l1) == 0:
            return None
        hit, _ = tagarray.victim_probe(l1, reqs.core, reqs.addr)
        return hit

    def l1_stage(self, geom, l1: tagarray.TagState, reqs: RequestBatch, t,
                 *, backend=None) -> L1Outcome:
        out = super().l1_stage(geom, l1, reqs, t, backend=backend)
        if tagarray.victim_ways(out.l1) == 0:
            return out
        addr, set_idx, core = reqs.addr, reqs.set_idx, reqs.core
        state = out.l1

        # The base stage's victim-served mask: ``touch`` only moves
        # timestamps and dirty bits, so the self-array probe on the
        # returned state is the pre-touch local hit, and the buffer is
        # untouched.
        local_hit, _, _ = tagarray.probe(state, core, set_idx, addr,
                                         policy=self.replacement)
        vhit, vslot = tagarray.victim_probe(state, core, addr)
        vserved = vhit & ~local_hit & ~reqs.is_write

        # Promote back into the L1 proper: the entry leaves the buffer
        # and swaps with the line the promotion evicts.
        state = tagarray.victim_invalidate(state, core, vslot, vserved)
        _, pway, _ = tagarray.probe(state, core, set_idx, addr,
                                    policy=self.replacement)
        swap_tag = tagarray.entry(state, "tags", core, set_idx, pway)
        swap_valid = tagarray.entry(state, "valid", core, set_idx, pway)
        state, promo_wb = tagarray.fill(state, core, set_idx, pway, addr, t,
                                        vserved)
        state = tagarray.victim_insert(state, core, swap_tag, t,
                                       vserved & swap_valid)

        # Capture what the shared fill stage will evict on L2/remote
        # returns. It probes the state returned here, so the victim way
        # predicted here is its own (up to same-(cache, set) duplicates
        # within the round, which resolve last-writer-wins there too).
        fill_mask = out.go_l2 | out.remote_hits
        if out.bypass_fill is not None:
            fill_mask = fill_mask & ~out.bypass_fill
        _, fway, _ = tagarray.probe(state, out.fill_cache, out.fill_set,
                                    addr, policy=self.replacement)
        at = (out.fill_cache, out.fill_set, fway)
        ev_tag = tagarray.entry(state, "tags", *at)
        ev_valid = tagarray.entry(state, "valid", *at)
        state = tagarray.victim_insert(state, out.fill_cache, ev_tag, t,
                                       fill_mask & ev_valid)

        return out._replace(
            l1=state,
            # promotions of a dirty victim's frame write the old line back
            noc_flits=out.noc_flits
            + promo_wb.sum(dim=-1) * geom.point("flits_per_line"),
        )
