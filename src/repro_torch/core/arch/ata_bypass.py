"""ATA + interference-aware fill bypass (CIAO-style, arXiv 1805.07718).

CIAO observes that streaming (low-reuse) requests thrash a shared L1:
every fill they trigger evicts a line some core was still using, and the
fill/write-back traffic they generate contends with useful transfers.
The detector here is *dead-victim* prediction: if the replacement victim
in the target set was never re-touched after its own install
(``last == born``), the set is absorbing streaming traffic — the
incoming line is predicted equally dead, so the L2 return is forwarded
straight to the core and the L1 fill is skipped. Hits, remote
transfers, and fills over reused victims behave exactly like the base
ATA policy.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import tagarray
from repro_torch.core.arch.ata import AtaPolicy
from repro_torch.core.arch.base import L1Outcome, RequestBatch


@dataclasses.dataclass(frozen=True)
class AtaBypassPolicy(AtaPolicy):
    name: str = "ata_bypass"

    def l1_stage(self, geom, l1: tagarray.TagState, reqs: RequestBatch, t,
                 *, backend=None) -> L1Outcome:
        out = super().l1_stage(geom, l1, reqs, t, backend=backend)
        dead = tagarray.dead_victim(out.l1, out.fill_cache, out.fill_set,
                                    reqs.addr, policy=self.replacement)
        # only L2-bound misses bypass; remote hits still replicate locally
        # (they are proven-shared lines, the opposite of streaming data).
        return out._replace(bypass_fill=out.go_l2 & dead)
