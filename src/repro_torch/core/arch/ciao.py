"""CIAO-style interference-aware throttling (arXiv 1805.07718).

CIAO observes that a few cache-thrashing warps can destroy a shared
L1's usefulness for everyone: their streaming fills evict lines other
lanes were still reusing, and the resulting refill traffic contends on
the NoC. Its remedy is to *detect* the thrashing lanes and throttle
them — their requests are redirected around the L1 (straight to L2,
without filling) and slightly deferred, so well-behaved lanes keep
their working sets.

The detector is the dead-victim predictor of ``ata_bypass``,
accumulated per core over time in the ``thrash`` TagState extension
(``tagarray``): every miss whose replacement victim was never
re-touched after its own install (``last == born``) bumps the issuing
core's counter; every round the counter decays by ``thrash_decay``. A
core whose counter sits at or above ``thrash_threshold`` at the start
of a round is *thrashing*: its misses that round bypass the L1 fill and
pay ``throttle_cycles`` extra before L2 dispatch. Hits are never
throttled.

``thrash_threshold <= 0`` disables the scheme entirely — the policy is
then bit-exact with :class:`~repro_torch.core.arch.private.PrivatePolicy`
(counters are not even updated).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import tagarray
from repro_torch.core.arch.base import L1Outcome, RequestBatch
from repro_torch.core.arch.private import PrivatePolicy


@dataclasses.dataclass(frozen=True)
class CiaoPolicy(PrivatePolicy):
    name: str = "ciao"
    track_thrash: bool = True
    thrash_threshold: int = 4    # counter level that marks a lane thrashing
    thrash_decay: int = 1        # per-round counter decay
    thrash_cap: int = 32         # counter ceiling (bounds re-enable lag)
    throttle_cycles: float = 16.0  # deferral added before L2 dispatch

    @property
    def stack_key(self) -> str:
        # same round dataflow as the private baseline
        return "private"

    def l1_stage(self, geom, l1: tagarray.TagState, reqs: RequestBatch, t,
                 *, backend=None) -> L1Outcome:
        out = super().l1_stage(geom, l1, reqs, t, backend=backend)
        # disabled (threshold <= 0) or run without the thrash extension:
        # the private baseline, bit for bit
        if self.thrash_threshold <= 0 or l1["thrash"].shape[-1] == 0:
            return out
        prev = out.l1["thrash"]                      # (P, C) start of round
        core = reqs.core.long()
        throttled = ((prev.gather(-1, core) >= self.thrash_threshold)
                     & out.go_l2)
        # dead-victim detection on the fills that will actually happen
        # (throttled lanes bypass, so they kill no victim)
        dead_fill = (out.go_l2 & ~throttled
                     & tagarray.dead_victim(out.l1, out.fill_cache,
                                            out.fill_set, reqs.addr,
                                            policy=self.replacement))
        # an int32 scatter-add: exact in any order
        per_core = torch.zeros_like(prev).scatter_add(
            -1, core, dead_fill.to(torch.int32))
        thrash = torch.clamp(prev + per_core - self.thrash_decay,
                             0, self.thrash_cap)
        return out._replace(
            l1=dict(out.l1, thrash=thrash),
            pre_l2=out.pre_l2 + torch.where(throttled,
                                            self.throttle_cycles, 0.0),
            bypass_fill=throttled,
        )
