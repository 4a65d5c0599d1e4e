"""Architecture-policy interface for the cache-hierarchy simulator.

The simulator is a pipeline of stages; only the first — the L1 complex —
differs between contention-mitigation architectures:

    L1 policy stage  ->  shared L2 stage  ->  L1 fill stage  ->  timing

An :class:`ArchPolicy` implements the L1 stage: given the per-round
request batch and the L1 tag state, it decides which requests are served
inside the L1 complex, at what latency, with what serial-resource
occupancy, and where misses fill on return. Everything downstream
(L2 queueing, DRAM, fill, warp timing) is policy-independent and lives
in ``repro_torch.core.simulator``.

Every request tensor carries the leading simulation-point axis P.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import tagarray
from repro_torch.core.tagarray import ReplacementPolicy

#: Cycles to detect an L1 miss (tag check before dispatching onwards).
TAG_CHECK = 8


class RequestBatch(NamedTuple):
    """One round's flattened requests plus derived routing indices.

    R = n_cores * m requests per point; G = cluster size.
    """
    addr: torch.Tensor       # (P, R) int32 line addresses
    is_write: torch.Tensor   # (P, R) bool
    core: torch.Tensor       # (P, R) int32 issuing core
    cluster: torch.Tensor    # (P, R) int32 cluster of the issuing core
    self_slot: torch.Tensor  # (P, R) int32 core's slot within its cluster
    set_idx: torch.Tensor    # (P, R) int32 local L1 set of addr
    peers: torch.Tensor      # (P, R, G) int32 cache ids of the whole cluster

    @property
    def n_requests(self) -> int:
        return self.addr.shape[-1]


class L1Outcome(NamedTuple):
    """What the L1 complex did with the round's requests.

    Every field is (P, R) unless noted. ``noc_flits`` is the (P,) NoC
    traffic the policy itself generated (probes, peer transfers);
    downstream stages add L2/write-back traffic on top.
    """
    l1: tagarray.TagState           # post-probe/touch L1 tag state
    served: torch.Tensor            # request completed inside L1 complex
    l1_time: torch.Tensor           # float32 completion time if served
    go_l2: torch.Tensor             # request continues to L2
    pre_l2: torch.Tensor            # float32 cycles spent before L2 dispatch
    occupancy: torch.Tensor         # float32 serial-resource busy time
    fill_cache: torch.Tensor        # int32 tag array to fill on return
    fill_set: torch.Tensor          # int32 set to fill on return
    local_hits: torch.Tensor        # bool, for hit-rate accounting
    remote_hits: torch.Tensor       # bool, served by a peer L1
    noc_flits: torch.Tensor         # (P,) float32 flit count this round
    #: int32 core whose cache serves each request (the NoC source for
    #: remote transfers); None = the requesting core itself.
    noc_src: Optional[torch.Tensor] = None
    #: float32 probe + data flits each request puts on the L1-complex
    #: interconnect; None = the default ``remote_hits * flits_per_line``.
    noc_req_flits: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class ArchPolicy:
    """A pluggable L1-complex architecture.

    ``replacement`` selects the victim scheme the policy's tag probes and
    the shared fill stage use for this architecture's L1 arrays (the L2
    always runs LRU).
    """
    name: str
    replacement: ReplacementPolicy = ReplacementPolicy.LRU

    def l1_stage(self, geom, l1: tagarray.TagState, reqs: RequestBatch,
                 t: torch.Tensor, *, backend: Optional[str] = None
                 ) -> L1Outcome:
        """Run the policy's L1 complex over one round's requests.

        ``t`` is the round counter (int32 zero-dim tensor). ``backend``
        selects the probe lowering (``repro_torch.core.probe``); only
        the ATA policy has a probe chain to lower, the others ignore it.
        """
        raise NotImplementedError
