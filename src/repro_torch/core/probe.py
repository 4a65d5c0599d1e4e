"""Selectable probe backends for the ATA round loop.

The aggregated-tag-array policy spends its round in one computation:
probe the request batch against every cluster tag array, pick the
per-request winner (self hit, else first hitting peer), and arbitrate
the known remote hits at their serving caches' data ports.
:func:`fused_probe_rank` is that whole chain as one op with two
interchangeable lowerings, the **probe backend**:

``torch``
    Plain tensor ops: one ``probe_many`` gather feeds hit selection,
    peer pick and :func:`repro_torch.core.contention.group_rank`
    arbitration (the reference's fused ``lax`` path). Runs anywhere.
``cuda``
    The hand-written Hopper kernel
    (:mod:`repro_torch.kernels.ata_probe_rank`): the same chain in one
    launch per round for all P simulation points. CUDA tensors only.

The default is ``cuda`` for CUDA tensors and ``torch`` for CPU tensors.
Both return identical integers/booleans (the parity tests and the chip
smoke run pin it), so results never depend on the backend.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import tagarray
from repro_torch.core.contention import group_rank
from repro_torch.kernels.ata_probe_rank import ata_probe_rank

PROBE_BACKENDS: Tuple[str, ...] = ("torch", "cuda")


def resolve_probe_backend(backend: Optional[str],
                          device: torch.device) -> str:
    """``backend``, or the device's default; refuses ``cuda`` off-card."""
    device = torch.device(device)
    if backend is None:
        return "cuda" if device.type == "cuda" else "torch"
    if backend not in PROBE_BACKENDS:
        raise ValueError(f"probe_backend must be one of {PROBE_BACKENDS}, "
                         f"got {backend!r}")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError("probe_backend='cuda' needs CUDA tensors, got "
                         f"device {device}")
    return backend


class ProbeRank(NamedTuple):
    """The fused chain's outputs, all (P, R).

    ``touch_way`` is the self-array hit way, what the policy hands to
    ``tagarray.touch`` for its local-hit refresh (0 where there is no
    hit; the touch drops those lanes). ``prank``/``psize`` are the queue
    position and group size at the serving cache's data port, exactly
    ``group_rank(src_cache, remote_ok, n_cores)``.
    """
    local_hit: torch.Tensor   # bool — hit in the requester's own array
    touch_way: torch.Tensor   # int32 — way to LRU-touch where local_hit
    remote_ok: torch.Tensor   # bool — serviceable known remote hit
    src_cache: torch.Tensor   # int32 — serving peer cache id (cluster
    #                           base where there is no remote hit)
    prank: torch.Tensor       # int32 — position at the serving port
    psize: torch.Tensor       # int32 — contention group size


def _torch_path(geom, l1: tagarray.TagState, reqs) -> ProbeRank:
    G = geom.cluster_size
    hits, ways, dirt = tagarray.probe_many(l1, reqs.peers, reqs.set_idx,
                                           reqs.addr)
    slot = reqs.self_slot.long()[..., None]
    is_self = torch.arange(G, device=slot.device) == slot
    local_hit = (hits & is_self).any(dim=-1)
    hit_way = ways.gather(-1, slot)[..., 0]
    rmask = hits & ~is_self
    any_remote = rmask.any(dim=-1)
    src_slot = rmask.to(torch.uint8).argmax(dim=-1)
    src_cache = reqs.cluster * G + src_slot
    src_dirty = dirt.gather(-1, src_slot[..., None])[..., 0]
    # writes are local-only (paper coherence rule); dirty remote copies
    # divert the read to L2.
    remote_ok = ~reqs.is_write & ~local_hit & any_remote & ~src_dirty
    prank, psize = group_rank(src_cache, remote_ok, geom.n_cores)
    return ProbeRank(local_hit, hit_way.to(torch.int32), remote_ok,
                     src_cache.to(torch.int32), prank, psize)


def fused_probe_rank(geom, l1: tagarray.TagState, reqs, *,
                     backend: Optional[str] = None) -> ProbeRank:
    """Probe + winner pick + port arbitration under one backend."""
    backend = resolve_probe_backend(backend, reqs.addr.device)
    if backend == "torch":
        return _torch_path(geom, l1, reqs)
    return ProbeRank(*ata_probe_rank(
        reqs.set_idx, reqs.addr, reqs.core,
        reqs.cluster * geom.cluster_size, reqs.is_write,
        l1["tags"], l1["valid"], l1["dirty"],
        cluster_size=geom.cluster_size))
