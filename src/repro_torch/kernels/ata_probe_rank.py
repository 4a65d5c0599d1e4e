"""Fused ATA probe + winner pick + remote-port arbitration.

Replaces the Pallas TPU kernel
``repro/kernels/ata_probe_rank.py::_probe_rank_kernel``.

For each request of each simulation point: compare the request's tag
against its set in every cache of its cluster, report the self-array hit
and its way, pick the lowest-id hitting peer as ``src_cache`` (the
cluster base where none hits), decide ``remote_ok`` (not denied, not a
local hit, a peer hits, that peer's copy is clean), and rank the
``remote_ok`` requests in arrival order at their ``src_cache``'s data
port (``prank``) with the port's group size (``psize``).

What bounds it on an H100: at the simulator's sizes (P <= 53 points,
R = 60 or 120 requests, G = 10 caches of 64 ways) one launch does a few
million integer compares and reads at most P * R * G * W * 4 bytes of
tags plus the valid/dirty bytes, a few megabytes that sit in the 50 MB
L2; so a launch is bound by launch latency and those bytes, not by
arithmetic. The design follows from that (``csrc/ata_probe_rank.cu``):

* one CTA per simulation point, so a whole round of the batched
  simulator is one launch; the CTA walks its R requests in chunks of
  its block, one request per thread;
* a thread reads only its own set row in the G caches of its cluster,
  never the whole (C, S, W) state the TPU kernel kept resident;
* the TPU kernel carried port counts from tile to tile of its
  sequential grid; here the C per-port counters live in shared memory
  and carry from chunk to chunk inside the CTA, and a request's rank is
  the carried count plus the earlier lanes of its chunk with the same
  port (a shared-memory scan);
* ``psize`` is read from the final counters inside the kernel.

:func:`ata_probe_rank_plain` is the plain PyTorch version (a port of
``repro/kernels/ref.py::ata_probe_rank_ref``). The wrapper takes it only
for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: Kernel launches made by :func:`ata_probe_rank` in this process.
launches = 0

_MAX_CACHES = 8192   # per-port counters must fit the CTA's shared memory


def ata_probe_rank_plain(set_idx, qtag, core, cluster_base, deny, tags,
                         valid, dirty, *, cluster_size: int):
    """Unblocked plain version over a leading point axis P.

    set_idx, qtag, core, cluster_base : (P, R) int32; deny : (P, R) bool;
    tags : (P, C, S, W) int32; valid, dirty : (P, C, S, W) bool.
    Returns (local_hit bool, hit_way int32, remote_ok bool,
    src_cache int32, prank int32, psize int32), all (P, R).
    """
    P, C, S, W = tags.shape
    dev = tags.device
    p = torch.arange(P, device=dev)[:, None, None]
    cid = torch.arange(C, device=dev)
    row = (p * C + cid) * S + set_idx.long()[..., None]       # (P, R, C)
    sel_tags = tags.reshape(-1, W)[row]                       # (P, R, C, W)
    sel_valid = valid.reshape(-1, W)[row]
    sel_dirty = dirty.reshape(-1, W)[row]
    match = (sel_tags == qtag[..., None, None]) & sel_valid
    hit_c = match.any(dim=-1)                                 # (P, R, C)
    dirty_c = (match & sel_dirty).any(dim=-1)
    way_c = match.to(torch.uint8).argmax(dim=-1)

    core = core.long()
    cbase = cluster_base.long()
    is_self = cid == core[..., None]
    in_cluster = ((cid >= cbase[..., None])
                  & (cid < cbase[..., None] + cluster_size))
    local_hit = (hit_c & is_self).any(dim=-1)
    hit_way = way_c.gather(-1, core[..., None])[..., 0]

    rmask = hit_c & in_cluster & ~is_self
    any_remote = rmask.any(dim=-1)
    src = torch.where(rmask, cid, C).amin(dim=-1)
    src_cache = torch.where(any_remote, src, cbase)
    first = rmask & (cid == src_cache[..., None])
    src_dirty = (first & dirty_c).any(dim=-1)
    remote_ok = ~deny & ~local_hit & any_remote & ~src_dirty

    oh = (remote_ok[..., None] & (cid == src_cache[..., None])
          ).to(torch.int32)                                   # (P, R, C)
    before = oh.cumsum(dim=-2) - oh          # exclusive, request order
    prank = (before * oh).sum(dim=-1)
    counts = oh.sum(dim=-2)                                   # (P, C)
    psize = torch.where(remote_ok, counts.gather(-1, src_cache), 0)
    i32 = torch.int32
    return (local_hit, hit_way.to(i32), remote_ok, src_cache.to(i32),
            prank.to(i32), psize.to(i32))


def _check(set_idx, qtag, core, cluster_base, deny, tags, valid, dirty):
    if tags.dim() != 4:
        raise ValueError(f"tags must be (P, C, S, W), got {tuple(tags.shape)}")
    P, C = tags.shape[:2]
    if P < 1:
        raise ValueError("ata_probe_rank needs at least one point")
    if C > _MAX_CACHES:
        raise ValueError(f"at most {_MAX_CACHES} caches, got {C}")
    if set_idx.dim() != 2 or set_idx.shape[0] != P:
        raise ValueError(f"requests must be ({P}, R), got set_idx "
                         f"{tuple(set_idx.shape)}")
    for name, x, dtype, shape in (
            ("set_idx", set_idx, torch.int32, set_idx.shape),
            ("qtag", qtag, torch.int32, set_idx.shape),
            ("core", core, torch.int32, set_idx.shape),
            ("cluster_base", cluster_base, torch.int32, set_idx.shape),
            ("deny", deny, torch.bool, set_idx.shape),
            ("tags", tags, torch.int32, tags.shape),
            ("valid", valid, torch.bool, tags.shape),
            ("dirty", dirty, torch.bool, tags.shape)):
        if x.device != tags.device:
            raise ValueError(f"{name} is on {x.device}, tags on {tags.device}")
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
        if x.shape != shape:
            raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("ata_probe_rank").ata_probe_rank_launch
    fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ata_probe_rank(set_idx, qtag, core, cluster_base, deny, tags, valid,
                   dirty, *, cluster_size: int):
    """Fused probe + per-set winner pick + port arbitration.

    Shapes and results as :func:`ata_probe_rank_plain`. CPU tensors take
    the plain version; CUDA tensors launch the Hopper kernel (inputs must
    be contiguous, of the stated dtypes, on one device).
    """
    global launches
    if tags.device.type == "cpu":
        return ata_probe_rank_plain(set_idx, qtag, core, cluster_base, deny,
                                    tags, valid, dirty,
                                    cluster_size=cluster_size)
    if tags.device.type != "cuda":
        raise ValueError(f"ata_probe_rank runs on cuda or cpu tensors, "
                         f"got {tags.device}")
    _check(set_idx, qtag, core, cluster_base, deny, tags, valid, dirty)
    P, C, S, W = tags.shape
    R = set_idx.shape[1]
    launch = _launcher()
    dev = tags.device
    local_hit = torch.empty((P, R), dtype=torch.bool, device=dev)
    remote_ok = torch.empty_like(local_hit)
    hit_way, src_cache, prank, psize = (
        torch.empty((P, R), dtype=torch.int32, device=dev) for _ in range(4))
    with torch.cuda.device(dev):
        err = launch(
            set_idx.data_ptr(), qtag.data_ptr(), core.data_ptr(),
            cluster_base.data_ptr(), deny.data_ptr(), tags.data_ptr(),
            valid.data_ptr(), dirty.data_ptr(), local_hit.data_ptr(),
            hit_way.data_ptr(), remote_ok.data_ptr(), src_cache.data_ptr(),
            prank.data_ptr(), psize.data_ptr(), P, R, C, S, W,
            cluster_size, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ata_probe_rank launch failed: CUDA error {err}")
    launches += 1
    return local_hit, hit_way, remote_ok, src_cache, prank, psize
