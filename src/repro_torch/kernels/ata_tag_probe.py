"""Aggregated-tag-array probe (paper Fig. 6).

Replaces the Pallas TPU kernel
``repro/kernels/ata_tag_probe.py::_probe_kernel``.

A batch of R request tags, each with its selected set, is compared
against the tag arrays of all C caches; per (request, cache) the kernel
reports the hit and the first matching way (0 where nothing matches, as
an ``argmax`` over the ways gives). The serving engine probes its
replicated block directory with it once per sub-round.

What bounds it on an H100: at the serving shapes (C in {8, 16} shards,
R = C * K <= 288 block lanes, S = 64 sets of W = 8 ways: the whole
directory is 32 KB of tags) a launch reads a few KB of set rows and
does at most R * C * W = 36,864 compares, so it is bound by launch
latency and its chain of dependent memory round trips, not bytes or
arithmetic. The design (``csrc/ata_tag_probe.cu``) takes two round
trips: a group of lanes per (request, cache) pair (one lane per way, a
whole warp for W > 32) reads the request's set and tag, then issues
every way load of the row before any compare, and a warp ballot with
``__ffs`` picks the first matching way. ``tags`` is read through its
strides, so the serving engine probes the tag lane of its packed
directory in place. The TPU kernel's masked-max one-hot gather over the
set axis (an answer to Mosaic's gather limits) is not carried over.

:func:`ata_tag_probe_plain` is the plain PyTorch version (a port of
``repro/kernels/ref.py::ata_tag_probe_ref``). The wrapper takes it only
for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: Kernel launches made by :func:`ata_tag_probe` in this process.
launches = 0


def ata_tag_probe_plain(set_idx, qtag, tags, valid):
    """Unblocked plain version.

    set_idx, qtag : (R,) int32, every set in [0, S);
    tags : (C, S, W) int32; valid : (C, S, W) bool.
    Returns (hits (R, C) bool, ways (R, C) int32).
    """
    sets = set_idx.long()
    match = (tags[:, sets, :] == qtag[None, :, None]) & valid[:, sets, :]
    hits = match.any(dim=-1).T.contiguous()                  # (R, C)
    ways = match.to(torch.uint8).argmax(dim=-1).T.to(torch.int32)
    return hits, ways.contiguous()


def _check(set_idx, qtag, tags, valid):
    if tags.dim() != 3:
        raise ValueError(f"tags must be (C, S, W), got {tuple(tags.shape)}")
    if set_idx.dim() != 1:
        raise ValueError(f"set_idx must be (R,), got {tuple(set_idx.shape)}")
    for name, x, dtype, shape in (
            ("set_idx", set_idx, torch.int32, set_idx.shape),
            ("qtag", qtag, torch.int32, set_idx.shape),
            ("tags", tags, torch.int32, tags.shape),
            ("valid", valid, torch.bool, tags.shape)):
        if x.device != tags.device:
            raise ValueError(f"{name} is on {x.device}, tags on {tags.device}")
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
        if x.shape != shape:
            raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                             f"{tuple(x.shape)}")
        if name != "tags" and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous (only tags may be "
                             "a strided view: the kernel reads it at any "
                             "element strides)")


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("ata_tag_probe").ata_tag_probe_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ata_tag_probe(set_idx, qtag, tags, valid):
    """Probe R request tags against C tag arrays.

    Shapes and results as :func:`ata_tag_probe_plain`. CPU tensors take
    the plain version; CUDA tensors launch the Hopper kernel (inputs of
    the stated dtypes, on one device, contiguous but for ``tags``, which
    may be any strided view such as the serving engine's directory lane;
    a set outside [0, S) reports a miss there instead of reading outside
    the array).
    """
    global launches
    if tags.device.type == "cpu":
        return ata_tag_probe_plain(set_idx, qtag, tags, valid)
    if tags.device.type != "cuda":
        raise ValueError(f"ata_tag_probe runs on cuda or cpu tensors, got "
                         f"{tags.device}")
    _check(set_idx, qtag, tags, valid)
    C, S, W = tags.shape
    R = set_idx.shape[0]
    dev = tags.device
    hits = torch.empty((R, C), dtype=torch.bool, device=dev)
    ways = torch.empty((R, C), dtype=torch.int32, device=dev)
    if R * C == 0:
        return hits, ways
    launch = _launcher()
    with torch.cuda.device(dev):
        err = launch(set_idx.data_ptr(), qtag.data_ptr(), tags.data_ptr(),
                     valid.data_ptr(), hits.data_ptr(), ways.data_ptr(),
                     R, C, S, W, *tags.stride(),
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ata_tag_probe launch failed: CUDA error {err}")
    launches += 1
    return hits, ways
