"""Blocked online-softmax attention with GQA, an end-aligned causal mask,
a sliding window and a per-batch valid KV length.

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::_attn_kernel``.

Semantics, those of the TPU kernel: q is scaled by ``D**-0.5`` in f32 and
every product and sum is f32; query head h reads KV head
``h // (Hq // Hkv)``; query row i sits at key position ``i + Tk - Tq``;
key ``kpos`` is visible when ``kpos < kv_len``, and ``kpos <= qpos`` if
causal, and ``kpos > qpos - window`` if a window is given; a row that
sees no key comes back as zeros.

What bounds it on an H100: operations. At the qwen3-0.6b prefill shape
(B=1, Hq=16, Hkv=8, T=4096, D=128, causal) one launch does 4*D flops on
each of 134M visible pairs (69 GFLOP) against 50 MB of q/k/v/o. The
design (``csrc/flash_attention.cu``) has two kernels. bf16 inputs, every
launch of the served models, go to a tensor-core kernel: TMA loads Q
once and K/V tiles of 64 keys through a ring of shared-memory stages,
``wgmma`` computes S = QK^T in f32, the online softmax runs in f32, and P
is split as ``p_hi + p_lo`` (two bf16 operands) for the P@V product, which
keeps the result within one bf16 rounding step of the f32 function.
The tensor maps are encoded per call from the tensors' real strides, so
TMA's rules apply: 16-byte aligned base addresses and b/h/t strides that
are 16-byte multiples; the wrapper raises on anything else and never
copies. Head dims 32, 64, 128, 160 and 256 are compiled; the bf16 kernel pads
D to whole 128-byte TMA boxes (160 to 192) that TMA fills with zeros.
f32 inputs go to a CUDA-core kernel that does every product in
f32, as the TPU kernel does. The TPU kernel's ``Tq % bq`` restriction was
a tiling rule, not semantics: any Tq and Tk work here.

:func:`flash_attention_plain` is the plain PyTorch version (a port of
``repro/kernels/ref.py::attention_len_ref``, with zeros for fully masked
rows). The wrapper takes it only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

#: Kernel launches made by :func:`flash_attention` in this process.
launches = 0

#: head dims the kernel is compiled for (160: stablelm-12b; 256:
#: recurrentgemma-9b)
HEAD_DIMS = (32, 64, 128, 160, 256)
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q, k, v, kv_len=None, *, causal: bool = True,
                          window: Optional[int] = None):
    """Unblocked plain version.

    q (B, Hq, Tq, D); k, v (B, Hkv, Tk, D); kv_len (B,) int or None for
    Tk. Returns (B, Hq, Tq, D) in q's dtype.
    """
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qf = (q.float() * D ** -0.5).reshape(B, Hkv, g, Tq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float())
    qpos = torch.arange(Tq, device=q.device)[:, None] + (Tk - Tq)
    kpos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    mask = mask[None, None, None]
    if kv_len is not None:
        mask = mask & (kpos < kv_len.to(q.device)[:, None, None, None, None])
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)          # fully masked rows: 0
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, Hq, Tq, D).to(q.dtype)


def _check(q, k, v, kv_len, window):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must have a unit stride in its last "
                             "dim")
    B, Hq, Tq, D = q.shape
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention takes {DTYPES}, got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention supports head dims {HEAD_DIMS}, "
                         f"got {D}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Hq % k.shape[1]:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={k.shape[1]}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.dtype == torch.bfloat16:
        _check_tma(q, k, v)
    if kv_len is not None and (kv_len.shape != (B,) or kv_len.dtype !=
                               torch.int32 or kv_len.device != q.device
                               or not kv_len.is_contiguous()):
        raise ValueError("kv_len must be a contiguous (B,) int32 tensor on "
                         "q's device")


def _tma_strides(x):
    """x's (b, h, t) strides. A dim of size 1 is never stepped along, so
    its stride is free: it takes D, a 16-byte multiple in bf16 for every
    head dim the kernel takes (TMA's rule)."""
    return [st if n > 1 else x.shape[-1]
            for n, st in zip(x.shape[:3], x.stride()[:3])]


def _check_tma(q, k, v):
    """TMA's rules for the bf16 kernel's tensor maps: 16-byte aligned
    base addresses and 16-byte multiple strides."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}'s base address is not 16-byte aligned "
                             "(TMA)")
        for dim, stride in zip("bht", _tma_strides(x)):
            if (stride * x.element_size()) % 16:
                raise ValueError(f"{name}'s {dim} stride ({stride} elements)"
                                 " is not a 16-byte multiple (TMA)")


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, kv_len=None, *, causal: bool = True,
                    window: Optional[int] = None):
    """Attention of q (B, Hq, Tq, D) over k/v (B, Hkv, Tk, D).

    CPU tensors take :func:`flash_attention_plain`. CUDA tensors launch
    the Hopper kernel: q, k, v of one dtype (f32 or bf16), D in
    :data:`HEAD_DIMS`, any strides with a unit last one (bf16: 16-byte
    aligned, see :func:`_check_tma`); kv_len a (B,) int32 tensor or None.
    Returns (B, Hq, Tq, D) in q's dtype. The kernel has no backward
    pass: a CUDA call raises when grad mode is on and an input requires
    grad (:func:`build.refuse_grad`).
    """
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_len, causal=causal,
                                     window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    build.refuse_grad("flash_attention", q, k, v)
    _check(q, k, v, kv_len, window)
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    o = torch.empty((B, Hq, Tq, D), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    launch = _launcher()
    with torch.cuda.device(q.device):
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(), o.data_ptr(),
            B, Hq, Hkv, Tq, Tk, D, *_tma_strides(q), *_tma_strides(k),
            *_tma_strides(v), int(causal), 0 if window is None else window,
            D ** -0.5, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    return o
