"""RWKV6 (Finch) WKV recurrence with data-dependent decay.

Replaces the Pallas TPU kernel ``repro/kernels/wkv6.py::_wkv6_kernel``.

The function, ``ref.wkv6_ref``'s recurrence, all math in f32::

    o_t = r_t (S + diag(u) k_t^T v_t)
    S  <- diag(exp(w_t)) S + k_t^T v_t          (w <= 0)

with r, k, w (B, H, T, K), v (B, H, T, V), u (H, K) and the state
(B, H, K, V) f32. Returns (o (B, H, T, V) in r's dtype, final state f32).

What bounds it on an H100: f32 operations in principle (at the rwkv6-3b
prefill shape, B=1, H=40, T=4096, K=V=64, one launch moves 126 MB and
does 3.4 GFLOP), the sequential dependence over T in practice. The
design (``csrc/wkv6.cu``) is a scan whose every step rounds the same way
wherever a call starts or ends: one call over T steps returns, bit for
bit, what T chained one-step calls return, so a bf16 model's forward and
its decode of the same tokens agree. Each CTA takes 32 state columns of
one head (80 CTAs at the rwkv6-3b prefill shape); per step a thread
updates its four state elements, one FMA deep, and adds its share of
``r S``; the shares are added, with the bonus term, a chunk of 32 steps
at a time, while the next chunk's inputs are copied in. All math stays f32 on the CUDA cores. The result does not
depend on ``chunk``, kept for signature parity.

:func:`wkv6_plain` is the plain PyTorch version (a port of
``repro/kernels/ref.py::wkv6_ref``, a loop over T). The wrapper takes it
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: Kernel launches made by :func:`wkv6` in this process.
launches = 0

MAX_DIM = 64
DTYPES = (torch.float32, torch.bfloat16)


def wkv6_plain(r, k, v, w, u, initial_state=None):
    """Sequential plain version. Shapes as the module docstring; returns
    (o in r's dtype, final state f32)."""
    B, H, T, K = r.shape
    V = v.shape[-1]
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    u = u.float()[None, :, :, None]
    S = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if initial_state is None else initial_state.float())
    outs = []
    for t in range(T):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]     # (B,H,K,V)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, t], S + u * kv))
        S = torch.exp(wf[:, :, t])[..., None] * S + kv
    o = (torch.stack(outs, 2) if outs
         else torch.empty((B, H, 0, V), device=r.device))
    return o.to(r.dtype), S


def _check(r, k, v, w, u, s0):
    if r.dim() != 4:
        raise ValueError(f"r must be (B, H, T, K), got {tuple(r.shape)}")
    B, H, T, K = r.shape
    for name, x, shape in (("k", k, r.shape), ("w", w, r.shape),
                           ("v", v, (B, H, T, v.shape[-1]))):
        if x.shape != shape:
            raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                             f"{tuple(x.shape)}")
    V = v.shape[-1]
    if not (1 <= K <= MAX_DIM and 1 <= V <= MAX_DIM):
        raise ValueError(f"wkv6 supports K, V in [1, {MAX_DIM}], got K={K}, "
                         f"V={V}")
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        if x.device != r.device:
            raise ValueError(f"{name} is on {x.device}, r on {r.device}")
        if x.dtype not in DTYPES:
            raise ValueError(f"{name} must be one of {DTYPES}, got {x.dtype}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must have a unit stride in its last "
                             "dim")
    for name, x, shape in (("u", u, (H, K)), ("initial_state", s0,
                                              (B, H, K, V))):
        if x is None:
            continue
        if (x.shape != shape or x.dtype != torch.float32
                or x.device != r.device or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 tensor of "
                             f"shape {shape} on r's device")


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("wkv6").wkv6_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def wkv6(r, k, v, w, u, initial_state=None, *, chunk: int = 64):
    """The WKV6 recurrence over T steps.

    CPU tensors take :func:`wkv6_plain`. CUDA tensors launch the Hopper
    kernel: r, k, v, w each f32 or bf16 with a unit last stride; u (H, K)
    and initial_state (B, H, K, V) contiguous f32; K, V <= 64. ``chunk``
    does not change the result (signature parity with the reference).
    The kernel has no backward pass: a CUDA call raises when grad mode is
    on and an input requires grad (:func:`build.refuse_grad`).
    """
    global launches
    del chunk
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, initial_state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on cuda or cpu tensors, got {r.device}")
    build.refuse_grad("wkv6", r, k, v, w, u, initial_state)
    _check(r, k, v, w, u, initial_state)
    B, H, T, K = r.shape
    V = v.shape[-1]
    dev = r.device
    o = torch.empty((B, H, T, V), dtype=r.dtype, device=dev)
    sf = torch.empty((B, H, K, V), dtype=torch.float32, device=dev)
    if B * H == 0:
        return o, sf
    launch = _launcher()
    bf16 = [int(x.dtype == torch.bfloat16) for x in (r, k, v, w)]
    with torch.cuda.device(dev):
        err = launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(),
            None if initial_state is None else initial_state.data_ptr(),
            o.data_ptr(), sf.data_ptr(), B, H, T, K, V,
            *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *w.stride()[:3], *bf16, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 launch failed: CUDA error {err}")
    launches += 1
    return o, sf
