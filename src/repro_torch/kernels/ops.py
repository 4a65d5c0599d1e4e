"""Entry points the LM substrate calls, dispatching between routes.

The port of the reference's ``kernels/ops.py`` for the two LM kernels.
Routes (``impl``):

  "kernel" — the Hopper kernel's wrapper: it launches the kernel on CUDA
             tensors and runs its plain version on CPU tensors (the
             counterpart of the reference's "pallas" and "interpret");
  "ref"    — the plain PyTorch version, on any device (the counterpart
             of the reference's ``kernels/ref.py`` oracles).
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.wkv6 import wkv6 as wkv6_kernel
from repro_torch.kernels.wkv6 import wkv6_plain

IMPLS = ("ref", "kernel")


def _route(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def attention(q, k, v, kv_len=None, *, causal=True, window=None,
              impl: str = "kernel"):
    """q (B,Hq,Tq,D), k/v (B,Hkv,Tk,D) -> (B,Hq,Tq,D) in q's dtype."""
    _route(impl)
    fn = flash_attention if impl == "kernel" else flash_attention_plain
    return fn(q, k, v, kv_len, causal=causal, window=window)


def wkv6(r, k, v, w, u, initial_state=None, *, impl: str = "kernel", **kw):
    """RWKV6 recurrence -> (o (B,H,T,V), final state (B,H,K,V) f32).

    The "ref" route returns o in f32, as the reference's oracle does; the
    kernel route returns it in r's dtype, as the reference's kernel does.
    """
    _route(impl)
    if impl == "ref":
        return wkv6_plain(r.float(), k, v, w, u, initial_state)
    return wkv6_kernel(r, k, v, w, u, initial_state, **kw)
