"""Entry points of the four kernels, dispatching between routes.

The port of the reference's ``kernels/ops.py``: the two probes (called by
``launch/kernel_micro.py`` and ``launch/roofline.py``, in the reference's
unbatched signature) and the two LM kernels (called by the LM substrate).
Routes (``impl``):

  "kernel" — the Hopper kernel's wrapper: it launches the kernel on CUDA
             tensors and runs its plain version on CPU tensors (the
             counterpart of the reference's "pallas" and "interpret");
  "ref"    — the plain PyTorch version, on any device (the counterpart
             of the reference's ``kernels/ref.py`` oracles).
"""
from __future__ import annotations

from repro_torch.kernels.ata_probe_rank import (ata_probe_rank as
                                                _probe_rank_kernel)
from repro_torch.kernels.ata_probe_rank import ata_probe_rank_plain
from repro_torch.kernels.ata_tag_probe import (ata_tag_probe,
                                               ata_tag_probe_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.wkv6 import wkv6 as wkv6_kernel
from repro_torch.kernels.wkv6 import wkv6_plain

IMPLS = ("ref", "kernel")


def _route(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def ata_probe(set_idx, qtag, tags, valid, *, impl: str = "kernel"):
    """set_idx, qtag (R,) int32 vs tags (C, S, W) int32, valid bool ->
    (hits (R, C) bool, ways (R, C) int32)."""
    _route(impl)
    fn = ata_tag_probe if impl == "kernel" else ata_tag_probe_plain
    return fn(set_idx, qtag, tags, valid)


def ata_probe_rank(set_idx, qtag, core, cluster_base, deny, tags, valid,
                   dirty, *, cluster_size: int, impl: str = "kernel"):
    """Fused probe + winner pick + remote-port arbitration of (R,)
    requests against (C, S, W) state -> (local_hit bool, hit_way int32,
    remote_ok bool, src_cache int32, prank int32, psize int32), all (R,).

    Both routes run the port's batched functions on one point (P = 1):
    the point axis is added here and taken off the results.
    """
    _route(impl)
    fn = _probe_rank_kernel if impl == "kernel" else ata_probe_rank_plain
    out = fn(*(x[None] for x in (set_idx, qtag, core, cluster_base, deny,
                                 tags, valid, dirty)),
             cluster_size=cluster_size)
    return tuple(x[0] for x in out)


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
