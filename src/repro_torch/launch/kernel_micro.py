"""Kernel microbenchmarks: each kernel's ``"kernel"`` route against its
``"ref"`` route (the port of the reference's ``benchmarks/kernel_micro.py``),
at the reference's shapes and seed.

On the card the ``kernel`` rows are the Hopper kernels; on the CPU the
kernel route is the plain version, and the derived column says so.
``us_per_call`` is host wall per call with the card synchronized
(``common.time_call``, 3 calls after 1 warm-up); the device time of each
kernel alone is ``launch/roofline.py``'s. The derived column of a
kernel row is its max abs error against ``ref``: for the probes the way
outputs count only where they are defined (the hit way where the probe
hit; ``src_cache``, ``prank`` and ``psize`` where ``remote_ok``), as in
the reference. The port's ``wkv6`` is one scan kernel, not the
reference's chunked form, so its kernel row is ``kernel.wkv6.kernel_scan``.

Usage (on the CUDA card; ``--device cpu`` runs without one):
  PYTHONPATH=src python -m repro_torch.launch.kernel_micro
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import torch

from repro_torch.core.simulator import resolve_device
from repro_torch.launch.common import emit, time_call
from repro_torch.launch.roofline import (ATTN_SHAPE, KERNEL_SHAPE,
                                         WKV6_SHAPE, kernel_call,
                                         micro_inputs)


def _probe_err(kernel_out, ref_out, masks) -> int:
    """Max abs difference over the outputs, each where its mask holds."""
    err = 0
    for a, b, m in zip(kernel_out, ref_out, masks):
        d = (a.long() - b.long()).abs()
        if m is not None:
            d = torch.where(m, d, 0)
        err = max(err, int(d.max()))
    return err


def run(device=None) -> dict:
    """Time and compare every kernel; returns ``{kernel: {"ref_us",
    "kernel_us", "maxerr", "kernel_out", "ref_out"}}``. Runs on
    ``device`` (default ``"cuda"``)."""
    device = resolve_device(device)
    note = "" if device.type == "cuda" else ";cpu:plain_version"
    x = micro_inputs(device)
    out = {}

    def both(name):
        us_ref, ref_out = time_call(kernel_call(name, x, "ref"))
        us_k, k_out = time_call(kernel_call(name, x, "kernel"))
        out[name] = {"ref_us": us_ref, "kernel_us": us_k,
                     "kernel_out": k_out, "ref_out": ref_out}
        return us_ref, us_k, k_out, ref_out

    R, C, G = KERNEL_SHAPE["R"], KERNEL_SHAPE["C"], KERNEL_SHAPE["G"]
    # ata_tag_probe: the way is only defined where the probe hit
    us_ref, us_k, (h1, w1), (h2, w2) = both("ata_tag_probe")
    err = _probe_err((h1, w1), (h2, w2), (None, h2))
    out["ata_tag_probe"]["maxerr"] = err
    emit("kernel.ata_tag_probe.ref", us_ref,
         f"R={R};C={C};hits={int(h2.sum())}")
    emit("kernel.ata_tag_probe.kernel", us_k, f"maxerr={err}{note}")

    # ata_probe_rank (fused probe + winner pick + port arbitration)
    us_ref, us_k, k_out, ref_out = both("ata_probe_rank")
    lh, rok = ref_out[0], ref_out[2]
    err = _probe_err(k_out, ref_out, (None, lh, None, rok, rok, rok))
    out["ata_probe_rank"]["maxerr"] = err
    emit("kernel.ata_probe_rank.ref", us_ref,
         f"R={R};C={C};G={G};remote={int(rok.sum())}")
    emit("kernel.ata_probe_rank.kernel", us_k, f"maxerr={err}{note}")

    # flash attention
    us_ref, us_k, o1, o2 = both("flash_attention")
    err = float((o1 - o2).abs().max())
    out["flash_attention"]["maxerr"] = err
    B, Hq, _, T, D = ATTN_SHAPE
    emit("kernel.flash_attention.ref", us_ref, f"B{B}H{Hq}T{T}D{D}")
    emit("kernel.flash_attention.kernel", us_k, f"maxerr={err:.2e}{note}")

    # wkv6
    us_ref, us_k, (o1, _), (o2, _) = both("wkv6")
    err = float((o1 - o2).abs().max())
    out["wkv6"]["maxerr"] = err
    B, H, T, K = WKV6_SHAPE
    emit("kernel.wkv6.ref_scan", us_ref, f"B{B}H{H}T{T}K{K}")
    emit("kernel.wkv6.kernel_scan", us_k, f"maxerr={err:.2e}{note}")
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
