"""Roofline of the port's four kernels (the port of the kernel section of
the reference's ``benchmarks/roofline.py``).

For each kernel at ``launch/kernel_micro.py``'s shapes (the probes at
:data:`KERNEL_SHAPE`, R=1024 requests against C=16 caches of S=8 sets x
W=64 ways in clusters of G=4; ``flash_attention`` at (2, 8, 512, 64) with
2 KV heads, causal; ``wkv6`` at (2, 4, 512, 64); all f32): the bytes the
function must move (each input read once, each output written once), the
operations it does on these inputs, their ratio, and the least time an
H100 could take for each, beside the kernel's measured device time on the
card (``None`` on the CPU, where only the model is reported).

The byte counts are what the port's CUDA kernels must read and write, not
the reference's Pallas BlockSpecs (which re-read the tag state once per
request tile):

* ``ata_probe_rank``: every distinct (point, cache, set) row a request's
  cluster probes (W int32 tags + valid + dirty bytes), the five request
  inputs and the six outputs; one compare per way of each row scanned;
* ``ata_tag_probe``: every distinct (cache, set) row (tags + valid), the
  two request inputs and both outputs; one compare per way up to the
  first match (all W on a miss), so the count depends on the data;
* ``flash_attention``: q, k, v read and o written once; 4 D flops per
  (query, key) pair the mask lets through;
* ``wkv6``: r, k, v, w, u read and o and the final state written once;
  5 K V + 3 K + 2 V flops per (head, step).

The peaks are the H100 SXM data sheet's at its 700 W limit: 3.35 TB/s of
HBM, and 67 T operations per second on the CUDA cores (f32 flops, which
is also the rate this model takes for int32 compares). ``chip_smoke.py``
takes its bounds from these same functions.

The dry-run table (:func:`load`, :func:`fraction`, :func:`table`; the
reference's ``benchmarks/roofline.py:37-78``) reads the records of
``launch/dryrun.py`` (``results/dryrun_torch/*.json``): per (arch x
shape) of a mesh, the three roofline terms, the dominant one, the useful
FLOP ratio and the roofline fraction (MODEL_FLOPS / chips / peak over
the largest term: the score a perfect implementation would push to 1),
on the H100's bf16 peak. These are the dry run's model on the data
sheet's constants, not measurements.

Usage (on the CUDA card; ``--device cpu`` prints the model alone;
``--dryrun sp|mp`` prints the dry-run table, no card needed):
  PYTHONPATH=src python -m repro_torch.launch.roofline
"""
from __future__ import annotations

import argparse
import glob
import json
import pathlib
import sys
from typing import List, Optional

import numpy as np

#: H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12       # CUDA-core rate, outside the tensor cores
INT32_OPS_PER_S = FP32_OPS_PER_S
BF16_OPS_PER_S = 989e12      # dense bf16 tensor-core rate

#: Canonical probe-kernel shape (as ``kernel_micro``): R requests against
#: C caches of S sets x W ways, clusters of G.
KERNEL_SHAPE = {"R": 1024, "C": 16, "S": 8, "W": 64, "G": 4}
#: ``kernel_micro``'s attention (B, Hq, Hkv, T, D) and WKV6 (B, H, T, K).
ATTN_SHAPE = (2, 8, 2, 512, 64)
WKV6_SHAPE = (2, 4, 512, 64)
KERNEL_NAMES = ("ata_tag_probe", "ata_probe_rank", "flash_attention",
                "wkv6")
#: the device-side symbol each kernel's time is read under
_SYMBOL = {"ata_tag_probe": "ata_tag_probe_kernel",
           "ata_probe_rank": "ata_probe_rank_kernel",
           "flash_attention": "attn_f32_kernel",
           "wkv6": "wkv6_scan_kernel"}


def bound(nbytes: float, ops: float, ops_per_s: float):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations over ``ops_per_s``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def probe_rank_traffic(set_idx, cluster_base, tags_shape, cluster_size):
    """(bytes, compares) of one ``ata_probe_rank`` call: ``set_idx`` and
    ``cluster_base`` are (P, R) (or (R,)) arrays, ``tags_shape`` (P, C,
    S, W) (or (C, S, W))."""
    *lead, C, S, W = tags_shape
    P = int(np.prod(lead)) if lead else 1
    set_idx = np.asarray(set_idx).reshape(P, -1)
    cbase = np.asarray(cluster_base).reshape(P, -1)
    R = set_idx.shape[1]
    caches = cbase[..., None] + np.arange(cluster_size)       # (P, R, G)
    p = np.arange(P)[:, None, None]
    rows = ((p * C + caches) * S + set_idx[..., None])[caches < C]
    state_bytes = np.unique(rows).size * W * (4 + 1 + 1)
    io_bytes = P * R * (4 * 4 + 1) + P * R * (1 + 4 + 1 + 4 + 4 + 4)
    return state_bytes + io_bytes, P * R * cluster_size * W


def tag_probe_traffic(set_idx, tags_shape, hits, ways):
    """(bytes, compares) of one ``ata_tag_probe`` call with these
    results: (R,) sets against (C, S, W) tags, (R, C) hits and ways."""
    C, S, W = tags_shape
    set_idx = np.asarray(set_idx)
    R = set_idx.shape[0]
    nbytes = R * 8 + C * len(np.unique(set_idx)) * W * 5 + R * C * 5
    ops = int(np.where(np.asarray(hits), np.asarray(ways) + 1, W).sum())
    return nbytes, ops


def visible_pairs(B, Hq, Tq, Tk, causal, window, kv_len) -> int:
    """(query, key) pairs the attention mask lets through for these
    inputs: the work the kernel has to do."""
    qpos = np.arange(Tq)[:, None] + (Tk - Tq)
    kpos = np.arange(Tk)[None, :]
    mask = np.ones((Tq, Tk), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    lens = [Tk] * B if kv_len is None else kv_len
    return Hq * sum(int(mask[:, :min(int(n), Tk)].sum()) for n in lens)


def attention_traffic(B, Hq, Hkv, Tq, Tk, D, itemsize, pairs):
    """(bytes, flops): q, k, v read and o written once in ``itemsize``-
    byte elements; 4 D flops per visible pair."""
    return (itemsize * (2 * B * Hq * Tq * D + 2 * B * Hkv * Tk * D),
            4 * D * pairs)


def wkv6_traffic(B, H, T, K, V, rkv_bytes, w_bytes, o_bytes, with_state):
    """(bytes, flops): r, k, v (``rkv_bytes`` each) and w read once, u
    (f32) read once, o written once, the f32 final state written (and the
    initial one read, ``with_state``). Per step and (i, j): r_i S_ij (2
    flops) and S_ij e^w_i + k_i v_j (3); the bonus term factors as v_j
    sum_i r_i u_i k_i, O(K + V) a step."""
    nbytes = (B * H * T * (rkv_bytes * (2 * K + V) + w_bytes * K)
              + H * K * 4 + B * H * T * V * o_bytes
              + B * H * K * V * 4 * (2 if with_state else 1))
    return nbytes, B * H * T * (5 * K * V + 3 * K + 2 * V)


def micro_inputs(device="cpu") -> dict:
    """``kernel_micro``'s inputs, drawn in the reference's order from
    ``np.random.default_rng(0)``, as tensors on ``device``."""
    import torch
    R, C, S, W, G = (KERNEL_SHAPE[k] for k in "RCSWG")
    rng = np.random.default_rng(0)
    x = {}
    x["tags"] = rng.integers(0, 4096, (C, S, W)).astype(np.int32)
    x["valid"] = rng.random((C, S, W)) < 0.7
    x["qtag"] = rng.integers(0, 4096, R).astype(np.int32)
    x["set_idx"] = rng.integers(0, S, R).astype(np.int32)
    x["core"] = rng.integers(0, C, R).astype(np.int32)
    x["cbase"] = (x["core"] // G) * G
    x["deny"] = rng.random(R) < 0.2
    x["dirty"] = x["valid"] & (rng.random((C, S, W)) < 0.2)
    B, Hq, Hkv, T, D = ATTN_SHAPE
    for name, h in (("q", Hq), ("k", Hkv), ("v", Hkv)):
        x[name] = rng.standard_normal((B, h, T, D)).astype(np.float32)
    B, H, T, K = WKV6_SHAPE
    for name in ("r", "kk", "vv"):
        x[name] = (rng.standard_normal((B, H, T, K)) * .5).astype(np.float32)
    x["w"] = -np.exp(rng.standard_normal((B, H, T, K)).astype(np.float32))
    x["u"] = (rng.standard_normal((H, K)) * .5).astype(np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in x.items()}


def kernel_call(name, x, impl="kernel"):
    """A no-argument call of ``name``'s ``impl`` route on the inputs of
    :func:`micro_inputs`."""
    from repro_torch.kernels import ops
    if name == "ata_tag_probe":
        return lambda: ops.ata_probe(x["set_idx"], x["qtag"], x["tags"],
                                     x["valid"], impl=impl)
    if name == "ata_probe_rank":
        return lambda: ops.ata_probe_rank(
            x["set_idx"], x["qtag"], x["core"], x["cbase"], x["deny"],
            x["tags"], x["valid"], x["dirty"],
            cluster_size=KERNEL_SHAPE["G"], impl=impl)
    if name == "flash_attention":
        return lambda: ops.attention(x["q"], x["k"], x["v"], impl=impl)
    if name == "wkv6":
        return lambda: ops.wkv6(x["r"], x["kk"], x["vv"], x["w"], x["u"],
                                impl=impl)
    raise ValueError(f"unknown kernel {name!r}")


def kernel_model(name):
    """(bytes, ops, ops_per_s) of one call of ``name`` at its
    ``kernel_micro`` shape."""
    if name == "flash_attention":
        B, Hq, Hkv, T, D = ATTN_SHAPE
        pairs = visible_pairs(B, Hq, T, T, True, None, None)
        return attention_traffic(B, Hq, Hkv, T, T, D, 4, pairs) + (
            FP32_OPS_PER_S,)
    if name == "wkv6":
        B, H, T, K = WKV6_SHAPE
        return wkv6_traffic(B, H, T, K, K, 4, 4, 4, False) + (
            FP32_OPS_PER_S,)
    x = micro_inputs("cpu")
    if name == "ata_tag_probe":
        hits, ways = kernel_call(name, x, "ref")()
        return tag_probe_traffic(x["set_idx"], x["tags"].shape, hits,
                                 ways) + (INT32_OPS_PER_S,)
    if name == "ata_probe_rank":
        return probe_rank_traffic(x["set_idx"], x["cbase"], x["tags"].shape,
                                  KERNEL_SHAPE["G"]) + (INT32_OPS_PER_S,)
    raise ValueError(f"unknown kernel {name!r}")


def kernel_table(device=None):
    """Rows (kernel, bytes, ops, ops per byte, memory s, compute s,
    "memory" or "compute", measured device us per call or None). The
    device time is measured on a CUDA ``device`` (the kernel route, 100
    calls under the profiler); on the CPU the model stands alone."""
    import torch

    from repro_torch.launch.common import kernel_device_ms
    on_card = device is not None and torch.device(device).type == "cuda"
    x = micro_inputs(device) if on_card else None
    rows = []
    for name in KERNEL_NAMES:
        nbytes, ops, ops_per_s = kernel_model(name)
        mem_s = nbytes / HBM_BYTES_PER_S
        comp_s = ops / ops_per_s
        measured = None
        if on_card:
            ms = kernel_device_ms(kernel_call(name, x), _SYMBOL[name])
            measured = None if ms is None else ms * 1e3
        rows.append((name, nbytes, ops, ops / nbytes, mem_s, comp_s,
                     "memory" if mem_s >= comp_s else "compute", measured))
    return rows


def print_kernel_table(device=None):
    s = KERNEL_SHAPE
    print(f"\n=== roofline: kernels (probes R={s['R']} C={s['C']} "
          f"S={s['S']} W={s['W']} G={s['G']}; attention {ATTN_SHAPE}; "
          f"wkv6 {WKV6_SHAPE}) ===")
    print(f"{'kernel':16s} {'KB':>8s} {'ops':>10s} {'ops/B':>6s} "
          f"{'mem_us':>8s} {'comp_us':>8s} {'bound':8s} {'meas_us':>8s}")
    rows = kernel_table(device)
    for name, b, o, ai, mem_s, comp_s, bnd, meas in rows:
        meas_col = f"{meas:>8.2f}" if meas is not None else f"{'-':>8s}"
        print(f"{name:16s} {b / 1024:>8.1f} {o:>10d} {ai:>6.1f} "
              f"{mem_s * 1e6:>8.2f} {comp_s * 1e6:>8.2f} {bnd:8s} "
              f"{meas_col}")
    return rows


# ---------------------------------------------------------------------------
# the dry-run table
# ---------------------------------------------------------------------------
RESULTS = (pathlib.Path(__file__).resolve().parents[3] / "results"
           / "dryrun_torch")


def load(mesh="sp", results=None):
    """The dry-run records of one mesh ("sp" 16 x 16, "mp" 2 x 16 x 16),
    in file-name order."""
    rows = []
    for f in sorted(glob.glob(str(pathlib.Path(results or RESULTS)
                                  / f"*__{mesh}.json"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def fraction(r, peak=BF16_OPS_PER_S):
    """The roofline fraction of an ``ok`` record: MODEL_FLOPS a chip at
    ``peak`` over the largest of its three terms; None otherwise."""
    if r["status"] != "ok":
        return None
    t = r["roofline"]
    ideal = t["model_flops_global"] / r["chips"] / peak
    worst = max(t["compute_s"], t["memory_s"], t["collective_s"])
    return ideal / worst if worst else None


def table(mesh="sp", results=None, peak=BF16_OPS_PER_S):
    """One row per record: (arch, shape, SKIP, reason), (arch, shape,
    ERR, error) or (arch, shape, dominant, compute s, memory s,
    collective s, useful FLOP ratio, roofline fraction, peak GB)."""
    rows = []
    for r in load(mesh, results):
        if r["status"] == "skipped":
            rows.append((r["arch"], r["shape"], "SKIP", r.get("reason", "")))
            continue
        if r["status"] != "ok":
            rows.append((r["arch"], r["shape"], "ERR",
                         r.get("error", "")[:60]))
            continue
        t = r["roofline"]
        frac = fraction(r, peak)
        rows.append((
            r["arch"], r["shape"], t["dominant"],
            f"{t['compute_s']:.4f}", f"{t['memory_s']:.4f}",
            f"{t['collective_s']:.4f}",
            f"{t['useful_flops_ratio']:.2f}"
            if t["useful_flops_ratio"] else "-",
            f"{frac:.3f}" if frac else "-",
            f"{r['memory']['peak_estimate_gb']:.1f}GB",
        ))
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dryrun", choices=("sp", "mp"), default=None,
                    help="print the dry-run table of this mesh instead")
    args = ap.parse_args(argv)
    if args.dryrun:
        for row in table(args.dryrun):
            print(" ".join(str(c) for c in row))
        return 0
    from repro_torch.core.simulator import resolve_device
    print_kernel_table(device=resolve_device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
