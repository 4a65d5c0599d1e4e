"""The yardstick of the kernels' roofline shares: the H100's published
peaks and the byte and operation model of one ``ata_probe_rank`` launch,
frozen copies of the port's ``repro_torch.launch.roofline`` (``bound``,
``probe_rank_traffic``) so that later changes to the program cannot
change them. The count of distinct rows is the port's, taken by a
histogram rather than a sort.
"""
from __future__ import annotations

import numpy as np

#: H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12       # CUDA-core rate, outside the tensor cores
INT32_OPS_PER_S = FP32_OPS_PER_S


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
    S, W) (or (C, S, W)). Every distinct tag row a request's cluster
    probes is read once (int32 tag, valid and dirty bytes per way), the
    request inputs read and the six outputs written once; one compare per
    way of each row scanned."""
    *lead, C, S, W = tags_shape
    P = int(np.prod(lead)) if lead else 1
    set_idx = np.asarray(set_idx).reshape(P, -1)
    cbase = np.asarray(cluster_base).reshape(P, -1)
    R = set_idx.shape[1]
    caches = cbase[..., None] + np.arange(cluster_size)       # (P, R, G)
    p = np.arange(P)[:, None, None]
    rows = ((p * C + caches) * S + set_idx[..., None])[caches < C]
    # distinct rows, counted by a histogram (linear, where a sort is not)
    state_bytes = np.count_nonzero(np.bincount(rows)) * W * (4 + 1 + 1)
    io_bytes = P * R * (4 * 4 + 1) + P * R * (1 + 4 + 1 + 4 + 4 + 4)
    return state_bytes + io_bytes, P * R * cluster_size * W
