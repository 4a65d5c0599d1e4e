"""The probe kernel's share of its roofline: the least time the H100
could take for the launches' bytes and compares (``simbench.roofline``'s
frozen model, from the traffic's own set indices), over the kernel's
device time, both per round."""
import numpy as np

from simbench.roofline import INT32_OPS_PER_S, bound, probe_rank_traffic

KERNEL = "ata_probe_rank_kernel"


def read(cap):
    device_ns = sum(e - s for name, s, e in cap.device if KERNEL in name)
    if not device_ns:
        return None
    ctx = cap.context
    geom, rounds = ctx["geometry"], ctx["rounds"]
    C, S, W = geom["n_cores"], geom["l1_sets"], geom["l1_ways"]
    G = geom["cluster_size"]
    nbytes = ops = 0
    for trace in ctx["traces"]:
        T, _, m = trace.addr.shape
        set_idx = trace.addr.reshape(T, C * m) % S
        cbase = np.broadcast_to(np.repeat(np.arange(C) // G * G, m),
                                (T, C * m))
        b, o = probe_rank_traffic(set_idx, cbase, (T, C, S, W), G)
        nbytes, ops = nbytes + b, ops + o
    # each trace runs under every timing geometry of the grid
    scale = ctx["points"] / len(ctx["traces"]) / rounds
    bound_ms = bound(nbytes * scale, ops * scale, INT32_OPS_PER_S)[0]
    return 100.0 * bound_ms / (device_ns / 1e6 / rounds)
