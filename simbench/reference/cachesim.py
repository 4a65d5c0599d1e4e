"""Plain reference of the cache-hierarchy simulator, for the ``ata`` and
``private`` L1s over the L2 and the ideal NoC (paper Table II).

It works each point's results out again from the traces and the
geometry the benchmark hands to both sides, with plain tensor operations
and nothing of the program: no kernel, no stacking of policies, no
telemetry, no host fold. One call simulates P points of one shape
together; points never read each other's state.

A round, for every point at once: each core issues its ``m`` requests;
the L1 stage decides which are served inside the L1 complex; the misses
queue at their L2 partition and go on to DRAM on an L2 miss; returns
(and remote hits) fill the requesting core's L1; the core's cycles grow
by the largest of its issue pace, its serial-resource occupancy and its
mean request latency over the latency-hiding divisor.

* ``private``: a request hits only its own core's L1.
* ``ata``: every request's set is looked up in all of its cluster's
  tag arrays at once (the aggregated tag array). A miss in its own array
  that hits a clean copy in a peer is served remotely, unless it is a
  write; the remote hits queue in arrival order at the serving core's
  data port, ``svc_port`` cycles each.

Tag arrays are LRU: a lookup returns the first matching way, else the
first invalid way, else the least recently touched one. Where several
requests of a round write one (array, set, way), the request with the
highest index wins; a touch keeps the latest round.

``timing_dtype`` is the type of the timing arithmetic and the counters:
float32 as the configuration states, or bfloat16 for the control.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

#: cycles to detect an L1 miss before a request moves on
TAG_CHECK = 8.0
INT32_MIN = -(2 ** 31)

#: integer counters of a result, compared exactly
COUNTERS = ("l2_accesses", "dram_accesses", "noc_flits", "app.requests",
            "app.local_hits", "app.remote_hits", "app.l1_lat_n",
            "noc.flits_injected", "noc.flits_delivered", "noc.flits_queued")
#: every value of a result, compared by relative gap
VALUES = ("ipc", "l1_latency", "local_hit_rate", "remote_hit_rate",
          "l1_hit_rate", "cycles", "instructions", "app.instructions",
          "app.cycles", "app.l1_lat_sum", "noc.mean_queue_delay",
          "noc.max_link_util", "noc.mean_link_util") + COUNTERS


class _Tags:
    """LRU tag arrays (P, A, S, W) with in-place updates."""

    def __init__(self, P, A, S, W, device):
        self.P, self.A, self.S, self.W = P, A, S, W
        shape = (P, A, S, W)
        self.tags = torch.zeros(shape, dtype=torch.int32, device=device)
        self.last = torch.full(shape, -1, dtype=torch.int32, device=device)
        self.valid = torch.zeros(shape, dtype=torch.bool, device=device)
        self.dirty = torch.zeros(shape, dtype=torch.bool, device=device)

    def rows(self, array, sets):
        """Flat (point, array, set) row of each request."""
        p = torch.arange(self.P, device=array.device).view(
            (self.P,) + (1,) * (array.dim() - 1))
        return (p * self.A + array.long()) * self.S + sets.long()

    def ways(self, rows, addr):
        """(match, valid) over the W ways of each row."""
        tags = self.tags.view(-1, self.W)[rows]
        valid = self.valid.view(-1, self.W)[rows]
        return (tags == addr.view(addr.shape + (1,) * (rows.dim()
                                                       - addr.dim() + 1))
                ) & valid, valid

    def lookup(self, array, sets, addr):
        """(hit, way, dirty hit); the way is the first hit, else the LRU
        victim."""
        rows = self.rows(array, sets)
        match, valid = self.ways(rows, addr)
        hit = match.any(dim=-1)
        first = _first_true(match)
        last = self.last.view(-1, self.W)[rows]
        victim = torch.where(valid, last, INT32_MIN).argmin(dim=-1)
        dirty = (match & self.dirty.view(-1, self.W)[rows]).any(dim=-1)
        return hit, torch.where(hit, first, victim), dirty

    def element(self, array, sets, way):
        return self.rows(array, sets) * self.W + way.long()

    def touch(self, elem, now, mask, set_dirty=None):
        _latest(self.last, elem, now, mask)
        if set_dirty is not None:
            _write(self.dirty, elem, mask & set_dirty, True)

    def fill(self, elem, addr, now, mask, dirty):
        """Install the masked requests' lines; returns the evictions of
        dirty lines."""
        evicted = (mask & self.valid.view(-1)[elem]
                   & self.dirty.view(-1)[elem])
        _write(self.tags, elem, mask, addr)
        _write(self.valid, elem, mask, True)
        _write(self.dirty, elem, mask, dirty)
        _latest(self.last, elem, now, mask)
        return evicted


def _first_true(x):
    """Index of the first True along the last axis (0 where none)."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    return torch.where(x, idx, n).amin(dim=-1).remainder(n)


def _latest(field, elem, now, mask):
    """``field[elem] = max(field[elem], now)`` where ``mask``."""
    src = torch.where(mask, now, INT32_MIN).to(field.dtype)
    field.view(-1).scatter_reduce_(0, elem.reshape(-1), src.reshape(-1),
                                   "amax")


def _write(field, elem, mask, value):
    """``field[elem] = value`` where ``mask``; of several requests aimed
    at one element, the one with the highest index wins."""
    flat = field.view(-1)
    elem = elem.reshape(-1)
    mask = mask.reshape(-1)
    lane = torch.arange(elem.numel(), device=elem.device)
    winner = torch.full((flat.numel(),), -1, dtype=torch.long,
                        device=elem.device)
    winner.scatter_reduce_(0, elem[mask], lane[mask], "amax")
    win = winner[elem]
    keep = win >= 0
    if torch.is_tensor(value):
        value = value.reshape(-1)[win.clamp(min=0)].to(field.dtype)
    else:
        value = torch.full_like(flat[elem], value)
    flat[elem[keep]] = value[keep]


def _group_rank(keys, mask, n_keys):
    """Each masked request's position among the earlier masked requests
    of its key, and the size of its key's group (0 where unmasked)."""
    k = keys.long()
    onehot = ((k[..., None] == torch.arange(n_keys, device=k.device))
              & mask[..., None]).to(torch.int32)
    before = onehot.cumsum(dim=-2) - onehot
    rank = before.gather(-1, k[..., None])[..., 0]
    size = onehot.sum(dim=-2).gather(-1, k)
    return torch.where(mask, rank, 0), torch.where(mask, size, 0)


def simulate(arch: str, traces: Sequence, geoms: Sequence[Dict], *,
             device, timing_dtype=torch.float32) -> List[Dict[str, float]]:
    """One result per point, as {name: value} over :data:`VALUES`.

    ``traces`` are (addr (T, C, m) int32, is_write (T, C, m) bool,
    insn_per_req) of one shape; ``geoms`` one dict of the Table II
    fields per point, of one structure.
    """
    if arch not in ("ata", "private"):
        raise ValueError(f"the reference models ata and private, not {arch}")
    ft = timing_dtype
    g0 = geoms[0]
    C, G = g0["n_cores"], g0["cluster_size"]
    T, _, m = traces[0][0].shape
    P, R = len(traces), C * m

    def scalar(name):
        return torch.tensor([float(g[name]) for g in geoms], dtype=ft,
                            device=device)[:, None]

    lat_l1, lat_xbar = scalar("lat_l1"), scalar("lat_xbar")
    lat_l2, lat_dram = scalar("lat_l2"), scalar("lat_dram")
    svc_port, svc_l2 = scalar("svc_port"), scalar("svc_l2")
    flits_line = scalar("flits_per_line")
    issue_rate, hide = scalar("issue_rate"), scalar("hide")
    insn = torch.tensor([float(t[2]) for t in traces], dtype=ft,
                        device=device)[:, None]
    addr_all = torch.from_numpy(np.stack([t[0] for t in traces], 1)).to(device)
    write_all = torch.from_numpy(np.stack([t[1] for t in traces], 1)).to(device)

    l1 = _Tags(P, C, g0["l1_sets"], g0["l1_ways"], device)
    l2 = _Tags(P, g0["l2_parts"], g0["l2_sets"], g0["l2_ways"], device)
    core = torch.arange(C, device=device).repeat_interleave(m).expand(P, R)
    cluster = core // G
    slot = core % G
    peers = (cluster * G)[..., None] + torch.arange(G, device=device)
    is_self = torch.arange(G, device=device) == slot[..., None]

    def zeros(*shape):
        return torch.zeros((P,) + shape, dtype=ft, device=device)

    cycles = zeros(C)
    stats = {k: zeros() for k in (
        "lat_sum", "lat_n", "local", "remote", "requests", "l2", "dram",
        "flits", "injected", "delay_n")}

    for t in range(T):
        now = torch.tensor(t, dtype=torch.int32, device=device)
        addr = addr_all[t].reshape(P, R)
        is_write = write_all[t].reshape(P, R)
        sets = addr % g0["l1_sets"]

        # ---- L1 complex ----
        if arch == "ata":
            rows = l1.rows(peers, sets[..., None])              # (P, R, G)
            match, _ = l1.ways(rows, addr)
            hits = match.any(dim=-1)
            way = _first_true(match)
            dirty = (match & l1.dirty.view(-1, l1.W)[rows]).any(dim=-1)
            local = (hits & is_self).any(dim=-1)
            own_way = way.gather(-1, slot[..., None])[..., 0]
            peer_hit = hits & ~is_self
            src_slot = _first_true(peer_hit)
            src = cluster * G + src_slot
            src_dirty = dirty.gather(-1, src_slot[..., None])[..., 0]
            remote = (~is_write & ~local & peer_hit.any(dim=-1)
                      & ~src_dirty)
            prank, psize = _group_rank(src, remote, C)
            occupancy = torch.where(remote, psize.to(ft) * svc_port, 0.0)
            l1_time = torch.where(
                local, lat_l1,
                torch.where(remote, lat_l1 + lat_xbar
                            + prank.to(ft) * svc_port, TAG_CHECK))
            l1.touch(l1.element(core, sets, own_way), now, local,
                     set_dirty=is_write)
            noc_src = torch.where(remote, src, core)
        else:
            local, own_way, _ = l1.lookup(core, sets, addr)
            remote = torch.zeros_like(local)
            occupancy = zeros(R)
            l1_time = torch.where(local, lat_l1, TAG_CHECK)
            l1.touch(l1.element(core, sets, own_way), now, local,
                     set_dirty=is_write)
            noc_src = core
        served = local | remote
        go_l2 = ~served
        flits = remote.sum(dim=-1) * flits_line[:, 0]

        # ---- L2 ----
        part = addr % g0["l2_parts"]
        l2_set = (addr // g0["l2_parts"]) % g0["l2_sets"]
        l2_hit, l2_way, _ = l2.lookup(part, l2_set, addr)
        rank, size = _group_rank(part, go_l2, g0["l2_parts"])
        l2_time = (lat_l2 + rank.to(ft) * svc_l2
                   + torch.where(l2_hit, 0.0, lat_dram))
        occupancy = torch.maximum(
            occupancy, torch.where(go_l2, size.to(ft) * svc_l2, 0.0))
        l2_elem = l2.element(part, l2_set, l2_way)
        l2.touch(l2_elem, now, go_l2 & l2_hit)
        l2.fill(l2_elem, addr, now, go_l2 & ~l2_hit, False)
        flits = flits + go_l2.sum(dim=-1) * flits_line[:, 0]

        # ---- L1 fill of every return and remote hit ----
        fill_way = l1.lookup(core, sets, addr)[1]
        wb = l1.fill(l1.element(core, sets, fill_way), addr, now,
                     go_l2 | remote, is_write)
        flits = flits + wb.sum(dim=-1) * flits_line[:, 0]

        # ---- ideal NoC: the remote data crosses at once ----
        req_flits = remote * flits_line
        crossing = (req_flits > 0) & (noc_src != core)
        stats["injected"] += torch.where(crossing, req_flits, 0.0).sum(dim=-1)
        stats["delay_n"] += crossing.sum(dim=-1)

        # ---- timing ----
        latency = torch.where(served, l1_time, TAG_CHECK + l2_time)
        core_lat = latency.reshape(P, C, m).sum(dim=-1) / m
        core_occ = occupancy.reshape(P, C, m).amax(dim=-1)
        pace = m * insn / issue_rate
        cycles += torch.maximum(torch.maximum(pace, core_occ),
                                core_lat / hide)
        all_served = served.reshape(P, C, m).all(dim=-1)
        complete = l1_time.reshape(P, C, m).amax(dim=-1)
        stats["lat_sum"] += torch.where(all_served, complete, 0.0).sum(dim=-1)
        stats["lat_n"] += all_served.sum(dim=-1)
        stats["local"] += local.sum(dim=-1)
        stats["remote"] += remote.sum(dim=-1)
        stats["requests"] += R
        stats["l2"] += go_l2.sum(dim=-1)
        stats["dram"] += (go_l2 & ~l2_hit).sum(dim=-1)
        stats["flits"] += flits

    host = {k: v.double().cpu().numpy() for k, v in stats.items()}
    core_cycles = cycles.double().cpu().numpy()
    out = []
    for p, trace in enumerate(traces):
        s = {k: float(v[p]) for k, v in host.items()}
        instructions = T * C * m * float(trace[2])
        cyc = float(core_cycles[p].max())
        req = s["requests"]
        out.append({
            "ipc": instructions / cyc,
            "l1_latency": (s["lat_sum"] / s["lat_n"] if s["lat_n"]
                           else float("nan")),
            "local_hit_rate": s["local"] / req,
            "remote_hit_rate": s["remote"] / req,
            "l1_hit_rate": (s["local"] + s["remote"]) / req,
            "l2_accesses": s["l2"], "dram_accesses": s["dram"],
            "noc_flits": s["flits"], "cycles": cyc,
            "instructions": instructions,
            "app.instructions": instructions, "app.cycles": cyc,
            "app.requests": float(T * C * m),
            "app.local_hits": s["local"], "app.remote_hits": s["remote"],
            "app.l1_lat_sum": s["lat_sum"], "app.l1_lat_n": s["lat_n"],
            "noc.flits_injected": s["injected"],
            "noc.flits_delivered": s["injected"], "noc.flits_queued": 0.0,
            "noc.mean_queue_delay": 0.0, "noc.max_link_util": 0.0,
            "noc.mean_link_util": 0.0,
        })
    return out
