"""Cache-hierarchy simulator: pluggable L1 policies over shared stages.

One call of :func:`_round` models one *round* for every simulation point
at once: every core issues ``m`` memory requests (one coalesced load
instruction). A round is a pipeline

    L1 policy stage -> shared L2 stage -> L1 fill stage -> NoC stage
                                                        -> timing

where only the first stage differs between architectures
(``repro_torch.core.arch``) and the NoC stage routes the round's remote
flits through an interconnect model (``repro_torch.core.noc``).

:func:`simulate_batch` stacks same-shape traces on a leading point axis
P that every stage carries, and walks the rounds in a Python loop with
static shapes; :func:`simulate` is the P=1 case. The loop never reads a
device value back: the counters move to the host once, in
:func:`_summarize`, which copies the reference's float64 host casts.

Entry points run on ``device=None`` = ``"cuda"`` and raise where there
is no card, unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import tagarray
from repro_torch.core.arch import ArchPolicy, get_arch, registered_archs
from repro_torch.core.arch.base import RequestBatch
from repro_torch.core.contention import group_rank
from repro_torch.core.geometry import (DeviceGeometry, GpuGeometry,
                                       PAPER_GEOMETRY)
from repro_torch.core.noc import (NocModel, NocTraffic, get_noc,
                                  init_noc_state, registered_nocs)
from repro_torch.core.probe import resolve_probe_backend


def resolve_device(device=None) -> torch.device:
    """``device``, defaulting to ``"cuda"``; raises if CUDA is asked for
    and absent (nothing falls back to the CPU silently)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return device


class _TraceBase(NamedTuple):
    addr: np.ndarray       # (T, C, m) int32 line addresses
    is_write: np.ndarray   # (T, C, m) bool
    #: non-memory instructions amortized per request — a scalar, or a
    #: (C,) float32 vector for multi-app mixes (per-core intensity)
    insn_per_req: Union[float, np.ndarray]
    #: (C,) int32 app id per core (multi-tenant mixes), or None — the
    #: canonical single-app trace (all cores app 0)
    core_app: Optional[np.ndarray] = None


class Trace(_TraceBase):
    """A request trace with strict dtype validation at the boundary.

    * ``addr`` must already be int32 (use
      ``repro_torch.core.trace.generators._require_int32`` to narrow
      safely);
    * ``is_write`` must be bool and shape-match ``addr``;
    * ``insn_per_req`` may be a python scalar or a (C,) vector; a
      uniform vector collapses to its scalar;
    * ``core_app`` ids must be dense (every id in ``0..n_apps-1``
      assigned to at least one core); a single-app assignment collapses
      to ``None``, the canonical solo form.
    """
    __slots__ = ()

    def __new__(cls, addr, is_write, insn_per_req, core_app=None):
        addr = np.asarray(addr)
        if addr.dtype != np.int32:
            raise ValueError(
                f"Trace.addr must be int32, got {addr.dtype}; narrow "
                "explicitly (repro_torch.core.trace.generators."
                "_require_int32 checks for overflow)")
        if addr.ndim != 3:
            raise ValueError(
                f"Trace.addr must be (rounds, cores, m), got {addr.shape}")
        is_write = np.asarray(is_write)
        if is_write.dtype != np.bool_:
            raise ValueError(
                f"Trace.is_write must be bool, got {is_write.dtype}")
        if is_write.shape != addr.shape:
            raise ValueError(
                f"Trace.is_write shape {is_write.shape} != addr shape "
                f"{addr.shape}")
        C = addr.shape[1]
        if np.ndim(insn_per_req) == 0:
            insn_per_req = float(insn_per_req)
        else:
            v = np.asarray(insn_per_req, np.float32)
            if v.shape != (C,):
                raise ValueError(
                    f"Trace.insn_per_req must be a scalar or ({C},) "
                    f"per-core vector, got shape {v.shape}")
            if np.all(v == v[0]):
                insn_per_req = float(v[0])   # canonical scalar form
            else:
                insn_per_req = v
        if core_app is not None:
            ca = np.asarray(core_app)
            if not np.issubdtype(ca.dtype, np.integer):
                raise ValueError(
                    f"Trace.core_app must be integer app ids, got "
                    f"{ca.dtype}")
            if ca.shape != (C,):
                raise ValueError(
                    f"Trace.core_app must be ({C},) — one app id per "
                    f"core — got shape {ca.shape}")
            ids = np.unique(ca)
            if ids[0] != 0 or ids[-1] != ids.size - 1:
                raise ValueError(
                    "Trace.core_app ids must be dense 0..n_apps-1 "
                    f"(every app owns at least one core), got {ids.tolist()}")
            core_app = None if ids.size == 1 else ca.astype(np.int32)
        return super().__new__(cls, addr, is_write, insn_per_req, core_app)

    def _replace(self, **kwds) -> "Trace":
        """Route through ``__new__`` so replaced traces re-validate."""
        fields = self._asdict()
        fields.update(kwds)
        return Trace(**fields)

    @property
    def n_cores(self) -> int:
        return self.addr.shape[1]

    @property
    def n_apps(self) -> int:
        """Number of co-scheduled apps (1 for the canonical solo form)."""
        return 1 if self.core_app is None else int(self.core_app.max()) + 1

    @property
    def core_app_ids(self) -> np.ndarray:
        """(C,) int32 app id per core; zeros for the solo form."""
        if self.core_app is None:
            return np.zeros((self.n_cores,), np.int32)
        return self.core_app

    @property
    def insn_vector(self) -> np.ndarray:
        """(C,) float64 per-core instruction intensity."""
        if np.ndim(self.insn_per_req) == 0:
            return np.full((self.n_cores,), float(self.insn_per_req))
        return np.asarray(self.insn_per_req, np.float64)


class AppStats(NamedTuple):
    """Per-app attribution slice of one simulation (raw counters)."""
    app: int            # dense app id (mix slot)
    cores: int          # cores assigned to this app
    instructions: float
    cycles: float       # completion time: max over the app's cores
    requests: float
    local_hits: float
    remote_hits: float
    l1_lat_sum: float
    l1_lat_n: float


class NocStats(NamedTuple):
    """Interconnect block of one simulation (``repro_torch.core.noc``).

    The flit counters track traffic under every model (``ideal``
    delivers everything instantly: ``injected == delivered``,
    ``queued == 0``); the queueing and utilization fields are 0.0 under
    ``ideal``.
    """
    flits_injected: float
    flits_delivered: float
    flits_queued: float        # still in a port queue at end-of-sim
    mean_queue_delay: float    # mean NoC delay over crossing requests
    max_link_util: float       # hotspot: busiest link busy / cycles
    mean_link_util: float      # mean busy / cycles over *active* links


class SimResult(NamedTuple):
    ipc: float
    l1_latency: float          # mean per-load L1-complex completion time
    local_hit_rate: float
    remote_hit_rate: float     # served by a peer L1 (0 for private/decoupled)
    l1_hit_rate: float         # served anywhere in the L1 complex
    l2_accesses: float
    dram_accesses: float
    noc_flits: float
    cycles: float
    instructions: float
    #: per-app attribution (one AppStats per mix slot; a single entry
    #: covering every core for solo traces)
    per_app: Tuple[AppStats, ...] = ()
    #: interconnect metrics (all-zero under the default ``ideal`` model)
    noc: NocStats = NocStats(0.0, 0.0, 0.0, 0.0, 0.0, 0.0)


class _Routing(NamedTuple):
    """A round's request routing indices, fixed for a whole simulation
    (they depend only on the geometry and the (P, C, m) shape)."""
    core: torch.Tensor       # (P, R) int32
    cluster: torch.Tensor    # (P, R) int32
    self_slot: torch.Tensor  # (P, R) int32
    peers: torch.Tensor      # (P, R, G) int32


def _routing(geom, P: int, C: int, m: int, device) -> _Routing:
    G = geom.cluster_size
    core = torch.arange(C, dtype=torch.int32,
                        device=device).repeat_interleave(m)
    cluster = core // G
    peers = cluster[:, None] * G + torch.arange(G, dtype=torch.int32,
                                                device=device)
    R = C * m
    # materialized (not expanded): the probe kernel takes contiguous rows
    return _Routing(core.expand(P, R).contiguous(),
                    cluster.expand(P, R).contiguous(),
                    (core % G).expand(P, R).contiguous(),
                    peers.expand(P, R, G).contiguous())


def _request_batch(geom, addr, is_write, routing: _Routing) -> RequestBatch:
    """Flatten one round's (P, C, m) requests and attach routing."""
    P = addr.shape[0]
    addr = addr.reshape(P, -1)
    return RequestBatch(addr=addr, is_write=is_write.reshape(P, -1),
                        core=routing.core, cluster=routing.cluster,
                        self_slot=routing.self_slot,
                        set_idx=addr % geom.l1_sets, peers=routing.peers)


def _round(policy: ArchPolicy, noc_model: NocModel, geom, insn_per_req,
           core_app, state, addr, is_write, t, routing: _Routing, *,
           probe_backend: str):
    """One simulation round for all P points; returns the new state and
    the round's (P, C) per-core served-load latencies.

    state = (l1, l2, noc, stats); addr/is_write are the round's
    (P, C, m) requests; ``t`` the round counter (int32 zero-dim tensor);
    ``insn_per_req`` is (P, 1) or (P, C) float32; ``core_app`` the
    (P, C) app-id channel of the per-app attribution.
    """
    l1, l2, noc, stats = state
    P, C, m = addr.shape
    reqs = _request_batch(geom, addr, is_write, routing)
    addr = reqs.addr                              # (P, R) flattened
    R = reqs.n_requests

    # ---- L1 policy stage (the only architecture-specific part) -----------
    out = policy.l1_stage(geom, l1, reqs, t, backend=probe_backend)
    l1 = out.l1
    go_l2 = out.go_l2
    noc_flits = out.noc_flits
    occupancy = out.occupancy

    # ---- L2 stage ---------------------------------------------------------
    l2_part = addr % geom.l2_parts
    l2_set = (addr // geom.l2_parts) % geom.l2_sets
    l2_hit, l2_way, _ = tagarray.probe(l2, l2_part, l2_set, addr)
    l2_rank, l2_size = group_rank(l2_part, go_l2, geom.l2_parts)
    l2_time = (geom.lat_l2 + l2_rank.to(torch.float32) * geom.svc_l2
               + torch.where(l2_hit, 0.0, geom.lat_dram))
    occupancy = torch.maximum(
        occupancy,
        torch.where(go_l2, l2_size.to(torch.float32) * geom.svc_l2, 0.0))
    l2 = tagarray.touch(l2, l2_part, l2_set, l2_way, t, go_l2 & l2_hit)
    l2, _ = tagarray.fill(l2, l2_part, l2_set, l2_way, addr, t,
                          go_l2 & ~l2_hit)
    noc_flits = noc_flits + go_l2.sum(dim=-1) * geom.flits_per_line

    # ---- L1 fill on L2 return (and on remote fetch: replicate locally) ----
    fill_mask = go_l2 | out.remote_hits
    if out.bypass_fill is not None:
        fill_mask = fill_mask & ~out.bypass_fill
    _, fway, _ = tagarray.probe(l1, out.fill_cache, out.fill_set, addr,
                                policy=policy.replacement)
    l1, wb = tagarray.fill(l1, out.fill_cache, out.fill_set, fway, addr, t,
                           fill_mask, dirty=reqs.is_write)
    noc_flits = noc_flits + wb.sum(dim=-1) * geom.flits_per_line

    # ---- NoC stage: remote flits through the interconnect model ----------
    req_flits = out.noc_req_flits
    if req_flits is None:
        req_flits = out.remote_hits * geom.flits_per_line
    traffic = NocTraffic(
        src=out.noc_src if out.noc_src is not None else reqs.core,
        dst=reqs.core, cluster=reqs.cluster, flits=req_flits,
        mask=req_flits > 0)
    transit = noc_model.transit(geom, noc, traffic)
    noc = transit.state
    occupancy = torch.maximum(occupancy, transit.occupancy)

    # ---- timing ------------------------------------------------------------
    latency = (torch.where(out.served, out.l1_time, out.pre_l2 + l2_time)
               + transit.delay)                                # (P, R)
    # Warp multithreading hides individual request latencies; the core's
    # sustained pace is set by *mean* outstanding latency per load, while
    # serial-resource occupancy is a hard throughput bound (max over m).
    per_core_lat = latency.reshape(P, C, m).sum(dim=-1) / m
    per_core_occ = occupancy.reshape(P, C, m).amax(dim=-1)
    pace = m * insn_per_req / geom.issue_rate
    round_cost = torch.maximum(torch.maximum(pace, per_core_occ),
                               per_core_lat / geom.hide)       # (P, C)

    # Fig. 10 metric: completion time of the L1 accesses of one load
    # instruction, over loads fully served by the L1 complex.
    all_served = out.served.reshape(P, C, m).all(dim=-1)
    l1_complete = (out.l1_time + transit.delay).reshape(P, C, m).amax(dim=-1)

    # Per-app attribution: hit counters scatter-add by the issuing core's
    # app id (small integers in float32 — exact in any order). The
    # per-app latency sum is order-dependent in float32, so the round
    # hands its per-core values back and _fold_app_lat adds them on the
    # host in the reference's order.
    req_app = core_app.gather(-1, reqs.core.long())             # (P, R)
    f32 = torch.float32
    app_served_lat = torch.where(all_served, l1_complete, 0.0)  # (P, C)

    stats = {
        "cycles": stats["cycles"] + round_cost,
        "l1_lat_sum": stats["l1_lat_sum"] + app_served_lat.sum(dim=-1),
        "l1_lat_n": stats["l1_lat_n"] + all_served.sum(dim=-1),
        "local_hits": stats["local_hits"] + out.local_hits.sum(dim=-1),
        "remote_hits": stats["remote_hits"] + out.remote_hits.sum(dim=-1),
        "requests": stats["requests"] + R,
        "l2_accesses": stats["l2_accesses"] + go_l2.sum(dim=-1),
        "dram": stats["dram"] + (go_l2 & ~l2_hit).sum(dim=-1),
        "noc_flits": stats["noc_flits"] + noc_flits,
        "app_local": stats["app_local"].scatter_add(
            -1, req_app, out.local_hits.to(f32)),
        "app_remote": stats["app_remote"].scatter_add(
            -1, req_app, out.remote_hits.to(f32)),
        "app_lat_n": stats["app_lat_n"].scatter_add(
            -1, core_app, all_served.to(f32)),
    }
    return (l1, l2, noc, stats), app_served_lat


def _fold_app_lat(served_lat: np.ndarray, core_app: np.ndarray,
                  n_apps: int) -> np.ndarray:
    """Per-app sum of the served loads' L1 latencies, (P, n_apps) float32.

    ``served_lat`` is (T, P, C), one row of per-core values per round. The
    values go into a float32 accumulator one core at a time, round by
    round (``np.add.accumulate`` adds strictly in sequence): the order of
    the reference's sequential scatter-add, whose float32 rounding this
    reproduces once the sum outgrows 2**20 (an atomic scatter on the card
    adds in no fixed order). Other apps' cores add an exact 0.
    """
    T, P, C = served_lat.shape
    seq = served_lat.transpose(1, 0, 2).reshape(P, T * C)
    acc = np.zeros((P, n_apps), np.float32)
    for a in range(n_apps):
        mine = np.tile(core_app == a, (1, T))                   # (P, T*C)
        acc[:, a] = np.add.accumulate(np.where(mine, seq, np.float32(0)),
                                      axis=1, dtype=np.float32)[:, -1]
    return acc


def _init_stats(geom, P: int, n_apps: int, device) -> Dict[str, torch.Tensor]:
    f32 = dict(dtype=torch.float32, device=device)
    stats = {k: torch.zeros((P,), **f32)
             for k in ("l1_lat_sum", "l1_lat_n", "local_hits", "remote_hits",
                       "requests", "l2_accesses", "dram", "noc_flits")}
    stats["cycles"] = torch.zeros((P, geom.n_cores), **f32)
    for k in ("app_local", "app_remote", "app_lat_n"):
        stats[k] = torch.zeros((P, n_apps), **f32)
    return stats


def _summarize(stats, trace: Trace) -> SimResult:
    """One point's host-side counters -> :class:`SimResult` (the
    reference's float64 casts, operation for operation)."""
    T, C, m = trace.addr.shape
    cycles_per_core = np.asarray(stats["cycles"], np.float64)  # (C,)
    if np.ndim(trace.insn_per_req) == 0:
        instructions = T * C * m * float(trace.insn_per_req)
    else:
        instructions = float(T * m * np.sum(trace.insn_vector))
    cycles = float(stats["cycles"].max())
    requests = float(stats["requests"])
    local = float(stats["local_hits"])
    remote = float(stats["remote_hits"])
    lat_n = float(stats["l1_lat_n"])

    ns = stats["noc"]
    busy = np.asarray(ns["link_busy"], np.float64)
    active = int((busy > 0).sum())
    delay_n = float(ns["delay_n"])
    noc_block = NocStats(
        flits_injected=float(ns["injected"]),
        flits_delivered=float(ns["delivered"]),
        flits_queued=float(np.asarray(ns["queue"], np.float64).sum()),
        mean_queue_delay=(float(ns["delay_sum"]) / delay_n if delay_n
                          else 0.0),
        max_link_util=(float(busy.max()) / cycles if busy.size else 0.0),
        mean_link_util=(float(busy.sum()) / (cycles * active) if active
                        else 0.0),
    )

    ids = trace.core_app_ids
    insn_vec = trace.insn_vector
    per_app = []
    for a in range(trace.n_apps):
        sel = ids == a
        k = int(sel.sum())
        per_app.append(AppStats(
            app=a, cores=k,
            instructions=float(T * m * insn_vec[sel].sum()),
            cycles=float(cycles_per_core[sel].max()),
            requests=float(T * k * m),
            local_hits=float(stats["app_local"][a]),
            remote_hits=float(stats["app_remote"][a]),
            l1_lat_sum=float(stats["app_lat_sum"][a]),
            l1_lat_n=float(stats["app_lat_n"][a])))

    return SimResult(
        ipc=instructions / cycles,
        # NaN when no load was ever fully served inside the L1 complex
        l1_latency=(float(stats["l1_lat_sum"]) / lat_n if lat_n
                    else float("nan")),
        local_hit_rate=local / requests,
        remote_hit_rate=remote / requests,
        l1_hit_rate=(local + remote) / requests,
        l2_accesses=float(stats["l2_accesses"]),
        dram_accesses=float(stats["dram"]),
        noc_flits=float(stats["noc_flits"]),
        cycles=cycles,
        instructions=instructions,
        per_app=tuple(per_app),
        noc=noc_block,
    )


def _check_arch(arch: str) -> None:
    if arch not in registered_archs():
        raise ValueError(f"arch must be one of {registered_archs()}")


def _check_noc(noc: str) -> None:
    if noc not in registered_nocs():
        raise ValueError(f"noc must be one of {registered_nocs()}")


def trace_kind(trace: Trace) -> tuple:
    """The batching key of a trace: (addr shape, insn shape, n_apps).
    Only traces of one kind stack into one :func:`simulate_batch`."""
    return (trace.addr.shape, np.shape(trace.insn_per_req), trace.n_apps)


def simulate(arch: str, trace: Trace, geom: GpuGeometry = PAPER_GEOMETRY,
             *, noc: str = "ideal", probe_backend: Optional[str] = None,
             device=None) -> SimResult:
    """Run a trace through one architecture and summarize.

    ``probe_backend`` selects the ATA probe lowering
    (``repro_torch.core.probe``; default: the kernel on CUDA, plain
    torch on the CPU); every backend gives bit-identical results.
    """
    return simulate_batch(arch, [trace], geom, noc=noc,
                          probe_backend=probe_backend, device=device)[0]


def simulate_batch(arch: str, traces: Sequence[Trace],
                   geom: GpuGeometry = PAPER_GEOMETRY, *,
                   noc: str = "ideal", probe_backend: Optional[str] = None,
                   device=None) -> List[SimResult]:
    """Run many same-kind traces through one architecture in one pass.

    The traces stack on a leading point axis P that every stage of every
    round carries; each point's result equals its own :func:`simulate`
    bit for bit (points never read each other's state).
    """
    _check_arch(arch)
    _check_noc(noc)
    device = resolve_device(device)
    probe_backend = resolve_probe_backend(probe_backend, device)
    if not traces:
        return []
    kinds = {trace_kind(t) for t in traces}
    if len(kinds) != 1:
        raise ValueError(
            f"simulate_batch needs same-shape, same-kind traces "
            f"((T, C, m), insn shape, n_apps), got {sorted(kinds)}")
    T, C, m = traces[0].addr.shape
    if C != geom.n_cores:
        raise ValueError(f"traces have {C} cores, geometry {geom.n_cores}")
    P = len(traces)
    n_apps = traces[0].n_apps
    policy = get_arch(arch)
    noc_model = get_noc(noc)
    g = DeviceGeometry(geom, device)

    # round-major, so each round's (P, C, m) slice is contiguous
    addr = torch.from_numpy(np.stack([t.addr for t in traces], axis=1)
                            ).to(device)
    is_write = torch.from_numpy(np.stack([t.is_write for t in traces],
                                         axis=1)).to(device)
    insn = torch.from_numpy(np.stack(
        [np.asarray(t.insn_per_req, np.float32).reshape(-1)
         for t in traces])).to(device)                        # (P, 1|C)
    core_app_np = np.stack([t.core_app_ids for t in traces]).astype(np.int64)
    core_app = torch.from_numpy(core_app_np).to(device)
    ts = torch.arange(T, dtype=torch.int32, device=device)
    routing = _routing(g, P, C, m, device)

    state = (tagarray.init_tag_state(
                 C, geom.l1_sets, geom.l1_ways, batch=P, device=device,
                 # the zoo extensions the policy declares (zero-sized
                 # for the paper policies)
                 victim_ways=policy.victim_ways,
                 thrash_lanes=C if policy.track_thrash else 0),
             tagarray.init_tag_state(geom.l2_parts, geom.l2_sets,
                                     geom.l2_ways, batch=P, device=device),
             init_noc_state(noc_model.n_links(g), batch=P, device=device),
             _init_stats(g, P, n_apps, device))
    served_lat = torch.empty((T, P, C), dtype=torch.float32, device=device)
    for i in range(T):
        state, served_lat[i] = _round(policy, noc_model, g, insn, core_app,
                                      state, addr[i], is_write[i], ts[i],
                                      routing, probe_backend=probe_backend)
    stats = {k: v.cpu().numpy() for k, v in state[3].items()}
    stats["app_lat_sum"] = _fold_app_lat(served_lat.cpu().numpy(),
                                         core_app_np, n_apps)
    noc_state = {k: v.cpu().numpy() for k, v in state[2].items()}
    return [_summarize({**{k: v[b] for k, v in stats.items()},
                        "noc": {k: v[b] for k, v in noc_state.items()}},
                       tr)
            for b, tr in enumerate(traces)]
