"""ATA serving engine with batched admission, on PyTorch.

Replays a :class:`~repro_torch.core.trace.serving.RequestStream` grid —
``B = stream.slots`` admission slots per shard per round — under one of
:data:`SERVING_POLICIES`, with every shard of a sub-round in one set of
tensor ops and no per-request Python. The numpy oracle
(:func:`repro_torch.serving.ref.run_stream`) is the bit-exact reference
for every counter.

Round semantics (those of the reference engine):

1. **Probe** — every arriving request compares its block chain against
   the sub-round-start replicated directory of all shards, the
   aggregated-tag-array compare of the paper; the ``cuda`` probe backend
   is the hand-written kernel
   (:mod:`repro_torch.kernels.ata_tag_probe`), ``torch`` the plain
   gather/compare.
2. **Walk** — each request reuses its leading hits (prefix semantics);
   reuse of an own-shard block is revalidated against the *live* local
   directory (this shard's own replication inserts can evict a block
   mid-walk), remote presence is vouched for by the probe. Under ``ata``
   a remote hit replicates into the local directory; after the first
   failure all remaining blocks recompute and seal locally. The walk is
   sequential in the block index ``k`` (block ``k+1`` reads the row
   block ``k`` wrote), so it stays a static unroll over the K blocks.
3. **Price** — remote fetches become
   :class:`~repro_torch.core.noc.NocTraffic` (``flits_per_block`` flits
   from owner to requester) through a pluggable NoC model whose state
   carries across rounds; per-request latency folds hit/fetch/recompute
   terms, the broadcast policy's probe round trip, and the NoC delay +
   occupancy.

**Batched round contract** (``B > 1``): each admission round runs ``B``
sequential sub-rounds — slot ``b`` probes a directory that already
holds slots ``< b``'s inserts, and the LRU clock ticks once per
sub-round (``t*B + b + 1``) — and routes the whole round's remote
fetches through **one** NoC round, slot-major. Counters are therefore
those of the ``B=1`` replay; only the throughput model changes.

How the port keeps a sub-round cheap on the card (it is eager, so every
tensor op is one or a few kernel launches issued by the host):

* the directory is one ``(C*S + 1, W, 2)`` int32 tensor of
  ``[tag, (last + 1) * W]`` lanes, **updated in place** with
  ``index_put_`` (no copy per block step). Row ``C*S`` is a scratch row:
  lanes that must not write (the reference's ``mode="drop"`` scatter)
  write there instead, so every shape is static and nothing syncs the
  host. Within a block step every shard writes its own row, so the real
  targets are distinct;
* validity is ``tag != 0`` (block hashes are >= 1 by the stream
  contract, which :func:`serve_stream` checks), and way selection is one
  ``min`` over a packed key — present ``w`` < free ``W + w`` < LRU
  ``(last + 1) * W + w`` — whose argmin is the way (keys are distinct
  modulo W): first-occurrence ties, as the reference's packed key;
* every value that depends only on the stream (set rows, block validity,
  write targets and values) is computed once per chunk for all of its
  sub-rounds, and the counters, latencies and NoC rounds are derived
  per chunk from the walk's emitted ``reused`` lanes — the NoC never
  feeds back into the directory;
* the LRU clock is a host integer (``t*B + b + 1``), never read back
  from the device, and the host reads the device once per
  ``_CHUNK_SUBROUNDS`` sub-rounds, reducing the emissions in int64 /
  float64 as the reference does.

Policies: ``private`` (local-only), ``broadcast`` (probe all shards on
local miss — the oracle's ``remote``), ``ata`` (replicated directory,
zero probe messages).

``telemetry=`` (a :class:`~repro_torch.core.telemetry.TelemetryConfig`)
adds a windowed :class:`~repro_torch.obs.ServeTimeline` and the
value-resolved latency histogram, both built on the host from the grids
the replay already streams back; on the device it adds one reduction
per chunk (the probe messages of each admission round) under
``broadcast`` and nothing to a sub-round.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.geometry import GpuGeometry
from repro_torch.core.noc import NocTraffic, get_noc, init_noc_state
from repro_torch.core.probe import PROBE_BACKENDS, resolve_probe_backend
from repro_torch.core.simulator import resolve_device
from repro_torch.core.telemetry import (TelemetryConfig, hist_quantile,
                                        serving_hist_bins)
from repro_torch.kernels.ata_tag_probe import ata_tag_probe

SERVING_POLICIES = ("private", "broadcast", "ata")

#: Directory-probe backends: ``torch`` (plain gather/compare, the
#: reference's ``lax`` path) and ``cuda`` (the ``ata_tag_probe`` kernel).
#: ``None`` picks the device's default, as in
#: :func:`repro_torch.core.probe.resolve_probe_backend`.
SERVING_PROBE_BACKENDS = PROBE_BACKENDS

#: Sub-rounds per chunk: the host reads the device once per chunk (a
#: whole number of admission rounds: ``(512 // B) * B`` sub-rounds).
_CHUNK_SUBROUNDS = 512


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Static engine configuration.

    The directory mirrors :class:`~repro_torch.serving.ref.AtaCacheConfig`
    (``n_shards`` comes from the stream). Timing terms are abstract
    serving cycles; the NoC scalars feed the
    :class:`~repro_torch.core.geometry.GpuGeometry` the interconnect
    models price traffic with.
    """
    n_sets: int = 64
    n_ways: int = 8
    # --- latency model (cycles per block / per request) -------------
    lat_hit: float = 1.0        # local pool read per block
    lat_fetch: float = 4.0      # remote fetch base per block (+ NoC)
    lat_recompute: float = 40.0  # prefill recompute per block
    lat_probe_rtt: float = 6.0  # broadcast probe round trip per request
    # --- interconnect ----------------------------------------------
    flits_per_block: int = 4
    noc: str = "ideal"
    noc_bw: float = 16.0
    # --- probe backend (None: the device's default) -----------------
    probe_backend: Optional[str] = None

    def __post_init__(self):
        get_noc(self.noc)   # raises with the registered list
        if self.probe_backend not in (None,) + SERVING_PROBE_BACKENDS:
            raise ValueError(
                f"probe_backend must be None or one of "
                f"{SERVING_PROBE_BACKENDS}, got {self.probe_backend!r}")

    def geometry(self, n_shards: int) -> GpuGeometry:
        """The one-cluster geometry the NoC models price traffic with."""
        return GpuGeometry(n_cores=n_shards, cluster_size=n_shards,
                           l1_sets=self.n_sets, l1_ways=self.n_ways,
                           flits_per_line=self.flits_per_block,
                           noc_bw=self.noc_bw)


class ServeResult(NamedTuple):
    """Aggregate + per-sub-round outputs of one engine replay."""
    policy: str
    n_requests: int
    local_hits: int
    remote_hits: int
    recomputed_blocks: int
    probe_messages: int
    remote_fetch_blocks: int
    directory_sync_entries: int
    shard_load: np.ndarray          # (C,) reuse serves per shard
    latency: np.ndarray             # (T, C) f32 modeled request latency
    served: np.ndarray              # (T, C) bool request present
    tenants: Tuple[str, ...]
    tenant_requests: np.ndarray     # (n_tenants,)
    tenant_hit_blocks: np.ndarray
    tenant_blocks: np.ndarray
    tenant_latency_sum: np.ndarray  # (n_tenants,) f64
    cycles: float                   # sum of per-round critical paths
    slots: int                      # admissions per shard per round (B)
    noc_injected: float
    noc_delivered: float
    noc_queued: float
    #: value-resolved modeled-latency bincount (telemetry runs only)
    lat_hist: Optional[np.ndarray] = None
    #: histogram quantiles reproduce np.percentile exactly (integral
    #: cost model + ideal NoC)
    hist_exact: bool = False

    @property
    def hit_rate(self) -> float:
        tot = self.local_hits + self.remote_hits + self.recomputed_blocks
        return (self.local_hits + self.remote_hits) / max(tot, 1)

    @property
    def request_latencies(self) -> np.ndarray:
        return self.latency[self.served]

    def latency_percentile(self, q: float) -> float:
        if self.lat_hist is not None and self.hist_exact:
            # exact quantile read from the histogram — bit-identical
            # to np.percentile over the materialized latency array
            return hist_quantile(self.lat_hist, q) \
                if self.lat_hist.sum() else 0.0
        lat = self.request_latencies
        return float(np.percentile(lat, q)) if lat.size else 0.0

    @property
    def p50_latency(self) -> float:
        return self.latency_percentile(50.0)

    @property
    def p99_latency(self) -> float:
        return self.latency_percentile(99.0)

    @property
    def requests_per_kcycle(self) -> float:
        """Modeled throughput (requests per 1000 modeled cycles): one
        round of critical-path latency is charged per ``B`` admissions."""
        return 1e3 * self.n_requests / max(self.cycles, 1e-9)

    @property
    def load_imbalance(self) -> float:
        m = self.shard_load.mean()
        return float(self.shard_load.max() / m) if m else 0.0


def _probe_all(tags, h, set_idx, *, backend):
    """(C, K, C_dir) hits of every request block vs every directory.

    ``tags`` is the (C_dir, S, W) tag lane of the directory, a strided
    view of the packed ``dir`` (way stride 2). Validity is
    implied by the directory contract: sealed tags are >= 1 and empty
    ways are 0, while invalid block lanes carry hash 0 — so
    ``tag == hash != 0`` is the whole hit predicate.
    """
    C, K = h.shape
    if backend == "torch":
        g_t = tags[:, set_idx.long(), :]            # (C_dir, C, K, W)
        hits = ((g_t == h[None, :, :, None]) & (g_t != 0)).any(dim=-1)
        return hits.permute(1, 2, 0)                # (C, K, C_dir)
    R = C * K
    # the kernel reads the strided directory lane in place
    hits, _ = ata_tag_probe(set_idx.reshape(R), h.reshape(R), tags,
                            tags != 0)
    return hits.reshape(C, K, C)


def _max_latency(cfg: ServingConfig, K: int) -> float:
    """Per-request modeled-latency bound under an ideal NoC."""
    return K * max(cfg.lat_hit, cfg.lat_fetch, cfg.lat_recompute) \
        + cfg.lat_probe_rtt


def _integral_cost_model(cfg: ServingConfig) -> bool:
    """True when every latency term is a whole number of cycles and
    the NoC adds none — the regime where the value-resolved histogram
    reconstructs ``np.percentile`` exactly."""
    return cfg.noc == "ideal" and all(
        float(v).is_integer() for v in (cfg.lat_hit, cfg.lat_fetch,
                                        cfg.lat_recompute,
                                        cfg.lat_probe_rtt))


def _check_headroom(policy: str, cfg: ServingConfig, T: int, C: int,
                    K: int) -> None:
    """Config-time overflow guards for the device-side narrow types.

    The directory keeps int32 lanes (the tag, and the LRU key derived
    from the clock); per-sub-round latency is float32. The final
    counter / latency / cycle accumulation runs on the host in int64 /
    float64. The limits are the reference's, so both packages accept
    the same configurations.
    """
    lim = np.iinfo(np.int32).max
    # LRU clock ticks once per sub-round; way selection packs it as
    # (last + 1) * n_ways + way
    if (T + 2) * cfg.n_ways >= lim:
        raise ValueError(
            f"{T} sub-rounds x {cfg.n_ways} ways overflows the int32 "
            f"packed LRU key; shard the replay below "
            f"{lim // cfg.n_ways - 2} rounds")
    # per-chunk probe-message sum (broadcast worst case) stays int32
    if policy == "broadcast" \
            and _CHUNK_SUBROUNDS * C * K * max(C - 1, 1) >= lim:
        raise ValueError(
            f"broadcast probe messages per {_CHUNK_SUBROUNDS}-sub-round "
            f"chunk overflow int32 at {C} shards x {K} blocks")
    # per-request latency must stay f32-exact for integer cost models
    max_lat = _max_latency(cfg, K)
    if max_lat >= 2.0 ** 24:
        raise ValueError(
            f"per-request latency bound {max_lat:.3g} exceeds the f32 "
            f"integer-exact range (2^24); scale the cost model down")


def _check_hashes(stream) -> None:
    """The stream contract the directory relies on: every block a
    request carries hashes to >= 1 (0 marks an empty way)."""
    K = stream.max_blocks
    lanes = stream.valid[..., None] \
        & (np.arange(K) < stream.n_blocks[..., None])
    if (stream.n_blocks > K).any() or (stream.hashes[lanes] < 1).any():
        raise ValueError("every valid block lane of the stream must carry "
                         "a hash >= 1 (and n_blocks <= max_blocks)")


class _Engine:
    """One replay's device state and the per-chunk program."""

    def __init__(self, policy: str, cfg: ServingConfig, B: int, C: int,
                 K: int, device, backend: str, per_round: bool = False):
        self.policy, self.cfg, self.B, self.C, self.K = policy, cfg, B, C, K
        self.backend = backend
        #: also emit the probe messages of each admission round
        self.per_round = per_round
        self.S, self.W = S, W = cfg.n_sets, cfg.n_ways
        self.CS = C * S                      # the scratch row's index
        i32 = dict(dtype=torch.int32, device=device)
        self.cidx = torch.arange(C, **i32)
        self.karange = torch.arange(K, **i32)
        self.warange = torch.arange(W, **i32)
        # zero-dim operands of torch.where: a Python scalar there costs
        # one fill launch per call on the card
        i64 = dict(dtype=torch.long, device=device)
        self.zero = torch.zeros((), **i32)
        self.scratch = torch.tensor(self.CS, **i64)
        self.thr_none = torch.zeros((), **i64)
        self.thr_own = torch.tensor(W, **i64)
        self.thr_peer = torch.tensor(torch.iinfo(torch.int32).max, **i64)
        # [tag, (last + 1) * W] lanes; never-written ways: [0, W]
        self.dir = torch.zeros((self.CS + 1, W, 2), **i32)
        self.dir[..., 1] = W
        self.geom = cfg.geometry(C)
        self.noc = get_noc(cfg.noc)
        self.noc_state = init_noc_state(self.noc.n_links(self.geom),
                                        device=device)
        n = B * C * K                        # one admission round, P = 1
        self.noc_dst = self.cidx.long().repeat_interleave(K).repeat(B)[None]
        self.noc_cluster = torch.zeros((1, n), dtype=torch.long,
                                       device=device)
        self.noc_flits = torch.full((1, n), float(cfg.flits_per_block),
                                    dtype=torch.float32, device=device)

    def chunk(self, vr, h, nb, g0: int) -> dict:
        """Replay sub-rounds ``g0 .. g0 + n - 1`` (whole admission
        rounds): vr (n, C) bool, h (n, C, K) int32, nb (n, C) int32 on
        the device. Returns the chunk's emissions, still on the device."""
        C, K, S, W, B = self.C, self.K, self.S, self.W, self.B
        n = h.shape[0]
        dev = h.device
        sets = h % S                                          # (n, C, K)
        # per-(sub-round, block, shard) stream values, (n, K, C) so that
        # a block step reads contiguous (C,) rows
        hT = h.transpose(1, 2).contiguous()
        rows = (self.cidx[:, None] * S + sets).transpose(1, 2).long()
        bvT = (self.karange[None, :, None] < nb[:, None, :]) \
            & vr[:, None, :]
        # write targets: a block that recomputes seals into its own row,
        # a lane that must not write goes to the scratch row
        tgt = torch.where(bvT, rows, self.scratch).contiguous()
        rows = rows.contiguous()
        clock = torch.arange(g0 + 1, g0 + n + 1, device=dev,
                             dtype=torch.int32)
        vals = torch.stack(
            (hT, ((clock + 1) * W)[:, None, None].expand(n, K, C)),
            dim=-1).contiguous()                              # (n, K, C, 2)

        reu = torch.empty((n, K, C), dtype=torch.bool, device=dev)
        lh = torch.empty_like(reu)
        am = (torch.empty((n, K, C), dtype=torch.long, device=dev)
              if self.policy != "private" else None)
        dflat = self.dir
        tags = dflat[:self.CS, :, 0].view(C, S, W)
        for i in range(n):
            hits = _probe_all(tags, h[i], sets[i], backend=self.backend)
            local_hit = hits.diagonal(dim1=0, dim2=2)        # (K, C)
            cand = bvT[i] & local_hit
            if self.policy == "private":
                # own-shard reuse only, revalidated live: pk < W
                thr = torch.where(cand, self.thr_own, self.thr_none)
                ins_reused = self.scratch
            else:
                hk = hits.permute(1, 0, 2)                    # (K, C, C)
                am[i] = hk.to(torch.uint8).argmax(dim=-1)     # first owner
                thr = torch.where(
                    bvT[i] & hk.any(dim=-1),
                    torch.where(local_hit, self.thr_own, self.thr_peer),
                    self.thr_none)
                # a reused block writes only under ata, and only when it
                # came from a peer (replicate locally)
                ins_reused = (torch.where(local_hit, self.scratch, tgt[i])
                              if self.policy == "ata" else self.scratch)
            lh[i] = local_hit
            reused, chain = None, []
            for k in range(K):           # static unroll over the chain
                row = dflat.index_select(0, rows[i, k])        # (C, W, 2)
                key = torch.where(row[..., 0] == hT[i, k][:, None],
                                  self.zero, row[..., 1]) + self.warange
                pk, way = key.min(dim=-1)
                # hit & valid & (peer-owned, or own and still present):
                # pk < W is "present in the live own row"
                ok = pk < thr[k]
                # the chain stays alive while every earlier block reused
                reused = ok if reused is None else reused & ok
                ins = ins_reused[k] if ins_reused.dim() else ins_reused
                dflat.index_put_((torch.where(reused, ins, tgt[i, k]), way),
                                 vals[i, k])
                chain.append(reused)
            torch.stack(chain, out=reu[i])
        return self._emit(vr, bvT, reu, lh, am)

    def _emit(self, vr, bvT, reu, lh, am) -> dict:
        """Counters, latencies, shard load and the NoC rounds of a chunk,
        derived from the walk's ``reused`` lanes. With ``per_round``,
        ``miss_rounds`` adds the locally-missing blocks of each admission
        round (``broadcast`` only: the others send no probes)."""
        C, K, B, cfg = self.C, self.K, self.B, self.cfg
        n = reu.shape[0]
        f32 = torch.float32
        if self.policy == "private":
            own = torch.ones_like(reu)
            owner = self.cidx.long().expand(n, K, C)
        else:
            own = lh
            owner = torch.where(lh, self.cidx.long(), am)
        local, remote = reu & own, reu & ~own
        recomp = bvT & ~reu
        nl = local.sum(dim=1, dtype=torch.int32)              # (n, C)
        nr = remote.sum(dim=1, dtype=torch.int32)
        nc = recomp.sum(dim=1, dtype=torch.int32)
        base = cfg.lat_hit * nl + cfg.lat_fetch * nr \
            + cfg.lat_recompute * nc                          # f32

        # one NoC round per admission round, slot-major (B, C, K) lanes
        src = owner.transpose(1, 2).contiguous().view(n // B, 1, -1)
        rem = remote.transpose(1, 2).contiguous().view(n // B, 1, -1)
        extra = torch.empty((n // B, B, C), dtype=f32, device=reu.device)
        for r in range(n // B):
            transit = self.noc.transit(self.geom, self.noc_state, NocTraffic(
                src=src[r], dst=self.noc_dst, cluster=self.noc_cluster,
                flits=self.noc_flits, mask=rem[r]))
            self.noc_state = transit.state
            extra[r] = (transit.delay + transit.occupancy).view(
                B, C, K).sum(dim=-1)
        lat = base + extra.view(n, C)
        if self.policy == "broadcast":
            # one broadcast per locally-missing block of the chain
            miss = bvT & ~lh
            lat = lat + cfg.lat_probe_rtt * miss.any(dim=1).to(f32)
            miss_blocks = miss.sum()
        else:
            miss_blocks = torch.zeros((), dtype=torch.long,
                                      device=reu.device)
        lat = torch.where(vr, lat, 0.0)
        # per-chunk shard-load reduction: one count over reused blocks
        shard_load = torch.bincount(torch.where(reu, owner, C).view(-1),
                                    minlength=C + 1)[:C]
        out = dict(lat=lat, nl=nl, nr=nr, nc=nc, miss_blocks=miss_blocks,
                   shard_load=shard_load)
        if self.per_round and self.policy == "broadcast":
            out["miss_rounds"] = miss.reshape(n // B, -1).sum(dim=1)
        return out


def serve_stream(policy: str, stream, cfg: ServingConfig = ServingConfig(),
                 *, telemetry: Optional[TelemetryConfig] = None,
                 device=None):
    """Replay ``stream`` under ``policy``; returns a :class:`ServeResult`.

    ``stream`` is a :class:`~repro_torch.core.trace.serving.RequestStream`
    (build one with :class:`~repro_torch.core.trace.serving.ServingMix`);
    ``stream.slots`` selects batched admission — counters are slot-order
    exact for every ``B``. Runs on ``device=None`` = ``"cuda"`` and
    raises where there is no card, unless the caller passes
    ``device="cpu"``.

    ``telemetry`` (a :class:`~repro_torch.core.telemetry.TelemetryConfig`)
    turns on windowed observability: the return becomes a
    ``(ServeResult, repro_torch.obs.ServeTimeline)`` pair, the result
    gains its latency histogram (``lat_hist``; the percentile properties
    read it exactly under the default integral cost model), and every
    counter stays bit-equal to the ``telemetry=None`` replay.
    """
    if policy not in SERVING_POLICIES:
        raise ValueError(f"policy must be one of {SERVING_POLICIES}, "
                         f"got {policy!r}")
    device = resolve_device(device)
    backend = resolve_probe_backend(cfg.probe_backend, device)
    T, C, K = stream.hashes.shape
    B = stream.slots
    _check_headroom(policy, cfg, T, C, K)
    _check_hashes(stream)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    valid, hashes, blocks = (dev(stream.valid), dev(stream.hashes),
                             dev(stream.n_blocks))
    eng = _Engine(policy, cfg, B, C, K, device, backend,
                  per_round=telemetry is not None)
    step = (_CHUNK_SUBROUNDS // B) * B
    lat_parts, nl_parts, nr_parts, nc_parts, miss_parts = [], [], [], [], []
    miss_blocks = 0
    shard_load = np.zeros(C, np.int64)
    for g0 in range(0, T, step):
        sl = slice(g0, min(g0 + step, T))
        outs = eng.chunk(valid[sl], hashes[sl], blocks[sl], g0)
        lat_parts.append(outs["lat"].cpu().numpy())
        nl_parts.append(outs["nl"].cpu().numpy())
        nr_parts.append(outs["nr"].cpu().numpy())
        nc_parts.append(outs["nc"].cpu().numpy())
        miss_blocks += int(outs["miss_blocks"])
        if "miss_rounds" in outs:
            miss_parts.append(outs["miss_rounds"].cpu().numpy())
        shard_load += outs["shard_load"].cpu().numpy().astype(np.int64)

    # host-side wide reduction of the emitted per-sub-round grids
    # (int64 / float64 — the overflow-headroom accumulators)
    lat = np.concatenate(lat_parts)                     # (T, C) float32
    nl, nr, nc = (np.concatenate(p) for p in (nl_parts, nr_parts, nc_parts))
    local_hits = int(nl.sum(dtype=np.int64))
    remote_hits = int(nr.sum(dtype=np.int64))
    recomputed = int(nc.sum(dtype=np.int64))
    served = np.asarray(stream.valid)
    cycles = float(np.sum(
        lat.reshape(-1, B * C).max(axis=1), dtype=np.float64))

    nt = stream.n_tenants
    tidx = np.asarray(stream.tenant)[served]

    def per_tenant(w, dtype=np.int64):
        out = np.zeros(nt, dtype)
        np.add.at(out, tidx, w[served].astype(dtype))
        return out

    ones = np.ones_like(served, np.int64)
    nstate = {k: v[0].item() if v.dim() == 1 else v[0].cpu().numpy()
              for k, v in eng.noc_state.items()}
    with_hist = telemetry is not None and telemetry.histograms
    lat_hist = None
    if with_hist:
        # the reference's device bincount, on the host from the grid
        nb = serving_hist_bins(_max_latency(cfg, K))
        lat_hist = np.bincount(
            np.clip(lat, 0, nb - 1).astype(np.int32)[served],
            minlength=nb).astype(np.int64)
    result = ServeResult(
        policy=policy,
        n_requests=stream.n_requests,
        local_hits=local_hits,
        remote_hits=remote_hits,
        recomputed_blocks=recomputed,
        probe_messages=miss_blocks * (C - 1),
        # every remote hit is exactly one remote block fetch
        remote_fetch_blocks=remote_hits,
        # ata: every sealed block rides the periodic delta all-gather
        directory_sync_entries=recomputed if policy == "ata" else 0,
        shard_load=shard_load,
        latency=lat,
        served=served,
        tenants=stream.tenants,
        tenant_requests=per_tenant(ones),
        tenant_hit_blocks=per_tenant(nl + nr),
        tenant_blocks=per_tenant(nl + nr + nc),
        tenant_latency_sum=per_tenant(lat, np.float64),
        cycles=cycles,
        slots=B,
        noc_injected=float(nstate["injected"]),
        noc_delivered=float(nstate["delivered"]),
        noc_queued=float(nstate["queue"].sum()),
        lat_hist=lat_hist,
        hist_exact=with_hist and _integral_cost_model(cfg),
    )
    if telemetry is None:
        return result
    from repro_torch.obs.timeline import ServeTimeline  # obs sits above
    pm_rounds = (np.concatenate(miss_parts).astype(np.int64) * (C - 1)
                 if miss_parts else np.zeros(T // B, np.int64))
    timeline = ServeTimeline.from_grids(
        window=telemetry.window, slots=B, served=served,
        nl=nl, nr=nr, nc=nc, lat=lat, pm_rounds=pm_rounds,
        cycles_rounds=np.max(lat.reshape(-1, B * C), axis=1),
        tenant=np.asarray(stream.tenant), n_tenants=nt,
        hist=lat_hist, hist_exact=result.hist_exact,
        meta={"policy": policy, "slots": B, "shards": C,
              "noc": cfg.noc, "tenants": "+".join(stream.tenants)})
    return result, timeline
