"""Reference (numpy) ATA-style distributed KV-prefix cache.

A copy of the reference package's ``serving/ref.py`` (pure numpy), kept
here because the port imports nothing of the reference. It is the
**oracle** for the port's engine (``repro_torch.serving.engine``): the
engine's hit/probe/fetch accounting must match this implementation
bit-exactly on small workloads, on the CPU in the parity tests and on
the card in ``chip_smoke.py``, where no JAX exists.

The paper's mechanism mapped onto serving:

  GPU cores            -> serving shards (data-parallel model replicas)
  L1 data arrays       -> per-shard HBM KV-block pools
  inter-core locality  -> shared prompt prefixes across shards
  aggregated tag array -> a *replicated* block directory: every shard
                          holds the (tags, owner, slot) arrays of ALL
                          shards and probes them locally in parallel
                          (the `ata_tag_probe` kernel) — zero probe
                          messages, the paper's central trick
  request distributor  -> route each block: local pool / remote fetch
                          (only on a *known* hit) / recompute ("L2")
  local-write rule     -> new blocks are sealed into the *local* pool
                          only; directory deltas ride a tiny periodic
                          all-gather (tag-fill analog)

Baselines for the paper's Table-I landscape, same API:
  private   — per-shard pools, no remote reuse (replicated compute)
  remote    — probe broadcast to all shards on miss (probe messages +
              critical-path latency counted)
  decoupled — blocks hash-home to exactly one shard (hot-shard load
              concentration counted; no replication)
  ata       — the paper's design

Two request paths share the walk/insert machinery:

* :meth:`AtaPrefixCache.lookup_prefix` — the legacy one-request-at-a-
  time path (token arrays in, payloads out), unchanged semantics;
* :func:`run_stream` — the **round-based** reference over a
  :class:`~repro_torch.core.trace.serving.RequestStream` grid: each round,
  all arriving requests probe the round-start directory, then apply
  their walks. The local-write rule makes per-shard updates disjoint,
  so apply order cannot matter — which is exactly what lets the
  vectorized engine replay rounds in parallel. Remote payload presence
  is vouched for by the round-start probe (the fetch snapshots remote
  data at probe resolution); only *local* presence is revalidated
  live, because a shard's own replication inserts can evict a block
  its own walk planned to reuse.

The pools/directory are modeled at block granularity with opaque
payload ids.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

POLICIES = ("private", "remote", "decoupled", "ata")


def _home(h: int, n_shards: int) -> int:
    """Home-shard hash for decoupled policy (mixed so it does not alias
    the directory's set index, which also uses modular placement)."""
    return int((int(h) * 2654435761 >> 17) % n_shards)


@dataclasses.dataclass(frozen=True)
class AtaCacheConfig:
    n_shards: int = 8
    n_sets: int = 64          # directory sets per shard tag array
    n_ways: int = 8
    pool_slots: int = 512     # KV block slots per shard pool
    block_tokens: int = 16    # tokens per sealed block


def hash_blocks(tokens: np.ndarray, block: int) -> np.ndarray:
    """Prefix-cumulative block hashes (same prefix -> same hash chain)."""
    n = len(tokens) // block
    hashes = np.zeros(n, np.int64)
    h = np.int64(1469598103934665603)
    for i in range(n):
        for t in tokens[i * block:(i + 1) * block]:
            h = np.int64((int(h) ^ int(t)) * 1099511628211 % (1 << 63))
        hashes[i] = h
    return hashes


@dataclasses.dataclass
class Stats:
    local_hits: int = 0
    remote_hits: int = 0
    recomputed_blocks: int = 0
    probe_messages: int = 0
    remote_fetch_blocks: int = 0
    directory_sync_entries: int = 0
    shard_load: Optional[np.ndarray] = None

    @property
    def hit_rate(self) -> float:
        tot = self.local_hits + self.remote_hits + self.recomputed_blocks
        return (self.local_hits + self.remote_hits) / max(tot, 1)

    hot_block_load: int = 0

    @property
    def load_imbalance(self) -> float:
        if self.shard_load is None or self.shard_load.mean() == 0:
            return 0.0
        return float(self.shard_load.max() / self.shard_load.mean())


class AtaPrefixCache:
    """Directory + pools for one cluster of serving shards."""

    def __init__(self, cfg: AtaCacheConfig, policy: str = "ata"):
        assert policy in POLICIES
        self.cfg = cfg
        self.policy = policy
        C, S, W = cfg.n_shards, cfg.n_sets, cfg.n_ways
        self.tags = np.zeros((C, S, W), np.int64)
        self.valid = np.zeros((C, S, W), bool)
        self.slot = np.zeros((C, S, W), np.int32)
        self.last = np.zeros((C, S, W), np.int64)
        self.pool_used = np.zeros(C, np.int32)
        self.pool_payload: List[Dict[int, object]] = [
            {} for _ in range(C)]
        self.clock = 0
        self.block_load: Dict[int, int] = {}
        self.stats = Stats(shard_load=np.zeros(C, np.int64))
        # private/remote policies: each shard only *sees* its own tags
        # (remote probes peers on miss); decoupled/ata see per policy.

    # -- directory primitives ------------------------------------------------
    def _set_idx(self, h: np.ndarray) -> np.ndarray:
        return (h % self.cfg.n_sets).astype(np.int64)

    def probe(self, shard: int, hashes: np.ndarray,
              scope: str) -> Tuple[np.ndarray, np.ndarray]:
        """(hit, owner) for each hash. scope: 'local'|'all'|'home'."""
        C = self.cfg.n_shards
        sets = self._set_idx(hashes)
        hit = np.zeros(len(hashes), bool)
        owner = np.full(len(hashes), -1, np.int32)
        shards = {"local": [shard], "all": list(range(C)),
                  "home": [_home(h, C) for h in hashes]}[scope]
        for i, h in enumerate(hashes):
            cand = (shards if scope != "home" else [shards[i]])
            for c in cand:
                m = self.valid[c, sets[i]] & (self.tags[c, sets[i]] == h)
                if m.any():
                    hit[i] = True
                    if owner[i] < 0 or c == shard:
                        owner[i] = c   # paper: prefer the local cache
        return hit, owner

    def insert(self, shard: int, h: int, payload: object):
        s = int(self._set_idx(np.array([h]))[0])
        present = np.where(self.valid[shard, s]
                           & (self.tags[shard, s] == h))[0]
        if len(present):                       # already cached: touch LRU
            self.last[shard, s, int(present[0])] = self.clock
            self.pool_payload[shard][h] = payload
            return
        free = np.where(~self.valid[shard, s])[0]
        w = int(free[0]) if len(free) else int(
            np.argmin(self.last[shard, s]))
        evicted = self.tags[shard, s, w]
        if self.valid[shard, s, w]:
            self.pool_payload[shard].pop(int(evicted), None)
        self.tags[shard, s, w] = h
        self.valid[shard, s, w] = True
        self.last[shard, s, w] = self.clock
        self.pool_payload[shard][h] = payload
        self.pool_used[shard] += 1

    # -- request path ---------------------------------------------------------
    def probe_blocks(self, shard: int, hashes: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-policy probe for one request's block chain -> (hit, owner).

        The ``remote`` policy's probe-message accounting happens here
        (at probe time, one broadcast per locally-missing block),
        exactly as in the pre-split ``lookup_prefix``.
        """
        if self.policy == "private":
            return self.probe(shard, hashes, "local")
        if self.policy == "decoupled":
            return self.probe(shard, hashes, "home")
        if self.policy == "remote":
            lhit, _ = self.probe(shard, hashes, "local")
            self.stats.probe_messages += int((~lhit).sum()) \
                * (self.cfg.n_shards - 1)
            return self.probe(shard, hashes, "all")
        # ata: replicated directory, local parallel compare
        return self.probe(shard, hashes, "all")

    def apply_blocks(self, shard: int, hashes: np.ndarray,
                     hit: np.ndarray, owner: np.ndarray
                     ) -> Tuple[int, List[object]]:
        """Walk one request's chain against a prior probe result.

        Reuses leading hits (prefix semantics: the first failure stops
        reuse), then recomputes + seals the rest per the policy's
        write rule. Remote presence is vouched for by the probe (the
        fetch snapshots the remote pool at probe resolution; remote
        shards only ever mutate their *own* arrays, so within a
        sequential lookup this is identical to the historical live
        check). Local presence is revalidated live — this shard's own
        replication inserts may have evicted a block the probe saw.
        """
        st = self.stats
        payloads: List[object] = []
        reused = 0
        for i, h in enumerate(hashes):
            if not hit[i]:
                break
            src = int(owner[i])
            payload = self.pool_payload[src].get(int(h))
            if src == shard and payload is None:
                break
            if payload is None:                 # remote: probe vouches
                payload = ("blk", int(h))
            payloads.append(payload)
            reused += 1
            st.shard_load[src] += 1
            self.block_load[int(h)] = self.block_load.get(int(h), 0) + 1
            if src == shard:
                st.local_hits += 1
            else:
                st.remote_hits += 1
                st.remote_fetch_blocks += 1
                if self.policy == "ata":
                    # paper Fig 7(a): remote fetch also fills the local
                    # cache -> hot blocks replicate and load spreads
                    self.insert(shard, int(h), payload)

        # recompute the rest; seal new blocks per policy's write rule
        for i in range(reused, len(hashes)):
            st.recomputed_blocks += 1
            home = (_home(hashes[i], self.cfg.n_shards)
                    if self.policy == "decoupled" else shard)
            if self.policy == "ata":
                st.directory_sync_entries += 1   # delta all-gather entry
            self.insert(home, int(hashes[i]), ("blk", int(hashes[i])))
        return reused, payloads

    def lookup_prefix(self, shard: int, tokens: np.ndarray
                      ) -> Tuple[int, List[object]]:
        """Longest reusable prefix for a request arriving at `shard`.

        Returns (#reused blocks, payloads). Misses past the first gap
        stop reuse (prefix semantics). Updates stats per policy.
        """
        self.clock += 1
        hashes = hash_blocks(tokens, self.cfg.block_tokens)
        hit, owner = self.probe_blocks(shard, hashes)
        return self.apply_blocks(shard, hashes, hit, owner)


def run_workload(policy: str, cfg: AtaCacheConfig, requests,
                 ) -> Stats:
    """requests: iterable of (shard, token-array)."""
    cache = AtaPrefixCache(cfg, policy)
    for shard, toks in requests:
        cache.lookup_prefix(int(shard), np.asarray(toks))
    if cache.block_load:
        cache.stats.hot_block_load = max(cache.block_load.values())
    return cache.stats


def run_stream(policy: str, cfg: AtaCacheConfig, stream) -> Stats:
    """Round-based oracle over a ``RequestStream`` grid.

    The reference semantics the vectorized engine must reproduce
    bit-exactly: each round, every arriving request probes the
    round-start directory (all probes before any apply); then every
    request applies its walk. The local-write rule makes the applies
    disjoint per shard, so their order is irrelevant. The clock ticks
    once per *round* (LRU timestamps are round-granular).

    ``policy`` accepts the engine's name ``"broadcast"`` as an alias
    for the legacy ``"remote"``; ``"decoupled"`` stays a
    ``lookup_prefix``-only policy (its int64 home hash has no int32
    engine analog).

    **Batched admission** (``stream.slots = B > 1``) needs no code
    here — and that is the point of the slot-major layout: the
    engine's batched contract is "replay the ``B`` slots of a round as
    sequential sub-rounds", and this loop's row order *is* that
    sequential replay (one clock tick per row = one per sub-round).
    The oracle therefore sequentializes slots by construction, and its
    counters are the reference for every ``B`` at once; the
    exactness tests also route through
    ``stream.slot_sequential()`` to make the comparison explicit.
    """
    stream = stream.slot_sequential()
    policy = {"broadcast": "remote"}.get(policy, policy)
    if policy not in ("private", "remote", "ata"):
        raise ValueError(f"run_stream supports private/broadcast/ata, "
                         f"got {policy!r}")
    cfg = dataclasses.replace(cfg, n_shards=stream.n_shards)
    cache = AtaPrefixCache(cfg, policy)
    T, C = stream.rounds, stream.n_shards
    for t in range(T):
        cache.clock += 1
        probes = []
        for c in range(C):
            if not stream.valid[t, c]:
                continue
            hashes = stream.hashes[t, c, :int(stream.n_blocks[t, c])] \
                .astype(np.int64)
            probes.append((c, hashes) + cache.probe_blocks(c, hashes))
        for c, hashes, hit, owner in probes:
            cache.apply_blocks(c, hashes, hit, owner)
    if cache.block_load:
        cache.stats.hot_block_load = max(cache.block_load.values())
    return cache.stats


def synth_requests(n: int, *, n_shards: int, vocab: int = 1000,
                   n_prefixes: int = 12, prefix_blocks: int = 8,
                   unique_blocks: int = 4, block: int = 16,
                   shared_frac: float = 0.7, seed: int = 0):
    """Prompt workload with shared system-prompt prefixes (inter-core
    locality analog): shared_frac of requests start from one of
    n_prefixes common prefixes."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, vocab, prefix_blocks * block)
                for _ in range(n_prefixes)]
    out = []
    for i in range(n):
        shard = rng.integers(0, n_shards)
        uniq = rng.integers(0, vocab, unique_blocks * block)
        if rng.random() < shared_frac:
            p = prefixes[rng.integers(0, n_prefixes)]
            toks = np.concatenate([p, uniq])
        else:
            toks = np.concatenate(
                [rng.integers(0, vocab, prefix_blocks * block), uniq])
        out.append((shard, toks))
    return out
