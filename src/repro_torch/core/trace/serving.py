"""Serving request streams: multi-tenant shared-prefix traffic.

Pure numpy: a copy of the reference's ``core/trace/serving.py``, held
array-equal to it for every tenant and mix, so both packages replay the
same streams from the same seed.

The serving engine (``repro_torch.serving.engine``) replays the paper's
inter-core-locality regime at LM-serving scale: requests arrive at
shards, their prompt prefixes hash to block chains, and shared system
prompts make the same chains recur across shards — the serving analog
of the inter-core data locality the aggregated tag array exploits.
This module generates that traffic as arrays, mirroring the
the reference's ``WorkloadMix`` conventions:

* a calibrated :class:`TenantParams` table (:data:`TENANTS`) with
  per-tenant shared-prefix populations and arrival shaping (base rate,
  diurnal sinusoid, bursts);
* :class:`ServingMix` composes tenants by *superposition*: every mix
  slot generates its own full-grid arrival pattern and request content
  from an independent substream, and slots contending for the same
  (round, shard) admission slot are resolved by a rotating priority —
  so composition never changes what a tenant *would* send, only which
  offered requests win admission;
* **hash-space slicing** — slot ``s``'s block hashes live in
  ``[s * TENANT_STRIDE, (s+1) * TENANT_STRIDE)`` so tenants never
  falsely share blocks; slot 0 is offset-free, so a one-tenant mix
  composes to exactly the solo stream.

Uniqueness by construction: each slot's non-shared block hashes are
allocated from a per-slot counter (dense, collision-free) above a
small region reserved for the shared-prefix pools — random draws at
~1e7 blocks in an int31 space would collide often enough (birthday
bound) to fake measurable sharing.

The grid admits at most one request per shard per *sub-round* —
arrival ``rate`` is the per-shard admission probability, and
everything stays int32 (JAX default; the engine's tag arrays are
int32).

**Batched admission**: a stream may carry
``slots = B > 1``, meaning each admission *round* spans ``B``
consecutive rows of the grid — ``B`` priority-ordered admission slots
per shard per round. The array layout is deliberately slot-major
sequential (row ``t*B + b`` is slot ``b`` of round ``t``), so the
engine's slot-order semantics — later slots see earlier slots'
replication inserts — coincide with plain row-order replay and the
oracle needs no change at all: iterating rows *is* slot-sequential
replay. ``slots`` therefore never changes any hit/probe/fetch counter;
it changes the *throughput model* (the engine charges one round of
``max`` latency per ``B`` admissions) and the admission capacity of
:meth:`ServingMix.make_stream` (up to ``B`` contending tenants win
per shard per round instead of one).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np

#: Hash-space slice per mix slot. 2^26 leaves room for 31 slots below
#: int32; a power of two, so every power-of-two directory set count is
#: offset-invariant (slot offsets never change a block's set index
#: distribution).
TENANT_STRIDE = 1 << 26

#: Low region of each slot's slice reserved for shared-prefix pools;
#: the unique-block counter allocates above it.
PREFIX_SPACE = 1 << 16

_MAX_SLOTS = 16


@dataclasses.dataclass(frozen=True)
class TenantParams:
    """One tenant's traffic shape (the serving AppParams analog).

    ``n_prefixes`` shared system prompts of ``prefix_blocks`` blocks;
    ``shared_frac`` of requests start from one of them, the rest carry
    a fresh prefix. Every request appends ``unique_blocks`` fresh
    suffix blocks. ``rate`` is the base per-shard arrival probability
    per round, shaped by an optional diurnal sinusoid and bursts.
    """
    name: str
    n_prefixes: int = 12
    prefix_blocks: int = 8
    unique_blocks: int = 4
    shared_frac: float = 0.7
    rate: float = 0.9
    diurnal_amp: float = 0.0     # +/- fraction of rate over a period
    diurnal_period: int = 2048   # rounds per diurnal cycle
    burst_prob: float = 0.0      # per-round probability a burst starts
    burst_len: int = 64          # rounds a burst lasts
    burst_mult: float = 2.0      # rate multiplier inside a burst

    @property
    def n_blocks(self) -> int:
        return self.prefix_blocks + self.unique_blocks


#: Calibrated tenant table (the serving APPS analog): a high-sharing
#: steady chat tenant, a diurnal retrieval tenant with a wide prefix
#: population, and a low-sharing bursty batch tenant.
TENANTS = {
    "chat": TenantParams("chat", n_prefixes=8, prefix_blocks=8,
                         unique_blocks=4, shared_frac=0.85, rate=0.9),
    "rag": TenantParams("rag", n_prefixes=48, prefix_blocks=12,
                        unique_blocks=6, shared_frac=0.6, rate=0.7,
                        diurnal_amp=0.35, diurnal_period=4096),
    "batch": TenantParams("batch", n_prefixes=4, prefix_blocks=4,
                          unique_blocks=10, shared_frac=0.15, rate=0.35,
                          burst_prob=0.01, burst_len=96,
                          burst_mult=2.5),
}


def _resolve_tenant(t: Union[str, TenantParams]) -> TenantParams:
    if isinstance(t, TenantParams):
        return t
    try:
        return TENANTS[t]
    except KeyError:
        raise ValueError(
            f"unknown tenant {t!r}; known: {sorted(TENANTS)}") from None


@dataclasses.dataclass(frozen=True)
class RequestStream:
    """A (rounds, shards) request grid, the serving engine's input.

    ``valid[t, c]`` marks a request arriving at shard ``c`` in
    sub-round ``t``; its block-hash chain is
    ``hashes[t, c, :n_blocks[t, c]]`` (positive int32; lanes past
    ``n_blocks`` are 0, which never matches a directory tag) and
    ``tenant[t, c]`` its mix-slot id.

    ``slots`` (``B``) groups every ``B`` consecutive rows into one
    *admission round* of ``B`` priority-ordered slots per shard (see
    the module docstring); row order is slot order, so the arrays are
    layout-identical to their ``B=1`` slot-sequentialized replay.
    """
    valid: np.ndarray     # (T, C) bool
    hashes: np.ndarray    # (T, C, K) int32, >= 1 on valid block lanes
    n_blocks: np.ndarray  # (T, C) int32
    tenant: np.ndarray    # (T, C) int32 mix-slot id (0 where invalid)
    tenants: Tuple[str, ...] = ("tenant",)
    slots: int = 1        # admission slots per shard per round (B)

    def __post_init__(self):
        T, C, _ = self.hashes.shape
        assert self.valid.shape == (T, C), (self.valid.shape, (T, C))
        assert self.n_blocks.shape == (T, C)
        assert self.tenant.shape == (T, C)
        assert self.hashes.dtype == np.int32, self.hashes.dtype
        if not 1 <= self.slots <= _MAX_SLOTS:
            raise ValueError(
                f"slots {self.slots} outside [1, {_MAX_SLOTS}]")
        if T % self.slots:
            raise ValueError(
                f"{T} grid rows not divisible by slots={self.slots}")

    @property
    def rounds(self) -> int:
        """Grid rows (= sub-rounds; ``admission_rounds * slots``)."""
        return self.hashes.shape[0]

    @property
    def admission_rounds(self) -> int:
        """Engine scan steps: each admits up to ``slots`` per shard."""
        return self.hashes.shape[0] // self.slots

    @property
    def n_shards(self) -> int:
        return self.hashes.shape[1]

    @property
    def max_blocks(self) -> int:
        return self.hashes.shape[2]

    @property
    def n_requests(self) -> int:
        return int(self.valid.sum())

    @property
    def n_tenants(self) -> int:
        return len(self.tenants)

    def sequential(self) -> "RequestStream":
        """The same requests, one valid request per round.

        Round ``t*C + c`` carries only the original round-``t`` request
        of shard ``c``. With a single request in flight per round, the
        engine's round semantics degenerate to the sequential oracle's
        one-request-at-a-time semantics — the bit-exactness tests use
        this to compare against ``lookup_prefix``-style walks.
        """
        T, C, K = self.hashes.shape
        r = np.arange(C)
        valid = np.zeros((T, C, C), bool)
        hashes = np.zeros((T, C, C, K), np.int32)
        n_blocks = np.zeros((T, C, C), np.int32)
        tenant = np.zeros((T, C, C), np.int32)
        valid[:, r, r] = self.valid
        hashes[:, r, r, :] = self.hashes
        n_blocks[:, r, r] = self.n_blocks
        tenant[:, r, r] = self.tenant
        return RequestStream(valid=valid.reshape(T * C, C),
                             hashes=hashes.reshape(T * C, C, K),
                             n_blocks=n_blocks.reshape(T * C, C),
                             tenant=tenant.reshape(T * C, C),
                             tenants=self.tenants)

    def batched(self, slots: int) -> "RequestStream":
        """The same request population at ``slots`` admissions/round.

        Pure relabeling: the arrays are shared (slot-major layout means
        no data moves), only the round grouping changes. Requires the
        row count to divide evenly. Because the engine replays slots in
        sequential sub-rounds, every hit/probe/fetch counter is
        bit-identical across ``slots`` values — only the throughput
        model (rounds charged) changes. ``batched(1)`` is
        :meth:`slot_sequential`.
        """
        return dataclasses.replace(self, slots=slots)

    def slot_sequential(self) -> "RequestStream":
        """The ``B=1`` replay of this stream: one slot per round.

        Row order *is* slot order, so this is ``batched(1)`` — the
        canonical reference the batched-exactness property tests
        compare against.
        """
        return dataclasses.replace(self, slots=1)


def _arrival_rate(p: TenantParams, rounds: int,
                  rng: np.random.Generator) -> np.ndarray:
    """(T,) per-shard arrival probability after diurnal + burst shaping."""
    t = np.arange(rounds)
    rate = np.full(rounds, p.rate)
    if p.diurnal_amp:
        rate = rate * (1.0 + p.diurnal_amp
                       * np.sin(2.0 * np.pi * t / p.diurnal_period))
    if p.burst_prob:
        starts = rng.random(rounds) < p.burst_prob
        in_burst = np.convolve(starts, np.ones(p.burst_len))[:rounds] > 0
        rate = np.where(in_burst, rate * p.burst_mult, rate)
    return np.clip(rate, 0.0, 1.0)


def tenant_stream(tenant: Union[str, TenantParams], *, n_shards: int,
                  rounds: int, seed: int = 0,
                  slot: int = 0) -> RequestStream:
    """One tenant's solo stream (mix slot ``slot``; 0 = offset-free).

    The substream seed is keyed by ``(seed, slot)`` and the hash slice
    by ``slot`` alone, so a tenant's offered traffic is identical
    whether generated solo or as a component of any mix.
    """
    p = _resolve_tenant(tenant)
    if not 0 <= slot < _MAX_SLOTS:
        raise ValueError(f"slot {slot} outside [0, {_MAX_SLOTS})")
    rng = np.random.default_rng([int(seed), slot])
    T, C, K = rounds, n_shards, p.n_blocks
    base = slot * TENANT_STRIDE

    rate = _arrival_rate(p, T, rng)
    valid = rng.random((T, C)) < rate[:, None]

    # shared-prefix pools: distinct hashes in [1, PREFIX_SPACE)
    pool = (rng.choice(PREFIX_SPACE - 1,
                       size=p.n_prefixes * p.prefix_blocks,
                       replace=False).astype(np.int64) + 1
            ).reshape(p.n_prefixes, p.prefix_blocks)
    shared = rng.random((T, C)) < p.shared_frac
    pid = rng.integers(0, p.n_prefixes, size=(T, C))

    # fresh (never-shared) blocks come from a dense per-slot counter:
    # collision-free by construction, row-major over the request grid
    fresh_need = np.where(shared, p.unique_blocks, K) * valid
    flat = fresh_need.ravel()
    start = (np.cumsum(flat) - flat).reshape(T, C)
    total = int(flat.sum())
    if PREFIX_SPACE + total >= TENANT_STRIDE:
        raise ValueError(
            f"tenant {p.name!r} needs {total} fresh blocks over "
            f"{T} rounds x {C} shards — exceeds its hash slice "
            f"({TENANT_STRIDE - PREFIX_SPACE}); use fewer rounds")

    k = np.arange(K)
    fresh_idx = np.where(shared[..., None], k - p.prefix_blocks, k)
    hashes = PREFIX_SPACE + start[..., None].astype(np.int64) + fresh_idx
    hashes[:, :, :p.prefix_blocks] = np.where(
        shared[..., None], pool[pid], hashes[:, :, :p.prefix_blocks])
    hashes = (hashes + base) * valid[..., None]
    assert hashes.max(initial=0) < np.iinfo(np.int32).max

    return RequestStream(
        valid=valid,
        hashes=hashes.astype(np.int32),
        n_blocks=np.where(valid, K, 0).astype(np.int32),
        tenant=np.where(valid, slot, 0).astype(np.int32),
        tenants=(p.name,))


@dataclasses.dataclass(frozen=True)
class ServingMix:
    """A multi-tenant serving traffic spec (the WorkloadMix analog).

    ``tenants`` lists the co-served tenants (names from
    :data:`TENANTS` or explicit :class:`TenantParams`); each occurrence
    is an independent slot with its own rng substream and hash slice.
    """
    tenants: Tuple[Union[str, TenantParams], ...]
    name: Optional[str] = None

    def __post_init__(self):
        if not self.tenants:
            raise ValueError("ServingMix needs at least one tenant")
        if len(self.tenants) > _MAX_SLOTS:
            raise ValueError(
                f"at most {_MAX_SLOTS} tenants per mix, got "
                f"{len(self.tenants)}")
        for t in self.tenants:
            _resolve_tenant(t)

    @property
    def n_tenants(self) -> int:
        return len(self.tenants)

    @property
    def mix_id(self) -> str:
        if self.name:
            return self.name
        return "+".join(_resolve_tenant(t).name for t in self.tenants)

    def component_streams(self, *, n_shards: int, rounds: int,
                          seed: int = 0) -> List[RequestStream]:
        """Per-slot solo streams, already hash-sliced by slot."""
        return [tenant_stream(t, n_shards=n_shards, rounds=rounds,
                              seed=seed, slot=s)
                for s, t in enumerate(self.tenants)]

    def make_stream(self, *, n_shards: int, rounds: int,
                    seed: int = 0, slots: int = 1) -> RequestStream:
        """Superimpose the component streams onto one request grid.

        Mix slots contending for the same (round, shard) admission are
        resolved by a rotating priority (mix slot ``s`` wins round
        ``t`` when it minimizes ``(s + t) % n_slots`` among the
        contenders), so no tenant is structurally starved. A one-tenant
        mix at ``slots=1`` is the solo stream, arrays bit-identical.

        ``slots = B > 1`` widens admission: the *first ``B``* priority-
        ordered contenders win (stable sort, so ``B=1`` picks exactly
        the old ``argmin`` winner), landing in slot order on ``B``
        consecutive grid rows per round (the batched layout of
        :class:`RequestStream`). Offered traffic is untouched —
        batching only admits requests that a ``B=1`` grid would have
        dropped.
        """
        if not 1 <= slots <= _MAX_SLOTS:
            raise ValueError(f"slots {slots} outside [1, {_MAX_SLOTS}]")
        comps = self.component_streams(n_shards=n_shards, rounds=rounds,
                                       seed=seed)
        names = tuple(_resolve_tenant(t).name for t in self.tenants)
        if len(comps) == 1 and slots == 1:
            return dataclasses.replace(comps[0], tenants=names)
        n = len(comps)
        B = slots
        K = max(c.max_blocks for c in comps)
        valid = np.stack([c.valid for c in comps])          # (n, T, C)
        hashes = np.zeros((n, rounds, n_shards, K), np.int32)
        for s, c in enumerate(comps):
            hashes[s, :, :, :c.max_blocks] = c.hashes
        n_blocks = np.stack([c.n_blocks for c in comps])
        tenant_id = np.arange(n)
        prio = (tenant_id[:, None] + np.arange(rounds)[None, :]) % n
        key = np.where(valid, prio[:, :, None], n)          # (n, T, C)
        # stable sort => slot b takes the b-th best contender, and the
        # b=0 row reproduces argmin's first-occurrence winner exactly;
        # slots beyond the contender count stay empty
        nb_take = min(B, n)
        order = np.argsort(key, axis=0, kind="stable")[:nb_take]
        bvalid = np.take_along_axis(key, order, axis=0) < n
        bh = np.take_along_axis(hashes, order[..., None], axis=0)
        bn = np.take_along_axis(n_blocks, order, axis=0) * bvalid
        bt = (order * bvalid).astype(np.int32)
        if nb_take < B:
            z = (B - nb_take, rounds, n_shards)
            bvalid = np.concatenate([bvalid, np.zeros(z, bool)])
            bh = np.concatenate([bh, np.zeros(z + (K,), np.int32)])
            bn = np.concatenate([bn, np.zeros(z, np.int32)])
            bt = np.concatenate([bt, np.zeros(z, np.int32)])

        def rows(a):  # (B, T, C, ...) -> (T*B, C, ...) slot-major rows
            return np.swapaxes(a, 0, 1).reshape(
                (rounds * B,) + a.shape[2:])

        return RequestStream(
            valid=rows(bvalid),
            hashes=rows(bh * bvalid[..., None]),
            n_blocks=rows(bn),
            tenant=rows(bt),
            tenants=names,
            slots=B)
