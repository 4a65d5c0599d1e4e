"""Set-associative tag arrays on torch tensors, with pluggable replacement.

State is a dict of tensors with a leading simulation-point axis P (the
``simulate_batch`` axis; ``simulate`` is P=1):

    tags : (P, n_arrays, n_sets, n_ways) int32   line address stored per way
    last : (P, n_arrays, n_sets, n_ways) int32   last-touch timestamp (LRU)
    born : (P, n_arrays, n_sets, n_ways) int32   install timestamp (FIFO)
    valid: (P, n_arrays, n_sets, n_ways) bool
    dirty: (P, n_arrays, n_sets, n_ways) bool

plus the reference's two policy-zoo *state extensions*, zero-sized
unless requested at ``init_tag_state`` time (the keys are always
present, so every TagState has one structure):

    vtags : (P, n_arrays, victim_ways) int32   victim tag buffer per array
    vvalid: (P, n_arrays, victim_ways) bool    (fully associative, FIFO)
    vborn : (P, n_arrays, victim_ways) int32   install timestamp per entry
    thrash: (P, thrash_lanes) int32            per-lane thrash counters

Zero-sized extensions are exact no-ops: ``victim_probe`` returns all
misses and ``victim_insert``/``victim_invalidate`` return the state
unchanged, so architectures that ignore the extensions are bit-exact
with and without them.

Requests are (P, R) tensors: request ``r`` of point ``p`` reads and
writes only point ``p``'s arrays.

Writes are in place, where the reference is pure: ``touch``, ``fill``,
``victim_insert`` and ``victim_invalidate`` scatter into the tensors of
the state they are given and return that same state, so a round costs
the entries its requests write, not a copy of every field. A caller
that still needs the state as it was passes a copy. Each function
gathers every value it reads from the state before its first write, and
a field must be contiguous (``.view(-1)`` raises otherwise, rather than
writing into a copy).

Scatter convention (the reference's, made explicit): masked-out
requests change nothing, and among the masked-in requests of one point
duplicate (array, set, way) targets resolve last-writer-wins — the
highest request index. Torch gives no order for duplicate scatter
targets on CUDA, so :func:`_winner` picks that request among the
point's own R requests, and every request aimed at a target then writes
the winner's value: duplicate writes agree, and the result is the same
on every device. ``last`` is a max-scatter, which needs no winner
(masked-out lanes contribute ``INT32_MIN``).
"""
from __future__ import annotations

import enum
from typing import Dict, Tuple

import torch

TagState = Dict[str, torch.Tensor]

INT32_MIN = -(2 ** 31)


class ReplacementPolicy(enum.Enum):
    """Victim-selection scheme for ``probe``/``fill``.

    LRU    — least-recently-*touched* way (timestamp ``last``)
    FIFO   — oldest-*installed* way (timestamp ``born``); touches do not
             refresh position
    RANDOM — deterministic hash of the line address over the valid ways
             (invalid ways are still preferred, as in real designs)
    """
    LRU = "lru"
    FIFO = "fifo"
    RANDOM = "random"


def init_tag_state(n_arrays: int, n_sets: int, n_ways: int, *, device,
                   batch: int = 1, victim_ways: int = 0,
                   thrash_lanes: int = 0) -> TagState:
    """Empty tag arrays with a leading point axis of ``batch``, on
    ``device`` (required: nothing defaults to the CPU); the zoo
    extensions sized by ``victim_ways`` and ``thrash_lanes``."""
    shape = (batch, n_arrays, n_sets, n_ways)
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)
    return {
        "tags": torch.zeros(shape, **i32),
        "last": torch.full(shape, -1, **i32),
        "born": torch.full(shape, -1, **i32),
        "valid": torch.zeros(shape, **b),
        "dirty": torch.zeros(shape, **b),
        "vtags": torch.zeros((batch, n_arrays, victim_ways), **i32),
        "vvalid": torch.zeros((batch, n_arrays, victim_ways), **b),
        "vborn": torch.full((batch, n_arrays, victim_ways), -1, **i32),
        "thrash": torch.zeros((batch, thrash_lanes), **i32),
    }


def _row(state: TagState, array_idx, set_idx) -> torch.Tensor:
    """Index of each request's (array, set) row in the state viewed as
    (P * n_arrays * n_sets, n_ways); broadcasts over trailing axes."""
    P, A, S, _ = state["tags"].shape
    p = torch.arange(P, device=array_idx.device).view(
        (P,) + (1,) * (array_idx.dim() - 1))
    return (p * A + array_idx.long()) * S + set_idx.long()


def _gather(state: TagState, key: str, row) -> torch.Tensor:
    x = state[key]
    return x.reshape(-1, x.shape[-1])[row]


def _select_victim(state: TagState, row, addr, valid,
                   policy: ReplacementPolicy) -> torch.Tensor:
    """Victim way per request; invalid ways always win first."""
    if policy is ReplacementPolicy.LRU:
        last = _gather(state, "last", row)
        return torch.where(valid, last, INT32_MIN).argmin(dim=-1)
    if policy is ReplacementPolicy.FIFO:
        born = _gather(state, "born", row)
        return torch.where(valid, born, INT32_MIN).argmin(dim=-1)
    if policy is ReplacementPolicy.RANDOM:
        n_ways = state["tags"].shape[-1]
        # Knuth multiplicative hash in uint32, carried in int64 under a
        # 32-bit mask (torch has no uint32 arithmetic on every device)
        h = ((addr.long() & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF
        h = (h >> 16) ^ h
        rand_way = h % n_ways
        first_invalid = valid.to(torch.uint8).argmin(dim=-1)
        return torch.where(valid.all(dim=-1), rand_way, first_invalid)
    raise ValueError(f"unknown replacement policy {policy!r}")


def probe(state: TagState, array_idx, set_idx, addr,
          policy: ReplacementPolicy = ReplacementPolicy.LRU,
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Look up one (array, set) per request.

    Returns (hit, way, dirty_hit), each (P, R); way is the first hit way
    or the victim the replacement ``policy`` selects.
    """
    row = _row(state, array_idx, set_idx)
    tags = _gather(state, "tags", row)                     # (P, R, W)
    valid = _gather(state, "valid", row)
    match = (tags == addr[..., None]) & valid
    hit = match.any(dim=-1)
    # argmax refuses bool; on uint8 it returns the first maximum
    hit_way = match.to(torch.uint8).argmax(dim=-1)
    victim = _select_victim(state, row, addr, valid, policy)
    way = torch.where(hit, hit_way, victim)
    dirty_hit = (match & _gather(state, "dirty", row)).any(dim=-1)
    return hit, way, dirty_hit


def probe_many(state: TagState, arrays, set_idx, addr
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Aggregated-tag-array probe: each request vs a *group* of arrays.

    arrays : (P, R, G) — the G tag arrays (cluster caches) per request.
    Returns (hits, ways, dirty), each (P, R, G).
    """
    row = _row(state, arrays, set_idx[..., None])
    tags = _gather(state, "tags", row)                     # (P, R, G, W)
    valid = _gather(state, "valid", row)
    match = (tags == addr[..., None, None]) & valid
    hits = match.any(dim=-1)
    ways = match.to(torch.uint8).argmax(dim=-1)
    dirty = (match & _gather(state, "dirty", row)).any(dim=-1)
    return hits, ways, dirty


def _winner(idx, mask) -> torch.Tensor:
    """Per (P, R) request: the flat (p * R + r') index of the last
    masked-in request r' of its own point aimed at the same element, or
    -1 if none.

    A target carries its point, so it collides only with targets of the
    point's own R requests. Each point's targets are sorted, and each
    request's target is named by the first position of its run in the
    sorted row; the masked-in lane numbers are max-scattered onto those
    names. Every tensor is (P, R) or P * R long, nothing the size of
    the field.
    """
    P, R = idx.shape
    base = torch.arange(0, P * R, R, device=idx.device)[:, None]
    run = base + torch.searchsorted(idx.sort(dim=-1).values, idx)
    lane = torch.arange(P * R, device=idx.device).view(P, R)
    last = torch.full((P * R,), -1, dtype=torch.long, device=idx.device)
    last.scatter_reduce_(0, run.view(-1),
                         torch.where(mask, lane, -1).view(-1), "amax")
    return last[run]


def _write(field: torch.Tensor, idx, win, value) -> None:
    """Set, in place, each element of ``field`` a masked-in request
    targets to the winning request's ``value`` (a scalar or a (P, R)
    tensor). Lanes with no winner write back the element as it was."""
    flat = field.view(-1)
    if torch.is_tensor(value) and value.dim() > 0:
        value = value.reshape(-1)[win.clamp(min=0)]
    val = torch.where(win >= 0, value, flat[idx])
    flat.scatter_(0, idx.reshape(-1), val.reshape(-1))


def _max_at(field: torch.Tensor, idx, now, mask) -> None:
    """``field.at[idx].max(now)`` over the masked-in requests, in place."""
    src = torch.where(mask, now, INT32_MIN).to(field.dtype)
    field.view(-1).scatter_reduce_(0, idx.reshape(-1), src.reshape(-1),
                                   "amax")


def _elem(state: TagState, array_idx, set_idx, way) -> torch.Tensor:
    return _row(state, array_idx, set_idx) * state["tags"].shape[-1] \
        + way.long()


def entry(state: TagState, key: str, array_idx, set_idx, way
          ) -> torch.Tensor:
    """The ``key`` field of each request's (array, set, way)."""
    return state[key].reshape(-1)[_elem(state, array_idx, set_idx, way)]


def touch(state: TagState, array_idx, set_idx, way, now, mask, *,
          set_dirty=None) -> TagState:
    """Refresh LRU timestamp (and optionally dirty) for masked requests,
    in place; returns ``state``.

    ``now`` is the round counter, an int32 zero-dim tensor.
    """
    idx = _elem(state, array_idx, set_idx, way)
    _max_at(state["last"], idx, now, mask)
    if set_dirty is not None:
        _write(state["dirty"], idx, _winner(idx, mask & set_dirty), True)
    return state


def fill(state: TagState, array_idx, set_idx, way, addr, now, mask, *,
         dirty=None) -> Tuple[TagState, torch.Tensor]:
    """Install lines for masked requests, in place; returns (state,
    evicted_dirty).

    Masked-out requests change nothing; within the masked-in ones,
    duplicate (array, set, way) targets resolve last-writer-wins (see
    the module docstring). ``evicted_dirty`` flags write-back traffic.
    """
    idx = _elem(state, array_idx, set_idx, way)
    old_valid = state["valid"].view(-1)[idx]
    old_dirty = state["dirty"].view(-1)[idx]
    evicted_dirty = mask & old_valid & old_dirty
    win = _winner(idx, mask)
    _write(state["tags"], idx, win, addr)
    _write(state["valid"], idx, win, True)
    _max_at(state["last"], idx, now, mask)
    _write(state["born"], idx, win, now)
    _write(state["dirty"], idx, win, dirty if dirty is not None else False)
    return state, evicted_dirty


def dead_victim(state: TagState, array_idx, set_idx, addr,
                policy: ReplacementPolicy = ReplacementPolicy.LRU,
                ) -> torch.Tensor:
    """Predict whether a fill for ``addr`` would evict a *dead* line.

    Dead = the replacement victim the ``policy`` would select is valid
    but was never re-touched after its own install (``last == born``) —
    the set is absorbing streaming traffic. Shared detector of the
    CIAO-style policies (``ata_bypass`` fill bypass, ``ciao`` thrash
    counters).
    """
    _, victim, _ = probe(state, array_idx, set_idx, addr, policy=policy)
    at = (array_idx, set_idx, victim)
    return (entry(state, "valid", *at)
            & (entry(state, "last", *at) == entry(state, "born", *at)))


# ---------------------------------------------------------------------------
# Victim tag buffer (policy-zoo extension; see module docstring)
# ---------------------------------------------------------------------------
def victim_ways(state: TagState) -> int:
    """Entries per array in the victim tag buffer (0 = disabled)."""
    return state["vtags"].shape[-1]


def _vrow(state: TagState, array_idx) -> torch.Tensor:
    """Index of each request's buffer in the buffer viewed as
    (P * n_arrays, victim_ways)."""
    P, A, _ = state["vtags"].shape
    p = torch.arange(P, device=array_idx.device)[:, None]
    return p * A + array_idx.long()


def victim_probe(state: TagState, array_idx, addr
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fully-associative lookup in each request's victim buffer.

    Returns (hit, slot), each (P, R); slot is the first matching entry.
    A zero-sized buffer never hits.
    """
    if victim_ways(state) == 0:
        return (torch.zeros(addr.shape, dtype=torch.bool,
                            device=addr.device),
                torch.zeros(addr.shape, dtype=torch.int32,
                            device=addr.device))
    row = _vrow(state, array_idx)
    vtags = _gather(state, "vtags", row)                   # (P, R, V)
    vvalid = _gather(state, "vvalid", row)
    match = (vtags == addr[..., None]) & vvalid
    hit = match.any(dim=-1)
    slot = match.to(torch.uint8).argmax(dim=-1).to(torch.int32)
    return hit, slot


def victim_invalidate(state: TagState, array_idx, slot, mask) -> TagState:
    """Drop masked requests' victim entries (e.g. on promote back to L1),
    in place; returns ``state``."""
    if victim_ways(state) == 0:
        return state
    idx = _vrow(state, array_idx) * victim_ways(state) + slot.long()
    _write(state["vvalid"], idx, _winner(idx, mask), False)
    return state


def victim_insert(state: TagState, array_idx, addr, now, mask) -> TagState:
    """FIFO-install masked requests' tags into their victim buffers, in
    place; returns ``state``.

    Each request's slot comes from the buffer as it stands before the
    insert: invalid slots win first, then the oldest install. Duplicate
    (array, slot) targets resolve last-writer-wins (the highest request
    index, :func:`_winner`), like ``fill`` — a round that evicts several
    lines from one cache keeps only the last (the buffer has one fill
    port).
    """
    if victim_ways(state) == 0:
        return state
    row = _vrow(state, array_idx)
    vvalid = _gather(state, "vvalid", row)                 # (P, R, V)
    vborn = _gather(state, "vborn", row)
    slot = torch.where(vvalid, vborn, INT32_MIN).argmin(dim=-1)
    idx = row * victim_ways(state) + slot
    win = _winner(idx, mask)
    _write(state["vtags"], idx, win, addr)
    _write(state["vvalid"], idx, win, True)
    _write(state["vborn"], idx, win, now)
    return state
