"""Set-associative tag arrays on torch tensors, with pluggable replacement.

State is a dict of tensors with a leading simulation-point axis P (the
``simulate_batch`` axis; ``simulate`` is P=1):

    tags : (P, n_arrays, n_sets, n_ways) int32   line address stored per way
    last : (P, n_arrays, n_sets, n_ways) int32   last-touch timestamp (LRU)
    born : (P, n_arrays, n_sets, n_ways) int32   install timestamp (FIFO)
    valid: (P, n_arrays, n_sets, n_ways) bool
    dirty: (P, n_arrays, n_sets, n_ways) bool

plus the reference's policy-zoo extension keys, always zero-sized here
(no policy of this package uses them yet):

    vtags, vvalid, vborn : (P, n_arrays, 0)
    thrash               : (P, 0)

Requests are (P, R) tensors: request ``r`` of point ``p`` reads and
writes only point ``p``'s arrays.

Scatter convention (the reference's, made explicit): masked-out
requests change nothing, and among the masked-in requests of one point
duplicate (array, set, way) targets resolve last-writer-wins — the
highest request index. Torch gives no order for duplicate scatter
targets on CUDA, so :func:`_winner` picks that request with an
``amax`` scatter of request indices, and every request aimed at a
target then writes the winner's value: duplicate writes agree, and the
result is the same on every device. ``last`` is a max-scatter, which
needs no winner (masked-out lanes contribute ``INT32_MIN``).
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


def init_tag_state(n_arrays: int, n_sets: int, n_ways: int, *,
                   batch: int = 1, device="cpu") -> TagState:
    shape = (batch, n_arrays, n_sets, n_ways)
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)
    return {
        "tags": torch.zeros(shape, **i32),
        "last": torch.full(shape, -1, **i32),
        "born": torch.full(shape, -1, **i32),
        "valid": torch.zeros(shape, **b),
        "dirty": torch.zeros(shape, **b),
        "vtags": torch.zeros((batch, n_arrays, 0), **i32),
        "vvalid": torch.zeros((batch, n_arrays, 0), **b),
        "vborn": torch.full((batch, n_arrays, 0), -1, **i32),
        "thrash": torch.zeros((batch, 0), **i32),
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


def _winner(field: torch.Tensor, idx, mask) -> torch.Tensor:
    """Per request: the flat (p * R + r) index of the last masked-in
    request aimed at the same element of ``field``, or -1 if none."""
    lane = torch.arange(idx.numel(), device=idx.device).view_as(idx)
    win = torch.full((field.numel(),), -1, dtype=torch.long,
                     device=idx.device)
    win.scatter_reduce_(0, idx.reshape(-1),
                        torch.where(mask, lane, -1).reshape(-1), "amax")
    return win[idx]


def _write(field: torch.Tensor, idx, win, value) -> torch.Tensor:
    """``field`` with each element a masked-in request targets set to the
    winning request's ``value`` (a scalar or a (P, R) tensor)."""
    flat = field.reshape(-1)
    if torch.is_tensor(value) and value.dim() > 0:
        value = value.reshape(-1)[win.clamp(min=0)]
    val = torch.where(win >= 0, value, flat[idx])
    return flat.scatter(0, idx.reshape(-1), val.reshape(-1)).view_as(field)


def _max_at(field: torch.Tensor, idx, now, mask) -> torch.Tensor:
    """``field.at[idx].max(now)`` over the masked-in requests."""
    src = torch.where(mask, now, INT32_MIN).to(field.dtype)
    return field.reshape(-1).scatter_reduce(
        0, idx.reshape(-1), src.reshape(-1), "amax").view_as(field)


def _elem(state: TagState, array_idx, set_idx, way) -> torch.Tensor:
    return _row(state, array_idx, set_idx) * state["tags"].shape[-1] \
        + way.long()


def touch(state: TagState, array_idx, set_idx, way, now, mask, *,
          set_dirty=None) -> TagState:
    """Refresh LRU timestamp (and optionally dirty) for masked requests.

    ``now`` is the round counter, an int32 zero-dim tensor.
    """
    idx = _elem(state, array_idx, set_idx, way)
    out = dict(state, last=_max_at(state["last"], idx, now, mask))
    if set_dirty is not None:
        sel = mask & set_dirty
        out["dirty"] = _write(state["dirty"], idx,
                              _winner(state["dirty"], idx, sel), True)
    return out


def fill(state: TagState, array_idx, set_idx, way, addr, now, mask, *,
         dirty=None) -> Tuple[TagState, torch.Tensor]:
    """Install lines for masked requests; returns (state, evicted_dirty).

    Masked-out requests change nothing; within the masked-in ones,
    duplicate (array, set, way) targets resolve last-writer-wins (see
    the module docstring). ``evicted_dirty`` flags write-back traffic.
    """
    idx = _elem(state, array_idx, set_idx, way)
    old_valid = state["valid"].reshape(-1)[idx]
    old_dirty = state["dirty"].reshape(-1)[idx]
    evicted_dirty = mask & old_valid & old_dirty
    win = _winner(state["tags"], idx, mask)
    out = dict(
        state,
        tags=_write(state["tags"], idx, win, addr),
        valid=_write(state["valid"], idx, win, True),
        last=_max_at(state["last"], idx, now, mask),
        born=_write(state["born"], idx, win, now),
        dirty=_write(state["dirty"], idx, win,
                     dirty if dirty is not None else False))
    return out, evicted_dirty
