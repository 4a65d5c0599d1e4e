"""Synthetic trace generators over the calibrated app table.

A numpy copy of the reference's ``repro.core.trace.generators`` (the
port imports nothing of ``repro``): the same seeds and draws give
array-equal traces, which the parity tests pin for every app x kernel.

:func:`make_trace` turns one app's :class:`~repro_torch.core.trace.apps.
AppParams` into a :class:`~repro_torch.core.simulator.Trace` for all cores:
a per-(round, core) classification into shared / streaming / private
request pools, coalescing of each load's ``m`` requests, and an int32
narrowing guard on the generated line addresses.

Kernel-0 convention: **kernel 0 is the canonical calibration kernel**
— it is generated from the app's raw calibrated parameters, while
kernels ``1..n_kernels-1`` draw deterministic per-kernel jitter around
them (Fig. 9 per-kernel diversity). :func:`kernel_params` is the single
place that rule lives.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import List

import numpy as np

from repro_torch.core.simulator import Trace
from repro_torch.core.trace.apps import APPS, AppParams

#: Disjoint address regions (line numbers) within one app's slice.
_SHARED_BASE = 0
_PRIVATE_BASE = 1 << 20
_STREAM_BASE = 1 << 26


def _stable_seed(*parts) -> int:
    return zlib.crc32("|".join(str(p) for p in parts).encode()) & 0x7FFFFFFF


def _require_int32(addr: np.ndarray) -> np.ndarray:
    """Narrow int64 addresses to the simulator's int32, refusing to wrap.

    The streaming region grows monotonically from ``_STREAM_BASE`` and
    multi-app mixes slice the address space per app; very long traces
    (or too many co-scheduled apps) could silently overflow into
    negative line numbers on ``astype(np.int32)``, corrupting set
    hashing and region disjointness.
    """
    lo, hi = int(addr.min()), int(addr.max())
    info = np.iinfo(np.int32)
    if lo < 0 or hi > info.max:
        raise ValueError(
            f"trace addresses span [{lo}, {hi}], outside int32 "
            f"[0, {info.max}]; shrink rounds/working sets/app count or "
            "widen the simulator address type")
    return addr.astype(np.int32)


def _jittered_params(app: AppParams, kernel: int) -> AppParams:
    """Deterministic per-kernel jitter around the app's parameters."""
    rng = np.random.default_rng(_stable_seed(app.name, kernel))
    scale = lambda lo, hi: float(rng.uniform(lo, hi))
    return dataclasses.replace(
        app,
        shared_frac=float(np.clip(app.shared_frac * scale(0.6, 1.25), 0, .95)),
        ws_shared=max(64, int(app.ws_shared * scale(0.5, 1.6))),
        ws_private=max(64, int(app.ws_private * scale(0.7, 1.3))),
        hot_frac=float(np.clip(app.hot_frac * scale(0.5, 1.5), 0, 0.8)),
        stream_frac=float(np.clip(app.stream_frac * scale(0.5, 1.8), 0, .5)),
        insn_per_req=app.insn_per_req * scale(0.8, 1.25),
    )


def kernel_params(app: AppParams, kernel: int) -> AppParams:
    """The effective parameters of one kernel of ``app``.

    Kernel 0 returns ``app`` itself — the canonical calibration kernel,
    generated from the raw calibrated parameters so calibration scripts,
    goldens, and mixes have a jitter-free anchor. Kernels ``>= 1`` get
    deterministic jitter (:func:`_jittered_params`). Negative kernels
    are rejected rather than silently treated as jittered.
    """
    if kernel < 0:
        raise ValueError(f"kernel must be >= 0, got {kernel}")
    return app if kernel == 0 else _jittered_params(app, kernel)


def make_trace(app: AppParams, *, n_cores: int = 30, kernel: int = 0,
               seed: int = 0) -> Trace:
    """Generate one kernel's request trace for all cores."""
    p = kernel_params(app, kernel)
    rng = np.random.default_rng(_stable_seed(app.name, kernel, seed))
    T, C, m = p.rounds, n_cores, p.m

    # Per-(round, core) load classification.
    u = rng.random((T, C))
    is_shared = u < p.shared_frac
    is_stream = (u >= p.shared_frac) & (u < p.shared_frac + p.stream_frac)

    base = np.empty((T, C), np.int64)
    # shared pool (common to all cores in a cluster -> inter-core locality)
    hot = rng.random((T, C)) < p.hot_frac
    shared_addr = np.where(
        hot,
        rng.integers(0, p.hot_size, (T, C)),
        rng.integers(0, p.ws_shared, (T, C)))
    base[is_shared] = (_SHARED_BASE + shared_addr)[is_shared]
    # streaming: monotonically advancing per core (compulsory misses)
    stream = (_STREAM_BASE + np.arange(C)[None, :] * (1 << 16)
              + np.cumsum(np.ones((T, C), np.int64), axis=0) * m)
    base[is_stream] = stream[is_stream]
    # private pool
    priv = (_PRIVATE_BASE + np.arange(C)[None, :] * (1 << 14)
            + rng.integers(0, p.ws_private, (T, C)))
    rest = ~(is_shared | is_stream)
    base[rest] = priv[rest]

    # Coalescing: a load's m requests are consecutive lines (regular apps)
    # or independent re-samples from the same pool (irregular apps).
    coal = rng.random((T, C, 1)) < p.coalesced
    consec = base[:, :, None] + np.arange(m)[None, None, :]
    hot_s = rng.random((T, C, m)) < p.hot_frac
    resample_shared = _SHARED_BASE + np.where(
        hot_s,
        rng.integers(0, p.hot_size, (T, C, m)),
        rng.integers(0, p.ws_shared, (T, C, m)))
    resample_priv = (_PRIVATE_BASE + np.arange(C)[None, :, None] * (1 << 14)
                     + rng.integers(0, p.ws_private, (T, C, m)))
    scattered = np.where(is_shared[:, :, None], resample_shared,
                         resample_priv)
    scattered = np.where(is_stream[:, :, None], consec, scattered)
    addr = np.where(coal, consec, scattered).astype(np.int64)

    is_write = rng.random((T, C, m)) < p.write_frac
    return Trace(addr=_require_int32(addr), is_write=is_write,
                 insn_per_req=p.insn_per_req)


def app_kernels(name: str) -> List[int]:
    return list(range(APPS[name].n_kernels))
