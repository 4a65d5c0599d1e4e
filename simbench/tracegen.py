"""The benchmark's traffic generator: a frozen copy of the port's
``repro_torch.core.trace.apps`` table and ``repro_torch.core.trace.
generators`` (``make_trace``, ``kernel_params``), so that later changes to
the program cannot change the benchmark's traffic. It imports nothing of
the program; ``tests/test_simbench_tracegen.py`` holds its traces equal to
the port's.

Each app of the paper's suite (Section IV) is a parameterized request
stream: a per-(round, core) choice between a cluster-shared pool, a
streaming region and a per-core private pool, with each load's ``m``
requests coalesced into consecutive lines or re-sampled. Kernel 0 is the
app's calibrated parameters; kernels 1.. draw deterministic jitter
around them.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, NamedTuple

import numpy as np


class Trace(NamedTuple):
    """One kernel's requests for all cores: ``addr`` (T, C, m) int32 line
    addresses, ``is_write`` (T, C, m) bool, ``insn_per_req`` the
    instructions a request amortizes."""
    addr: np.ndarray
    is_write: np.ndarray
    insn_per_req: float


@dataclasses.dataclass(frozen=True)
class AppParams:
    name: str
    high_locality: bool
    shared_frac: float
    ws_shared: int
    ws_private: int
    hot_frac: float = 0.0
    hot_size: int = 64
    stream_frac: float = 0.05
    coalesced: float = 0.8
    write_frac: float = 0.08
    insn_per_req: float = 6.0
    n_kernels: int = 4
    rounds: int = 1536
    m: int = 4


APPS: Dict[str, AppParams] = {p.name: p for p in [
    # ---- high inter-core locality ----------------------------------------
    AppParams("b+tree", True, shared_frac=0.82, ws_shared=1024,
              ws_private=224, hot_frac=0.05, hot_size=48, coalesced=0.75,
              write_frac=0.04, insn_per_req=26.0, n_kernels=2, m=2),
    AppParams("cfd", True, shared_frac=0.86, ws_shared=1024,
              ws_private=288, hot_frac=0.05, hot_size=96, coalesced=0.85,
              write_frac=0.10, insn_per_req=26.0, n_kernels=5, m=2),
    AppParams("doitgen", True, shared_frac=0.72, ws_shared=1024,
              ws_private=320, hot_frac=0.75, hot_size=8, coalesced=0.85,
              write_frac=0.06, insn_per_req=10.0, n_kernels=3),
    AppParams("conv3d", True, shared_frac=0.68, ws_shared=1152,
              ws_private=352, hot_frac=0.50, hot_size=32, coalesced=0.85,
              write_frac=0.08, insn_per_req=11.0, n_kernels=5),
    AppParams("SN", True, shared_frac=0.76, ws_shared=1344,
              ws_private=288, hot_frac=0.45, hot_size=48, coalesced=0.8,
              write_frac=0.05, insn_per_req=13.0, n_kernels=8),
    # ---- low inter-core locality ------------------------------------------
    AppParams("HS3D", False, shared_frac=0.10, ws_shared=512,
              ws_private=448, stream_frac=0.25, coalesced=0.9,
              write_frac=0.15, insn_per_req=7.0, n_kernels=6),
    AppParams("sradv1", False, shared_frac=0.08, ws_shared=384,
              ws_private=512, stream_frac=0.20, coalesced=0.9,
              write_frac=0.18, insn_per_req=6.0, n_kernels=15),
    AppParams("gaussian", False, shared_frac=0.12, ws_shared=448,
              ws_private=416, stream_frac=0.15, coalesced=0.85,
              write_frac=0.12, insn_per_req=8.0, n_kernels=3),
    AppParams("lud", False, shared_frac=0.14, ws_shared=512,
              ws_private=480, stream_frac=0.10, coalesced=0.8,
              write_frac=0.10, insn_per_req=7.0, n_kernels=4),
    AppParams("nw", False, shared_frac=0.06, ws_shared=320,
              ws_private=544, stream_frac=0.30, coalesced=0.75,
              write_frac=0.14, insn_per_req=6.0, n_kernels=2),
]}



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
