"""The calibrated application table (paper Section IV).

Real Rodinia/Tango/Polybench address traces are not available offline,
so each application is modeled as a parameterized request-stream
generator whose locality structure matches the paper's classification:
five high inter-core-locality apps (``b+tree, cfd, doitgen, conv3d,
SN``) and five low-locality apps (incl. ``HS3D, sradv1``). Parameters:

  shared_frac    probability a request targets the cluster-shared pool
                 (inter-core locality); the rest go to a per-core pool
  ws_shared      shared working set, in 128B lines (vs 512 lines/L1)
  ws_private     per-core private working set, in lines
  hot_frac/size  fraction of shared accesses hitting a small hot subset
                 (drives same-line / same-home contention)
  stream_frac    streaming (compulsory-miss) fraction
  coalesced      whether a load's m requests are consecutive lines
  write_frac     store fraction
  insn_per_req   amortized instructions per memory request (intensity)
  n_kernels      kernels per app (Fig. 9 per-kernel diversity)

Apps are *calibrated proxies*. The parameter values are load-bearing —
golden tests pin the traces they generate — so this module holds data
only; the generators live in :mod:`repro_torch.core.trace.generators`.
This is a copy of the reference package's table (the port imports
nothing of ``repro``); the parity tests hold the generated traces
array-equal to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


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

HIGH_LOCALITY = [n for n, p in APPS.items() if p.high_locality]
LOW_LOCALITY = [n for n, p in APPS.items() if not p.high_locality]
