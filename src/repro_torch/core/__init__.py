"""ATA-Cache core on PyTorch: the paper simulator, one module per
reference module of ``repro.core``.

Public API:
  GpuGeometry, PAPER_GEOMETRY — simulated GPU (paper Table II)
  simulate, simulate_batch, Trace, SimResult — run traces through one
      architecture (a leading point axis batches same-shape traces)
  PAPER_ARCHITECTURES         — ("private", "remote", "decoupled", "ata");
      registered_archs() adds the zoo: ata_bypass, ata_fifo, ciao, victim
  ArchPolicy, register_arch, get_arch, registered_archs — policy plug-in
  NocModel, register_noc, get_noc, registered_nocs — interconnect plug-in
  ReplacementPolicy           — L1 victim selection (LRU / FIFO / RANDOM)
  APPS, make_trace            — calibrated workload suite
  run_app, run_suite, normalized_ipc, geomean — experiment drivers
  figures (module)            — Figs. 8–10, Table I and the zoo table
      as rows of a run_suite result
"""
from repro_torch.core.geometry import GpuGeometry, PAPER_GEOMETRY
from repro_torch.core.simulator import (AppStats, NocStats, SimResult,
                                        Trace, simulate, simulate_batch,
                                        trace_kind)
from repro_torch.core.arch import (PAPER_ARCHITECTURES, ArchPolicy,
                                   L1Outcome, RequestBatch, get_arch,
                                   register_arch, registered_archs)
from repro_torch.core.noc import (NocModel, NocTraffic, NocTransit, get_noc,
                                  register_noc, registered_nocs)
from repro_torch.core.tagarray import ReplacementPolicy
from repro_torch.core.trace import (APPS, HIGH_LOCALITY, LOW_LOCALITY,
                                    AppParams, kernel_params, make_trace)
from repro_torch.core.metrics import (AppResult, app_traces, geomean,
                                      normalized_ipc, run_app, run_suite)

__all__ = [
    "GpuGeometry", "PAPER_GEOMETRY", "SimResult", "AppStats", "NocStats",
    "Trace", "trace_kind", "simulate", "simulate_batch",
    "PAPER_ARCHITECTURES", "ArchPolicy", "L1Outcome", "RequestBatch",
    "get_arch", "register_arch", "registered_archs",
    "NocModel", "NocTraffic", "NocTransit", "get_noc", "register_noc",
    "registered_nocs", "ReplacementPolicy", "APPS", "HIGH_LOCALITY",
    "LOW_LOCALITY", "AppParams", "kernel_params", "make_trace", "AppResult",
    "app_traces", "geomean", "normalized_ipc", "run_app", "run_suite",
]
