"""ATA-Cache core on PyTorch: the paper simulator, one module per
reference module of ``repro.core``.

Public API:
  GpuGeometry, PAPER_GEOMETRY — simulated GPU (paper Table II)
  GeomStructure, GeomScalars, split_geometry — structure/timing split
  simulate, simulate_batch, simulate_many, Trace, SimResult — run traces
      through one architecture (a leading point axis batches same-kind
      traces)
  SweepGrid, SweepPoint, SweepReport, SweepRun — multi-axis grids, one
      batched pass per (stacking family, NoC family, geometry structure,
      trace kind, probe backend)
  PAPER_ARCHITECTURES         — ("private", "remote", "decoupled", "ata");
      registered_archs() adds the zoo: ata_bypass, ata_fifo, ciao, victim
  ArchPolicy, register_arch, get_arch, registered_archs — policy plug-in
  NocModel, register_noc, get_noc, registered_nocs — interconnect plug-in
  PAPER_NOCS, NocStats        — topology comparison set + SimResult block
  ReplacementPolicy           — L1 victim selection (LRU / FIFO / RANDOM)
  APPS, make_trace            — calibrated workload suite
  WorkloadMix, AppStats       — multi-tenant co-scheduling and its
      per-app attribution block on SimResult
  run_app, run_suite, normalized_ipc, geomean — experiment drivers
  MixResult, MixRun, run_mixes — fairness metrics over co-scheduled mixes
  figures, report (modules)   — Figs. 8–10, Table I, the zoo table and
      the mix fairness rows; the sensitivity report and its gate
  TelemetryConfig             — opt-in windowed telemetry (``telemetry=``
      of simulate / SweepGrid.run / serve_stream; repro_torch.obs
      holds the timelines, traces and manifests)
"""
from repro_torch.core.telemetry import TelemetryConfig
from repro_torch.core.geometry import (GeomScalars, GeomStructure,
                                       GpuGeometry, PAPER_GEOMETRY,
                                       split_geometry)
from repro_torch.core.simulator import (AppStats, NocStats, SimResult,
                                        Trace, simulate, simulate_batch,
                                        simulate_many, trace_kind)
from repro_torch.core.sweep import (SweepGrid, SweepPoint, SweepReport,
                                    SweepRun)
from repro_torch.core.arch import (PAPER_ARCHITECTURES, ArchPolicy,
                                   L1Outcome, RequestBatch, get_arch,
                                   register_arch, registered_archs)
from repro_torch.core.noc import (PAPER_NOCS, NocModel, NocTraffic,
                                  NocTransit, get_noc, register_noc,
                                  registered_nocs)
from repro_torch.core.tagarray import ReplacementPolicy
from repro_torch.core.trace import (APPS, HIGH_LOCALITY, LOW_LOCALITY,
                                    AppParams, WorkloadMix, kernel_params,
                                    make_trace)
from repro_torch.core.metrics import (AppResult, MixResult, MixRun,
                                      app_traces, geomean, normalized_ipc,
                                      run_app, run_mixes, run_suite)

__all__ = [
    "GpuGeometry", "PAPER_GEOMETRY", "GeomStructure", "GeomScalars",
    "split_geometry", "SimResult", "AppStats", "NocStats", "Trace",
    "trace_kind", "simulate", "simulate_batch", "simulate_many",
    "SweepGrid", "SweepPoint", "SweepReport", "SweepRun",
    "PAPER_ARCHITECTURES", "ArchPolicy", "L1Outcome", "RequestBatch",
    "get_arch", "register_arch", "registered_archs",
    "NocModel", "NocTraffic", "NocTransit", "PAPER_NOCS", "get_noc",
    "register_noc", "registered_nocs", "ReplacementPolicy", "APPS",
    "HIGH_LOCALITY", "LOW_LOCALITY", "AppParams", "WorkloadMix",
    "kernel_params", "make_trace", "AppResult", "app_traces", "geomean",
    "normalized_ipc", "run_app", "run_suite", "MixResult", "MixRun",
    "run_mixes", "TelemetryConfig",
]
