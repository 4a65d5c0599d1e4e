"""Observability exporters over ``repro_torch.core.telemetry`` captures.

The port of the reference's ``repro.obs``. ``repro_torch.core`` and
``repro_torch.serving`` own the capture (the ``telemetry=`` argument of
``simulate`` / ``SweepGrid.run`` / ``serve_stream``); this package owns
everything host-side and downstream of it:

* :mod:`repro_torch.obs.timeline` — :class:`SimTimeline` /
  :class:`ServeTimeline`: per-window counter series with exact
  conservation checks (window sums == run totals), window re-binning,
  and CSV/JSON series export.
* :mod:`repro_torch.obs.perfetto` — Chrome-trace-event JSON export (one
  track per core/shard/link, counter tracks for queue depth and hit
  rate), loadable in Perfetto (https://ui.perfetto.dev) or
  ``chrome://tracing``.
* :mod:`repro_torch.obs.manifest` — run manifests (git sha, torch and
  CUDA versions, card and power limit, kernel builds, pass counts,
  per-phase wall clock) attached to the reports.

Layering: ``repro_torch.obs`` imports from ``repro_torch.core`` (the
counter registry); never the reverse at module scope — ``simulate`` /
``serve_stream`` import the timeline classes inside their telemetry
branches.
"""
from repro_torch.obs.manifest import PhaseTimer, run_manifest
from repro_torch.obs.perfetto import trace_events, validate_trace, write_trace
from repro_torch.obs.timeline import (ConservationError, ServeTimeline,
                                      SimTimeline)

__all__ = [
    "SimTimeline", "ServeTimeline", "ConservationError",
    "trace_events", "validate_trace", "write_trace",
    "PhaseTimer", "run_manifest",
]
