"""Small end-to-end telemetry capture: timelines, traces, manifest.

The port of the reference's ``benchmarks/telemetry_capture.py``, with
its constants. It runs one instrumented simulator point (``cfd`` kernel
0 under ``ata`` on the ``crossbar`` NoC, 96 rounds) and one instrumented
serving replay (``ata``, 8 shards, chat+rag, 256 rounds), window 32,
then writes everything the observability stack can produce into
``OUT/``:

  sim_timeline.json / .csv      windowed counter series (simulator)
  sim_trace.json                Chrome-trace-event (Perfetto) view
  serve_timeline.json / .csv    windowed counter series (serving)
  serve_trace.json              Perfetto view of the replay
  manifest.json                 provenance (git sha, torch, card, builds,
                                walls)
  telemetry_report.json         ``kind="telemetry"`` summary

Conservation is checked inline (``Timeline.check`` raises
:class:`repro_torch.obs.ConservationError` on any window-sum /= total
mismatch), so a capture that writes files is also a capture that
validated them. Open a ``*_trace.json`` at https://ui.perfetto.dev (or
``chrome://tracing``): one track per core or shard, counter tracks for
hit rate, queue depth and probe messages; the time axis is model cycles.

Usage (on the CUDA card; ``--device cpu`` runs without one):
  PYTHONPATH=src python -m repro_torch.launch.telemetry_capture OUT/
  PYTHONPATH=src python -m repro_torch.launch.telemetry_capture OUT/ \\
      --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

SCHEMA = 1
#: default capture sizes — small enough for a smoke run, large enough
#: that every counter axis (core/app/link/tenant/slot) is hot
SIM_ROUNDS = 96
SERVE_ROUNDS = 256
WINDOW = 32
SIM_ARCH = "ata"
SIM_NOC = "crossbar"          # non-ideal: exercises the link counters
SERVE_POLICY = "ata"
SERVE_SHARDS = 8
SERVE_MIX = ("chat", "rag")


def capture(out_dir, rounds=None, out_json=None, device=None) -> dict:
    """Run the instrumented smoke points and write all artifacts.

    Returns the ``kind="telemetry"`` report dict (also written to
    ``OUT/telemetry_report.json``, and to ``out_json`` when given).
    Runs on ``device`` (default ``"cuda"``).
    """
    from repro_torch.core import PAPER_GEOMETRY, TelemetryConfig, simulate
    from repro_torch.core.metrics import app_traces
    from repro_torch.core.simulator import resolve_device
    from repro_torch.core.trace.serving import ServingMix
    from repro_torch.obs.manifest import PhaseTimer, run_manifest
    from repro_torch.obs.perfetto import write_trace
    from repro_torch.serving import ServingConfig, serve_stream

    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    sim_rounds = rounds if rounds is not None else SIM_ROUNDS
    sim_rounds += -sim_rounds % WINDOW     # window must divide rounds
    telemetry = TelemetryConfig(window=WINDOW)
    timer = PhaseTimer()

    # --- simulator capture -------------------------------------------
    trace = app_traces("cfd", PAPER_GEOMETRY, [0], rounds=sim_rounds)[0]
    with timer.phase("sim"):
        res, stl = simulate(SIM_ARCH, trace, PAPER_GEOMETRY, noc=SIM_NOC,
                            telemetry=telemetry, device=device)
    stl.check(res)                         # conservation, or raise
    stl.write_json(os.path.join(out_dir, "sim_timeline.json"))
    stl.write_csv(os.path.join(out_dir, "sim_timeline.csv"))
    write_trace(os.path.join(out_dir, "sim_trace.json"), stl)
    sim_cell = {
        "arch": SIM_ARCH, "noc": SIM_NOC, "app": "cfd",
        "rounds": sim_rounds, "window": WINDOW,
        "n_windows": stl.n_windows,
        "l1_hit_rate": float(res.l1_hit_rate),
        "l1_latency": float(res.l1_latency),
        # log2-bucketed: a conservative upper-edge quantile, tracked
        # for drift (the serving p99 below is the exact one)
        "p99_latency_bucket": stl.hist_percentile(99),
    }

    # --- serving capture ---------------------------------------------
    serve_rounds = rounds if rounds is not None else SERVE_ROUNDS
    mix = ServingMix(SERVE_MIX, name="+".join(SERVE_MIX))
    stream = mix.make_stream(n_shards=SERVE_SHARDS, rounds=serve_rounds,
                             seed=0)
    with timer.phase("serving"):
        sres, vtl = serve_stream(SERVE_POLICY, stream, ServingConfig(),
                                 telemetry=telemetry, device=device)
    vtl.check(sres)                        # conservation, or raise
    vtl.write_json(os.path.join(out_dir, "serve_timeline.json"))
    vtl.write_csv(os.path.join(out_dir, "serve_timeline.csv"))
    write_trace(os.path.join(out_dir, "serve_trace.json"), vtl)
    serve_cell = {
        "policy": SERVE_POLICY, "mix": mix.mix_id,
        "shards": SERVE_SHARDS, "rounds": serve_rounds,
        "window": WINDOW, "n_windows": vtl.n_windows,
        "requests": int(sres.n_requests),
        "hit_rate": float(sres.hit_rate),
        "hist_exact": bool(sres.hist_exact),
        "p50_latency": sres.latency_percentile(50),
        "p99_latency": sres.latency_percentile(99),
    }

    manifest = run_manifest(phases=timer.phases,
                            extra={"device": str(device)})
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True, default=str)
        f.write("\n")

    report = {
        "kind": "telemetry",
        "schema": SCHEMA,
        "config": {"window": WINDOW, "rounds": rounds},
        "sim": sim_cell,
        "serving": serve_cell,
        "manifest": manifest,
    }
    for path in filter(None, [os.path.join(out_dir,
                                           "telemetry_report.json"),
                              out_json]):
        with open(path, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True, default=str)
            f.write("\n")
    return report


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", help="artifact directory (created)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="override both capture sizes")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the telemetry report JSON here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    report = capture(args.out_dir, rounds=args.rounds, out_json=args.json,
                     device=args.device)
    print(f"telemetry capture ok: sim p99<= "
          f"{report['sim']['p99_latency_bucket']:.0f}cyc, serving "
          f"p99={report['serving']['p99_latency']:.1f}cyc "
          f"-> {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
