"""Serving-engine scale benchmark: shards x traffic mix x policy x B (the
port of the reference's ``benchmarks/fig_serving_scale.py``).

Replays multi-tenant :class:`~repro_torch.core.trace.serving.ServingMix`
request streams through the serving engine (``repro_torch.serving``) and
reports per cell: hit rate, probe/fetch/recompute counters, replay
throughput (requests per wall-second, the best of ``reps`` replays after a
warm one; the engine streams its grids back to the host, so the timed
span ends synchronized), and p50/p99 request latency. The full run
calibrates rounds so every (shards, mix) stream carries at least
1,000,000 requests.

Each (shards, mix, policy) cell runs at every ``SLOT_COUNTS`` batch width
over the same request population, so ``batched_model_speedup`` (modeled
requests per kcycle, B=max over B=1, worst cell) isolates the throughput
model; ``batched_wall_speedup`` is the same ratio on the host's clock.

Telemetry is on by default: the reported p50/p99 are exact histogram
quantiles (``hist_exact``). Eager PyTorch has nothing to compile, so with
telemetry the instrumented replay is also the warm-up: two replays per
cell at ``reps=1``. The timed span always replays the plain
(``telemetry=None``) path; the counters are bit-equal either way.

``--json`` writes the ``kind="serving"`` schema-2 report with its run
``manifest``; its ``config.probe_backend`` is the backend the replays
resolved (``--probe-backend``, default the device's). ``--check BASELINE``
gates it with ``repro_torch.core.report.compare_serving`` (probe and
request counts exact, hit rate within 0.5%, the batched headline
one-sided) and exits non-zero on any failure.

Usage (on the CUDA card; ``--device cpu`` runs without one):
  PYTHONPATH=src python -m repro_torch.launch.serving_scale --rounds 512 \\
      --probe-backend torch --json serving.json \\
      --check benchmarks/baselines/serving_rounds512.json
  PYTHONPATH=src python -m repro_torch.launch.serving_scale --device cpu \\
      --rounds 64 --shards 4 --reps 1
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import List, Optional

from repro_torch.launch.common import emit

SCHEMA = 2
SHARD_COUNTS = (8, 16)
#: >= 2 traffic mixes: a high-sharing diurnal pair and a bursty
#: low-sharing pair (tenant table: repro_torch.core.trace.serving.TENANTS).
MIX_NAMES = (("chat", "rag"), ("chat", "batch"))
#: Admission widths benchmarked per cell; the batched-speedup headline
#: compares the widest against B=1.
SLOT_COUNTS = (1, 4)
#: Rounds used when ``rounds`` is not given: calibrated per (shards,
#: mix) so every stream carries at least ``n_requests`` requests.
DEFAULT_REQUESTS = 1_000_000
_CALIB_ROUNDS = 2048


def _mixes():
    from repro_torch.core.trace.serving import ServingMix
    return tuple(ServingMix(names, name="+".join(names))
                 for names in MIX_NAMES)


def _rounds_for(mix, n_shards, target, seed):
    """Rounds so the mix's stream offers >= target admitted requests."""
    probe = mix.make_stream(n_shards=n_shards, rounds=_CALIB_ROUNDS,
                            seed=seed)
    occupancy = max(probe.n_requests / (_CALIB_ROUNDS * n_shards), 1e-3)
    return math.ceil(1.02 * target / (occupancy * n_shards))


def _timed_serve(policy, stream, cfg, reps, telemetry, device):
    """Best-of-``reps`` replay of the plain path after the instrumented
    one, which is the warm-up and whose result (with its latency
    histogram) is returned."""
    from repro_torch.serving import serve_stream
    res, _ = serve_stream(policy, stream, cfg, telemetry=telemetry,
                          device=device)
    best = float("inf")
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        serve_stream(policy, stream, cfg, device=device)
        best = min(best, time.perf_counter() - t0)
    return res, best


def run(rounds=None, n_requests=DEFAULT_REQUESTS, shards=SHARD_COUNTS,
        mixes=None, policies=None, slot_counts=SLOT_COUNTS, reps=2,
        cfg=None, seed=0, out_json=None, telemetry=None, device=None):
    """Replay the grid; returns the serving report (and writes it to
    ``out_json``). Runs on ``device`` (default ``"cuda"``)."""
    from repro_torch.core.probe import resolve_probe_backend
    from repro_torch.core.simulator import resolve_device
    from repro_torch.core.telemetry import TelemetryConfig
    from repro_torch.obs.manifest import PhaseTimer, run_manifest
    from repro_torch.serving import SERVING_POLICIES, ServingConfig
    device = resolve_device(device)
    cfg = cfg or ServingConfig()
    backend = resolve_probe_backend(cfg.probe_backend, device)
    if telemetry is None:
        # default on: the reported p50/p99 become exact histogram
        # quantiles instead of percentiles over materialized latencies
        telemetry = TelemetryConfig()
    timer = PhaseTimer()
    mixes = _mixes() if mixes is None else mixes
    policies = tuple(policies or SERVING_POLICIES)
    slot_counts = tuple(sorted(set(slot_counts)))
    b_max = max(slot_counts)
    cells = []
    probe_msgs = {}
    hit_rates = {}
    model_ratios = []
    wall_ratios = []
    for s in shards:
        for mix in mixes:
            r = rounds if rounds is not None else _rounds_for(
                mix, s, n_requests, seed)
            r += -r % b_max   # every B must divide the row count
            stream = mix.make_stream(n_shards=s, rounds=r, seed=seed)
            if rounds is None and stream.n_requests < n_requests:
                raise RuntimeError(f"calibrated stream has "
                                   f"{stream.n_requests} < {n_requests} "
                                   "requests")
            for policy in policies:
                by_b = {}
                for b in slot_counts:
                    with timer.phase(f"replay.{policy}"):
                        res, wall = _timed_serve(
                            policy, stream.batched(b), cfg, reps,
                            telemetry, device)
                    rps = stream.n_requests / wall
                    by_b[b] = (res, rps)
                    cells.append({
                        "shards": s, "mix": mix.mix_id,
                        "policy": policy, "slots": b,
                        "rounds": r, "requests": stream.n_requests,
                        "hit_rate": res.hit_rate,
                        "local_hits": res.local_hits,
                        "remote_hits": res.remote_hits,
                        "recomputed_blocks": res.recomputed_blocks,
                        "probe_messages": res.probe_messages,
                        "remote_fetch_blocks": res.remote_fetch_blocks,
                        "p50_latency": res.p50_latency,
                        "p99_latency": res.p99_latency,
                        "hist_exact": res.hist_exact,
                        "throughput_rps": rps,
                        "requests_per_kcycle": res.requests_per_kcycle,
                        "load_imbalance": res.load_imbalance,
                        "wall_s": wall,
                    })
                    if b == 1:
                        probe_msgs.setdefault(policy, 0)
                        probe_msgs[policy] += res.probe_messages
                        hit_rates.setdefault(policy, []) \
                            .append(res.hit_rate)
                    emit(f"serving_scale.s{s}.{mix.mix_id}.{policy}"
                         f".b{b}.hit_rate",
                         wall * 1e6, f"{res.hit_rate:.4f}")
                    emit(f"serving_scale.s{s}.{mix.mix_id}.{policy}"
                         f".b{b}.p99",
                         wall * 1e6, f"{res.p99_latency:.1f}cyc "
                         f"{rps:.0f}req/s")
                if b_max > 1 and 1 in by_b and b_max in by_b:
                    r1, rps1 = by_b[1]
                    rb, rpsb = by_b[b_max]
                    model_ratios.append(rb.requests_per_kcycle
                                        / max(r1.requests_per_kcycle,
                                              1e-9))
                    wall_ratios.append(rpsb / max(rps1, 1e-9))

    headline = {}
    if "broadcast" in probe_msgs and "ata" in probe_msgs:
        # the paper's claim at serving scale: the replicated directory
        # filters every probe message the broadcast baseline sends
        headline["probes_filtered"] = probe_msgs["broadcast"] \
            - probe_msgs["ata"]
    if "ata" in hit_rates and "private" in hit_rates:
        n = len(hit_rates["ata"])
        headline["ata_vs_private_hit_gain"] = (
            sum(hit_rates["ata"]) - sum(hit_rates["private"])) / n
        emit("serving_scale.ata_vs_private_hit_gain", 0.0,
             f"{headline['ata_vs_private_hit_gain']:+.4f}")
    if model_ratios:
        # modeled throughput ratio, worst cell (gated one-sided); the
        # wall ratio rides along (batched replay is slot-sequential)
        headline["batched_slots"] = b_max
        headline["batched_model_speedup"] = min(model_ratios)
        headline["batched_wall_speedup"] = min(wall_ratios)
        emit("serving_scale.batched_model_speedup", 0.0,
             f"{headline['batched_model_speedup']:.2f}x@B={b_max}")
        emit("serving_scale.batched_wall_speedup", 0.0,
             f"{headline['batched_wall_speedup']:.2f}x@B={b_max}")

    report = {
        "kind": "serving",
        "schema": SCHEMA,
        "config": {
            "shards": list(shards),
            "mixes": [m.mix_id for m in mixes],
            "policies": list(policies),
            "slot_counts": list(slot_counts),
            "rounds": rounds,
            "n_requests": None if rounds is not None else n_requests,
            "seed": seed,
            "n_sets": cfg.n_sets, "n_ways": cfg.n_ways,
            "noc": cfg.noc, "probe_backend": backend,
        },
        "cells": cells,
        "headline": headline,
        "manifest": run_manifest(phases=timer.phases,
                                 extra={"device": str(device)}),
    }
    if out_json:
        with open(out_json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
    return report


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch.serving import SERVING_PROBE_BACKENDS, ServingConfig
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=None,
                    help="fixed rounds per stream (the baseline: 512); "
                    "default calibrates rounds to reach --requests")
    ap.add_argument("--requests", type=int, default=DEFAULT_REQUESTS,
                    help="minimum requests per (shards, mix) stream "
                    "(default 1,000,000)")
    ap.add_argument("--shards", type=int, nargs="+",
                    default=list(SHARD_COUNTS))
    ap.add_argument("--slots", type=int, nargs="+",
                    default=list(SLOT_COUNTS),
                    help="admission widths per cell (default 1 4)")
    ap.add_argument("--reps", type=int, default=2,
                    help="timed repetitions after warmup, best taken "
                    "(default 2)")
    ap.add_argument("--noc", default="ideal",
                    help="interconnect model pricing remote fetches")
    ap.add_argument("--probe-backend", default=None,
                    choices=SERVING_PROBE_BACKENDS,
                    help="directory probe (default: the device's)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the kind=serving report JSON here")
    ap.add_argument("--check", default=None, metavar="BASELINE",
                    help="committed serving baseline to gate against")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    rep = run(rounds=args.rounds, n_requests=args.requests,
              shards=tuple(args.shards), slot_counts=tuple(args.slots),
              reps=args.reps,
              cfg=ServingConfig(noc=args.noc,
                                probe_backend=args.probe_backend),
              out_json=args.json, device=args.device)
    if args.check is None:
        return 0
    from repro_torch.core.report import compare_serving, load_report
    failures = compare_serving(load_report(args.check), rep)
    for f in failures:
        print(f"REGRESSION: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
