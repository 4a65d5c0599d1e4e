"""ATA serving cache against its baselines on a small synthetic workload
(the port of the reference's ``benchmarks/serving_ata.py``; the paper's
section III adapted to serving).

Runs the numpy oracle's ``run_workload`` over every policy of
``repro_torch.serving.POLICIES`` on 300 synthetic requests over 8 shards
and prints hit rate, probe messages, remote fetches and local hits per
policy. Host only: it launches nothing on the card.
"""
from __future__ import annotations

import time

from repro_torch.launch.common import emit
from repro_torch.serving import (AtaCacheConfig, POLICIES, run_workload,
                                 synth_requests)


def run():
    cfg = AtaCacheConfig(n_shards=8)
    reqs = synth_requests(300, n_shards=8, shared_frac=0.75, seed=1)
    out = {}
    for pol in POLICIES:
        t0 = time.perf_counter()
        s = run_workload(pol, cfg, reqs)
        us = (time.perf_counter() - t0) * 1e6
        out[pol] = s
        emit(f"serving.{pol}.hit_rate", us, f"{s.hit_rate:.3f}")
        emit(f"serving.{pol}.probe_messages", us, s.probe_messages)
        emit(f"serving.{pol}.remote_fetch_blocks", us,
             s.remote_fetch_blocks)
        emit(f"serving.{pol}.local_hits", us, s.local_hits)
    return out


if __name__ == "__main__":
    run()
