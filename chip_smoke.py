#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero with no
result line):

1. the card's name and power limit; build every kernel from ``csrc/``,
   one ``nvcc`` per source, all started together;
2. each kernel against its plain PyTorch version on the card, bit for
   bit, at its main path's shapes and harder ones, plus its timings;
3. the 8 pre-refactor goldens (cfd/HS3D x 4 paper architectures,
   192 rounds, kernel 1) through ``simulate`` on the card;
4. the simulator's main path: ``run_suite()`` over all 10 apps x 53
   kernels x 4 paper architectures at 1536 rounds on the paper geometry,
   with the launch counters zeroed just before and read just after;
   Fig. 8 normalized IPC and geomean gains; ``ata`` again on the plain
   ``torch`` probe backend, which must give bit-equal results; kernel 0
   of every app against the stored reference results;
5. serving exactness: the engine on the card against the port's numpy
   oracle at the reference's test sizes (every policy x B, and the
   sequential stream), all 24 cells of the committed serving baseline
   (``benchmarks/baselines/serving_rounds512.json``), the ``cuda`` and
   ``torch`` probe backends bit-equal, NoC flit conservation;
6. the serving main path at the size its users run
   (``fig_serving_scale.py``'s defaults): one 16-shard chat+rag stream of
   about 1,020,000 requests replayed under ``ata`` at B=4, with the
   launch counters zeroed just before and read just after, and a
   profile of 64 sub-rounds;
7. the per-phase times, the card line again, a ``kernels`` JSON line,
   and as the last line ``{"ok": true, "device": {...}}``.

Details go to ``chiprun_out/chip_smoke_report.json``.
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
REPORT = ROOT / "chiprun_out" / "chip_smoke_report.json"

#: H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12      # non-tensor-core rate; the compares are int32

#: tests/test_arch_registry.py::GOLDEN (seed simulator, rounds=192, kernel 1)
GOLDEN = {
    ("cfd", "private"): dict(
        ipc=48.13981554281181, l1_latency=32.0,
        local_hit_rate=0.1287326388888889, remote_hit_rate=0.0,
        l1_hit_rate=0.1287326388888889, l2_accesses=10037.0,
        dram_accesses=5707.0, noc_flits=40148.0,
        cycles=7029.44677734375, instructions=338396.27122934104),
    ("cfd", "remote"): dict(
        ipc=45.47783321894619, l1_latency=47.09734693877551,
        local_hit_rate=0.1287326388888889, remote_hit_rate=0.20625,
        l1_hit_rate=0.3349826388888889, l2_accesses=7661.0,
        dram_accesses=5707.0, noc_flits=130481.0,
        cycles=7440.90576171875, instructions=338396.27122934104),
    ("cfd", "decoupled"): dict(
        ipc=48.866869537984314, l1_latency=50.52785388127854,
        local_hit_rate=0.3125, remote_hit_rate=0.0,
        l1_hit_rate=0.3125, l2_accesses=7920.0,
        dram_accesses=5712.0, noc_flits=46080.0,
        cycles=6924.86083984375, instructions=338396.27122934104),
    ("cfd", "ata"): dict(
        ipc=49.954089536322286, l1_latency=34.17364016736402,
        local_hit_rate=0.1287326388888889,
        remote_hit_rate=0.16770833333333332,
        l1_hit_rate=0.2964409722222222, l2_accesses=8105.0,
        dram_accesses=5707.0, noc_flits=40148.0,
        cycles=6774.1455078125, instructions=338396.27122934104),
    ("HS3D", "private"): dict(
        ipc=19.030607132323443, l1_latency=32.0,
        local_hit_rate=0.20598958333333334, remote_hit_rate=0.0,
        l1_hit_rate=0.20598958333333334, l2_accesses=18294.0,
        dram_accesses=17416.0, noc_flits=75024.0,
        cycles=8679.841796875, instructions=165182.6592070485),
    ("HS3D", "remote"): dict(
        ipc=16.818281729987405, l1_latency=34.58079545454545,
        local_hit_rate=0.20598958333333334,
        remote_hit_rate=0.01506076388888889,
        l1_hit_rate=0.22105034722222222, l2_accesses=17947.0,
        dram_accesses=17416.0, noc_flits=239670.0,
        cycles=9821.61328125, instructions=165182.6592070485),
    ("HS3D", "decoupled"): dict(
        ipc=18.24013462975359, l1_latency=54.798122065727696,
        local_hit_rate=0.19644097222222223, remote_hit_rate=0.0,
        l1_hit_rate=0.19644097222222223, l2_accesses=18514.0,
        dram_accesses=17437.0, noc_flits=92280.0,
        cycles=9056.0, instructions=165182.6592070485),
    ("HS3D", "ata"): dict(
        ipc=19.12823515147109, l1_latency=32.11472275334608,
        local_hit_rate=0.20598958333333334,
        remote_hit_rate=0.01115451388888889,
        l1_hit_rate=0.21714409722222222, l2_accesses=18037.0,
        dram_accesses=17416.0, noc_flits=75024.0,
        cycles=8635.541015625, instructions=165182.6592070485),
}

#: counters held exactly; every other float within rtol=1e-6 (the
#: goldens' bar)
EXACT = {"l2_accesses", "dram_accesses", "noc_flits", "local_hits",
         "remote_hits", "requests", "l1_lat_n", "flits_injected",
         "flits_delivered", "app", "cores"}


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def result_dict(r) -> dict:
    d = r._asdict()
    d["per_app"] = [a._asdict() for a in r.per_app]
    d["noc"] = r.noc._asdict()
    return d


def max_rel_err(got: dict, want: dict, where: str = "") -> float:
    """Check nested SimResult dicts (EXACT fields bit-equal, NaN where
    NaN, other floats within rtol=1e-6); returns the largest relative
    difference seen."""
    if set(got) != set(want):
        raise AssertionError(f"{where}: fields {set(got) ^ set(want)}")
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            worst = max(worst, max_rel_err(g, w, f"{where}.{k}"))
        elif isinstance(w, list):
            if len(g) != len(w):
                raise AssertionError(f"{where}.{k}: {len(g)} != {len(w)}")
            for gi, wi in zip(g, w):
                worst = max(worst, max_rel_err(gi, wi, f"{where}.{k}"))
        elif isinstance(w, float) and math.isnan(w):
            if not math.isnan(g):
                raise AssertionError(f"{where}.{k}: {g} is not NaN")
        elif k in EXACT:
            if g != w:
                raise AssertionError(f"{where}.{k}: {g} != {w} (exact)")
        else:
            rel = abs(g - w) / abs(w) if w else abs(g)
            if rel > 1e-6:
                raise AssertionError(f"{where}.{k}: {g} vs {w}, rel {rel}")
            worst = max(worst, rel)
    return worst


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------
KERNELS = ("ata_probe_rank", "ata_tag_probe")


def phase_build() -> dict:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(build.build, KERNELS)))
    secs = time.perf_counter() - t0
    for name, (lib, ptxas) in built.items():
        log(f"built {name}: {lib.name}")
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build: {secs:.2f} s")
    return {"build_s": secs}


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version on the card
# ---------------------------------------------------------------------------
def probe_rank_inputs(P, R, seed, device, C=30, S=8, W=64, G=10):
    """Paper-geometry inputs with planted same-set duplicates, dirty
    sources and denied lanes."""
    import torch
    rng = np.random.default_rng(seed)
    tags = rng.integers(0, 96, (P, C, S, W)).astype(np.int32)
    valid = rng.random((P, C, S, W)) < 0.7
    dirty = valid & (rng.random((P, C, S, W)) < 0.25)
    qtag = rng.integers(0, 96, (P, R)).astype(np.int32)
    set_idx = rng.integers(0, S, (P, R)).astype(np.int32)
    core = np.broadcast_to(np.repeat(np.arange(C, dtype=np.int32),
                                     -(-R // C))[:R], (P, R)).copy()
    # planted: every 4th request repeats its predecessor's set and tag
    # (same-set duplicates from one or two cores)
    set_idx[:, 1::4] = set_idx[:, 0::4][:, :set_idx[:, 1::4].shape[1]]
    qtag[:, 1::4] = qtag[:, 0::4][:, :qtag[:, 1::4].shape[1]]
    cbase = (core // G) * G
    deny = rng.random((P, R)) < 0.2
    arrays = (set_idx, qtag, core, cbase.astype(np.int32), deny, tags,
              valid, dirty)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def time_ms(fn, n=200, warm=10) -> float:
    """Mean wall time per call on the card's clock (CUDA events)."""
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_device_ms(fn, name: str, n=100) -> float:
    """Mean device time per launch of kernel ``name`` (torch.profiler);
    None when the profiler shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if name in ev.key:
            total += ev.device_time_total
            count += ev.count
    if count == 0 or total <= 0:
        return None
    return total / count / 1e3      # us -> ms


def probe_rank_bound(args, G=10):
    """(bound_ms, bound_by, bytes, ops) for these inputs: each request
    reads its own row and its cluster's set rows (W int32 tags + valid +
    dirty bytes each, every distinct row once), the request inputs once
    and writes the six outputs once; the work is one compare per way of
    each row it scans."""
    set_idx, _, core, cbase, _, tags = (a.cpu().numpy() for a in args[:6])
    P, C, S, W = tags.shape
    R = set_idx.shape[1]
    p = np.broadcast_to(np.arange(P)[:, None], (P, R))
    rows = {(pp, cc, ss) for pp, cb, ss in zip(p.ravel(), cbase.ravel(),
                                              set_idx.ravel())
            for cc in range(cb, min(cb + G, C))}
    state_bytes = len(rows) * W * (4 + 1 + 1)
    io_bytes = P * R * (4 * 4 + 1) + P * R * (1 + 4 + 1 + 4 + 4 + 4)
    nbytes = state_bytes + io_bytes
    ops = P * R * G * W
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def phase_kernels(device) -> dict:
    import torch
    from repro_torch.kernels import ata_probe_rank as kmod
    worst = 0
    cases = []
    for P in (1, 53):
        for R in (60, 120, 150, 1500):
            args = probe_rank_inputs(P, R, seed=P * 10007 + R, device=device)
            got = kmod.ata_probe_rank(*args, cluster_size=10)
            want = kmod.ata_probe_rank_plain(*args, cluster_size=10)
            torch.cuda.synchronize()
            for name, g, w in zip(("local_hit", "hit_way", "remote_ok",
                                   "src_cache", "prank", "psize"), got, want):
                if g.dtype != w.dtype or not torch.equal(g, w):
                    raise AssertionError(
                        f"ata_probe_rank P={P} R={R}: {name} differs from "
                        "the plain version")
                worst = max(worst, int((g.long() - w.long()).abs().max()))
            hits = int(want[0].sum()) + int(want[2].sum())
            cases.append({"P": P, "R": R, "local_hits": int(want[0].sum()),
                          "remote_ok": int(want[2].sum())})
            if hits == 0:
                raise AssertionError(f"P={P} R={R}: inputs exercise nothing")
    log(f"ata_probe_rank == plain on the card for {len(cases)} shapes "
        f"(max abs err {worst})")

    timings = {}
    for P, R in ((46, 120), (7, 60)):    # the main path's two batches
        args = probe_rank_inputs(P, R, seed=P + R, device=device)
        kernel = lambda: kmod.ata_probe_rank(*args, cluster_size=10)  # noqa: E731
        plain = lambda: kmod.ata_probe_rank_plain(*args, cluster_size=10)  # noqa: E731
        bound_ms, bound_by, nbytes, ops = probe_rank_bound(args)
        # in turns: plain, kernel (call, then device time), plain
        plain_ms = [time_ms(plain)]
        t = {"call_ms": time_ms(kernel),
             "device_ms": kernel_device_ms(kernel, "ata_probe_rank_kernel")}
        plain_ms.append(time_ms(plain))
        t.update(plain_ms=sum(plain_ms) / 2, plain_ms_runs=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops)
        timings[f"P{P}_R{R}"] = t
        log(f"ata_probe_rank P={P} R={R}: kernel {t['device_ms']} ms on the"
            f" device, {t['call_ms']:.5f} ms per call; plain {plain_ms} ms;"
            f" bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, {ops} "
            "compares)")
    return {"max_abs_err": worst, "cases": cases, "timings": timings}


def tag_probe_inputs(R, C, S, W, seed, device):
    """Tags from a small range (duplicates across ways and caches),
    matching tags in invalid ways, some zero tags, and qtag 0 on every
    fifth request."""
    import torch
    rng = np.random.default_rng(seed)
    tags = rng.integers(1, 3 * W, (C, S, W)).astype(np.int32)
    tags[rng.random((C, S, W)) < 0.05] = 0
    valid = rng.random((C, S, W)) < 0.7
    set_idx = rng.integers(0, S, R).astype(np.int32)
    qtag = rng.integers(0, 3 * W, R).astype(np.int32)
    qtag[::5] = 0
    return [torch.from_numpy(a).to(device)
            for a in (set_idx, qtag, tags, valid)]


def tag_probe_bound(args, hits, ways):
    """(bound_ms, bound_by, bytes, ops) for these inputs: the request
    inputs read once, each distinct (cache, set) row of tags (4 B/way) +
    valid (1 B/way) read once, both outputs written once; the work is
    one compare per way up to the first match (all W on a miss)."""
    set_idx, _, tags, _ = (a.cpu().numpy() for a in args)
    C, S, W = tags.shape
    R = set_idx.shape[0]
    nbytes = R * 8 + C * len(np.unique(set_idx)) * W * 5 + R * C * 5
    ops = int(np.where(hits.cpu().numpy(), ways.cpu().numpy() + 1,
                       W).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def phase_tag_probe(device) -> dict:
    """``ata_tag_probe`` against its plain version: the four serving
    shapes (C, K) in {8, 16} x {14, 18} (R = C * K, 64 sets x 8 ways), odd
    R, one cache, and the paper geometry (30 caches, 8 sets x 64 ways)."""
    import torch
    from repro_torch.kernels import ata_tag_probe as tmod
    shapes = [(C * K, C, 64, 8) for C in (8, 16) for K in (14, 18)]
    shapes += [(1, 8, 64, 8), (37, 8, 64, 8), (37, 1, 64, 8),
               (120, 30, 8, 64)]
    worst, cases = 0, []
    for R, C, S, W in shapes:
        args = tag_probe_inputs(R, C, S, W, seed=R * 31 + C, device=device)
        got = tmod.ata_tag_probe(*args)
        want = tmod.ata_tag_probe_plain(*args)
        torch.cuda.synchronize()
        for name, g, w in zip(("hits", "ways"), got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"ata_tag_probe R={R} C={C} S={S} "
                                     f"W={W}: {name} differs from plain")
            worst = max(worst, int((g.long() - w.long()).abs().max()))
        n_hits = int(want[0].sum())
        if R >= 37 and not 0 < n_hits < R * C:
            raise AssertionError(f"R={R} C={C}: inputs exercise nothing")
        cases.append({"R": R, "C": C, "S": S, "W": W, "hits": n_hits})
    log(f"ata_tag_probe == plain on the card for {len(cases)} shapes "
        f"(max abs err {worst})")

    C, K = 16, 18                      # the scale replay's shape
    args = tag_probe_inputs(C * K, C, 64, 8, seed=7, device=device)
    kernel = lambda: tmod.ata_tag_probe(*args)  # noqa: E731
    plain = lambda: tmod.ata_tag_probe_plain(*args)  # noqa: E731
    bound_ms, bound_by, nbytes, ops = tag_probe_bound(args, *plain())
    plain_ms = [time_ms(plain)]
    t = {"call_ms": time_ms(kernel),
         "device_ms": kernel_device_ms(kernel, "ata_tag_probe_kernel")}
    t["call_ms_2"] = time_ms(kernel)
    plain_ms.append(time_ms(plain))
    t.update(plain_ms=sum(plain_ms) / 2, plain_ms_runs=plain_ms,
             bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops)
    log(f"ata_tag_probe C={C} K={K} (R={C * K}): kernel {t['device_ms']} ms"
        f" on the device, {t['call_ms']:.5f} / {t['call_ms_2']:.5f} ms per "
        f"call; plain {plain_ms} ms; bound {bound_ms:.7f} ms ({bound_by}: "
        f"{nbytes} B, {ops} compares)")
    return {"max_abs_err": worst, "cases": cases, "timing": t}


# ---------------------------------------------------------------------------
# phase 3: goldens
# ---------------------------------------------------------------------------
def phase_goldens(device) -> dict:
    import dataclasses
    from repro_torch.core import APPS, make_trace, simulate
    worst = 0.0
    for (app, arch), want in sorted(GOLDEN.items()):
        trace = make_trace(dataclasses.replace(APPS[app], rounds=192),
                           kernel=1)
        got = simulate(arch, trace, device=device)._asdict()
        worst = max(worst, max_rel_err({k: got[k] for k in want}, want,
                                       f"golden {app}/{arch}"))
    log(f"8 goldens hold on the card (max rel err {worst:.3g})")
    return {"max_rel_err": worst}


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
def phase_suite(device) -> dict:
    import torch
    from repro_torch.core import (APPS, HIGH_LOCALITY, LOW_LOCALITY,
                                  PAPER_ARCHITECTURES, app_traces, geomean,
                                  normalized_ipc, run_suite)
    from repro_torch.kernels import ata_probe_rank as kmod

    t0 = time.perf_counter()
    n_traces = sum(len(app_traces(app)) for app in APPS)
    traces_s = time.perf_counter() - t0
    log(f"trace generation for the suite ({n_traces} kernels): "
        f"{traces_s:.3f} s (part of each run_suite call below)")

    kmod.launches = 0
    suite, wall = {}, {}
    for arch in PAPER_ARCHITECTURES:
        t0 = time.perf_counter()
        part = run_suite(archs=(arch,), device=device)
        torch.cuda.synchronize()
        wall[arch] = time.perf_counter() - t0
        for app, cells in part.items():
            suite.setdefault(app, {}).update(cells)
    launches = kmod.launches

    n_kernels = sum(len(c["ata"].per_kernel) for c in suite.values())
    if n_kernels != 53 or len(suite) != 10:
        raise AssertionError(f"suite has {len(suite)} apps, {n_kernels} "
                             "kernels")
    ata_batches = 2          # the m=2 apps and the m=4 apps
    if launches < 1536 * ata_batches:
        raise AssertionError(f"ata_probe_rank launched {launches} times, "
                             f"want >= {1536 * ata_batches}")
    for app, cells in suite.items():
        for arch, res in cells.items():
            for r in res.per_kernel:
                vals = [v for k, v in r._asdict().items()
                        if k not in ("per_app", "noc")]
                if not all(math.isfinite(v) for v in vals) or r.ipc <= 0:
                    raise AssertionError(f"{app}/{arch}: non-finite {r}")

    ipc = normalized_ipc(suite)
    hi = geomean([ipc[a]["ata"] for a in HIGH_LOCALITY])
    lo = geomean([ipc[a]["ata"] for a in LOW_LOCALITY])
    log("Fig. 8 normalized IPC (vs private):")
    for app in list(HIGH_LOCALITY) + list(LOW_LOCALITY):
        log(f"  {app:9s} " + "  ".join(f"{a}={ipc[app][a]:.4f}"
                                        for a in PAPER_ARCHITECTURES))
    log(f"ata geomean gain: high-locality {100 * (hi - 1):.2f}%, "
        f"low-locality {100 * (lo - 1):.2f}%")
    for arch, s in wall.items():
        log(f"suite wall time {arch}: {s:.3f} s")

    # the plain probe backend on the card: bit-equal SimResults
    t0 = time.perf_counter()
    plain = run_suite(archs=("ata",), probe_backend="torch", device=device)
    torch.cuda.synchronize()
    wall["ata_plain_probe"] = time.perf_counter() - t0
    for app in suite:
        a = [tuple(r) for r in suite[app]["ata"].per_kernel]
        b = [tuple(r) for r in plain[app]["ata"].per_kernel]
        if a != b:
            raise AssertionError(f"{app}: cuda and torch probe backends "
                                 "disagree")
    log(f"ata with probe_backend='torch': bit-equal over 53 kernels "
        f"({wall['ata_plain_probe']:.3f} s)")

    # kernel 0 of every app against the stored reference results
    with open(SRC / "repro_torch" / "data" / "reference_kernel0.json") as f:
        ref = json.load(f)["results"]
    worst = 0.0
    for app, cells in suite.items():
        for arch, res in cells.items():
            worst = max(worst, max_rel_err(result_dict(res.per_kernel[0]),
                                           ref[app][arch],
                                           f"fixture {app}/{arch}"))
    log(f"kernel 0 of 10 apps x 4 archs match the reference fixture "
        f"(max rel err {worst:.3g})")
    profiled = profile_round_loop(device)
    return {"launches": launches, "wall_s": wall, "traces_s": traces_s,
            "profile": profiled,
            "normalized_ipc": ipc, "ata_gain_high": hi, "ata_gain_low": lo,
            "fixture_max_rel_err": worst}


def profile_round_loop(device, rounds: int = 64) -> dict:
    """Where a round's time goes: ``ata`` on the 46-kernel m=4 batch for
    ``rounds`` rounds under torch.profiler — host wall per round, device
    busy time per round (sum of kernel self times), kernel launches per
    round, and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import APPS, app_traces, simulate_batch
    traces = [t for app in APPS if APPS[app].m == 4
              for t in app_traces(app, rounds=rounds)]
    simulate_batch("ata", traces, device=device)            # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        simulate_batch("ata", traces, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = []
    for ev in prof.key_averages():
        dev = ev.self_device_time_total
        if dev > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel.append((dev, ev.count, ev.key))
    busy_us = sum(d for d, _, _ in per_kernel)
    launches = sum(c for _, c, _ in per_kernel)
    out = {"points": len(traces), "rounds": rounds,
           "wall_ms_per_round": wall * 1e3 / rounds,
           "device_busy_ms_per_round": busy_us / 1e3 / rounds,
           "device_busy_share": busy_us / 1e6 / wall,
           "kernel_launches_per_round": launches / rounds,
           "top_kernels_ms_per_round": [
               (k[:90], d / 1e3 / rounds, c / rounds)
               for d, c, k in sorted(per_kernel, reverse=True)[:8]]}
    log(f"ata round loop, P={len(traces)}: {out['wall_ms_per_round']:.3f} ms"
        f" wall per round, device busy {out['device_busy_ms_per_round']:.4f}"
        f" ms ({100 * out['device_busy_share']:.1f}%), "
        f"{out['kernel_launches_per_round']:.1f} kernel launches per round")
    for k, ms, c in out["top_kernels_ms_per_round"]:
        log(f"  {ms:.4f} ms/round  x{c:.1f}  {k}")
    return out


# ---------------------------------------------------------------------------
# phase 5: serving exactness
# ---------------------------------------------------------------------------
BASELINE = ROOT / "benchmarks" / "baselines" / "serving_rounds512.json"
SERVE_COUNTERS = ("local_hits", "remote_hits", "recomputed_blocks",
                  "probe_messages", "remote_fetch_blocks")
SERVE_FLOATS = ("hit_rate", "load_imbalance", "p50_latency", "p99_latency",
                "requests_per_kcycle")
#: two baseline cells replayed again on the plain ``torch`` probe
TORCH_PROBE_CELLS = ((16, "chat+batch", "broadcast", 4),
                     (8, "chat+rag", "ata", 4))


def same_serve_result(a, b) -> bool:
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            if x.dtype != y.dtype or not np.array_equal(x, y):
                return False
        elif x != y:
            return False
    return True


def phase_serving_exact(device) -> dict:
    import torch
    from repro_torch.core.trace.serving import ServingMix
    from repro_torch.serving import (SERVING_POLICIES, ServingConfig, ref,
                                     serve_stream)

    def check(res, st, where):
        got = tuple(getattr(res, f) for f in SERVE_COUNTERS)
        want = tuple(getattr(st, f) for f in SERVE_COUNTERS)
        if got != want or not np.array_equal(res.shard_load, st.shard_load):
            raise AssertionError(f"{where}: engine {got} {res.shard_load} "
                                 f"vs oracle {want} {st.shard_load}")

    # (a) the reference's test sizes against the numpy oracle
    stream = ServingMix(("chat", "batch")).make_stream(n_shards=4, rounds=64,
                                                       seed=1)
    seq = stream.sequential()
    n_a = 0
    for policy in SERVING_POLICIES:
        oracle = ref.run_stream(policy, ref.AtaCacheConfig(), stream)
        for b in (1, 2, 4):
            check(serve_stream(policy, stream.batched(b), device=device),
                  oracle, f"(a) {policy} B={b}")
            n_a += 1
        check(serve_stream(policy, seq, device=device),
              ref.run_stream(policy, ref.AtaCacheConfig(), seq),
              f"(a) {policy} sequential")
        n_a += 1
    log(f"(a) serving engine on the card == numpy oracle: {n_a} replays "
        "(3 policies x B in {1, 2, 4}, and the sequential stream)")

    # (b) the committed baseline, every cell
    rep = json.loads(BASELINE.read_text())
    cfg = rep["config"]
    if (cfg["n_sets"], cfg["n_ways"], cfg["noc"]) != (64, 8, "ideal"):
        raise AssertionError(f"baseline config {cfg}")
    streams, results, worst = {}, {}, 0.0
    t0 = time.perf_counter()
    for cell in rep["cells"]:
        key = (cell["shards"], cell["mix"])
        if key not in streams:
            streams[key] = ServingMix(tuple(cell["mix"].split("+")),
                                      name=cell["mix"]).make_stream(
                n_shards=cell["shards"], rounds=cell["rounds"],
                seed=cfg["seed"])
        st = streams[key]
        ck = key + (cell["policy"], cell["slots"])
        res = serve_stream(cell["policy"], st.batched(cell["slots"]),
                           device=device)
        results[ck] = res
        if st.n_requests != cell["requests"]:
            raise AssertionError(f"(b) {ck}: {st.n_requests} requests")
        for f in SERVE_COUNTERS:
            if getattr(res, f) != cell[f]:
                raise AssertionError(f"(b) {ck}: {f} {getattr(res, f)} != "
                                     f"{cell[f]}")
        for f in SERVE_FLOATS:
            g, w = getattr(res, f), cell[f]
            rel = abs(g - w) / abs(w) if w else abs(g)
            if rel > 1e-12:
                raise AssertionError(f"(b) {ck}: {f} {g} vs {w} (rel {rel})")
            worst = max(worst, rel)
    torch.cuda.synchronize()
    b_s = time.perf_counter() - t0
    log(f"(b) all {len(rep['cells'])} cells of {BASELINE.name} reproduced on "
        f"the card: counters exact, max rel err {worst:.3g} ({b_s:.2f} s)")

    # (c) the plain probe backend gives the same results, bit for bit
    for ck in TORCH_PROBE_CELLS:
        st = streams[ck[:2]]
        res = serve_stream(ck[2], st.batched(ck[3]),
                           ServingConfig(probe_backend="torch"),
                           device=device)
        if not same_serve_result(res, results[ck]):
            raise AssertionError(f"(c) {ck}: cuda and torch probe backends "
                                 "disagree")
    log(f"(c) probe_backend='torch' bit-equal to 'cuda' on "
        f"{len(TORCH_PROBE_CELLS)} baseline cells")

    # (d) NoC pricing conserves flits and leaves the counters alone
    for noc in ("crossbar", "ring"):
        for policy in SERVING_POLICIES:
            res = serve_stream(policy, stream.batched(2),
                               ServingConfig(noc=noc), device=device)
            check(res, ref.run_stream(policy, ref.AtaCacheConfig(), stream),
                  f"(d) {policy} {noc}")
            if res.noc_injected != res.noc_delivered + res.noc_queued:
                raise AssertionError(f"(d) {policy} {noc}: injected "
                                     f"{res.noc_injected} != delivered + "
                                     "queued")
            if policy != "private" and res.noc_injected <= 0:
                raise AssertionError(f"(d) {policy} {noc}: no traffic")
    log("(d) crossbar and ring: injected == delivered + queued, counters "
        "== oracle, every policy")
    return {"a_replays": n_a, "b_cells": len(rep["cells"]),
            "b_max_rel_err": worst, "b_s": b_s}


# ---------------------------------------------------------------------------
# phase 6: the serving main path at scale
# ---------------------------------------------------------------------------
SCALE_SHARDS = 16
SCALE_MIX = ("chat", "rag")
SCALE_REQUESTS = 1_000_000      # fig_serving_scale.DEFAULT_REQUESTS
SCALE_SLOTS = 4
#: rounds of the scale stream; None: calibrated as fig_serving_scale.py
#: does, so the stream carries at least SCALE_REQUESTS requests
SCALE_ROUNDS = None


def scale_rounds(mix) -> int:
    """fig_serving_scale._rounds_for, then rounded up to a multiple of B."""
    calib = 2048
    probe = mix.make_stream(n_shards=SCALE_SHARDS, rounds=calib, seed=0)
    occupancy = max(probe.n_requests / (calib * SCALE_SHARDS), 1e-3)
    r = math.ceil(1.02 * SCALE_REQUESTS / (occupancy * SCALE_SHARDS))
    return r + -r % SCALE_SLOTS


def phase_serving_scale(device) -> dict:
    import torch
    from repro_torch.core.trace.serving import ServingMix
    from repro_torch.kernels import ata_probe_rank as kmod
    from repro_torch.kernels import ata_tag_probe as tmod
    from repro_torch.serving import serve_stream

    mix = ServingMix(SCALE_MIX, name="+".join(SCALE_MIX))
    t0 = time.perf_counter()
    rounds = SCALE_ROUNDS or scale_rounds(mix)
    stream = mix.make_stream(n_shards=SCALE_SHARDS, rounds=rounds,
                             seed=0).batched(SCALE_SLOTS)
    gen_s = time.perf_counter() - t0
    T, C, K = stream.hashes.shape
    log(f"scale stream: {SCALE_SHARDS} shards, {mix.mix_id}, {T} sub-rounds"
        f" (B={SCALE_SLOTS}), {stream.n_requests} requests, K={K}, "
        f"{stream.hashes.nbytes} B of hashes ({gen_s:.2f} s to generate)")

    kmod.launches = tmod.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = serve_stream("ata", stream, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ata_tag_probe": tmod.launches,
                "ata_probe_rank": kmod.launches}

    if launches["ata_tag_probe"] != T or launches["ata_probe_rank"] != 0:
        raise AssertionError(f"launches {launches}, want ata_tag_probe == "
                             f"{T} sub-rounds and no ata_probe_rank")
    total = int(stream.n_blocks[stream.valid].sum())
    served = res.local_hits + res.remote_hits + res.recomputed_blocks
    if served != total or res.n_requests != stream.n_requests:
        raise AssertionError(f"block conservation: {served} != {total}")
    if not np.isfinite(res.latency).all() or res.remote_hits <= 0:
        raise AssertionError("scale replay: non-finite latency or no reuse")
    out = {"shards": SCALE_SHARDS, "mix": mix.mix_id, "slots": SCALE_SLOTS,
           "sub_rounds": T, "requests": stream.n_requests, "K": K,
           "hash_bytes": stream.hashes.nbytes, "gen_s": gen_s,
           "wall_s": wall, "requests_per_s": stream.n_requests / wall,
           "wall_ms_per_sub_round": wall * 1e3 / T, "launches": launches,
           "hit_rate": res.hit_rate, "local_hits": res.local_hits,
           "remote_hits": res.remote_hits,
           "recomputed_blocks": res.recomputed_blocks,
           "p50_latency": res.p50_latency, "p99_latency": res.p99_latency,
           "requests_per_kcycle": res.requests_per_kcycle,
           "load_imbalance": res.load_imbalance}
    log(f"ata replay: {wall:.2f} s wall, {out['requests_per_s']:.1f} "
        f"requests/s, {out['wall_ms_per_sub_round']:.4f} ms per sub-round; "
        f"ata_tag_probe launched {launches['ata_tag_probe']} times "
        f"(= {T} sub-rounds); hit rate {res.hit_rate:.6f}, blocks "
        f"{res.local_hits}/{res.remote_hits}/{res.recomputed_blocks} "
        f"local/remote/recomputed (sum {served} = all valid blocks)")
    out["profile"] = profile_sub_rounds(stream, device)
    return out


def profile_sub_rounds(stream, device, rows: int = 64) -> dict:
    """Where a sub-round's time goes: ``ata`` on the first ``rows``
    sub-rounds of the scale stream under torch.profiler — host wall per
    sub-round, device busy time (sum of kernel self times), kernel
    launches per sub-round, and the kernels that take the most device
    time."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import serve_stream
    part = dataclasses.replace(
        stream, valid=stream.valid[:rows], hashes=stream.hashes[:rows],
        n_blocks=stream.n_blocks[:rows], tenant=stream.tenant[:rows])
    serve_stream("ata", part, device=device)                # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_stream("ata", part, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = []
    for ev in prof.key_averages():
        dev = ev.self_device_time_total
        if dev > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel.append((dev, ev.count, ev.key))
    busy_us = sum(d for d, _, _ in per_kernel)
    launches = sum(c for _, c, _ in per_kernel)
    out = {"sub_rounds": rows,
           "wall_ms_per_sub_round": wall * 1e3 / rows,
           "device_busy_ms_per_sub_round": busy_us / 1e3 / rows,
           "device_busy_share": busy_us / 1e6 / wall,
           "kernel_launches_per_sub_round": launches / rows,
           "top_kernels_ms_per_sub_round": [
               (k[:90], d / 1e3 / rows, c / rows)
               for d, c, k in sorted(per_kernel, reverse=True)[:10]]}
    log(f"serving sub-round, {rows} sub-rounds under the profiler: "
        f"{out['wall_ms_per_sub_round']:.3f} ms wall per sub-round, device "
        f"busy {out['device_busy_ms_per_sub_round']:.4f} ms "
        f"({100 * out['device_busy_share']:.1f}%), "
        f"{out['kernel_launches_per_sub_round']:.1f} kernel launches per "
        "sub-round")
    for k, ms, c in out["top_kernels_ms_per_sub_round"]:
        log(f"  {ms:.5f} ms/sub-round  x{c:.1f}  {k}")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    device = torch.device("cuda")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    phases, report = {}, {"card": card}
    for name, fn in (("build", phase_build),
                     ("kernels", lambda: phase_kernels(device)),
                     ("tag_probe", lambda: phase_tag_probe(device)),
                     ("goldens", lambda: phase_goldens(device)),
                     ("suite", lambda: phase_suite(device)),
                     ("serving_exact", lambda: phase_serving_exact(device)),
                     ("serving_scale", lambda: phase_serving_scale(device))):
        t0 = time.perf_counter()
        report[name] = fn()
        phases[name] = time.perf_counter() - t0
        log(f"phase {name}: {phases[name]:.2f} s")
    report["phase_s"] = phases

    t = report["kernels"]["timings"]["P46_R120"]
    kernels = [{
        "name": "ata_probe_rank", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ata_probe_rank.cu",
        "replaces": "src/repro/kernels/ata_probe_rank.py:54",
        "launches": report["suite"]["launches"],
        "max_abs_err": report["kernels"]["max_abs_err"],
        "ms": t["device_ms"] if t["device_ms"] is not None else t["call_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
    }]
    t = report["tag_probe"]["timing"]
    kernels.append({
        "name": "ata_tag_probe", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ata_tag_probe.cu",
        "replaces": "src/repro/kernels/ata_tag_probe.py:32",
        "launches": report["serving_scale"]["launches"]["ata_tag_probe"],
        "max_abs_err": report["tag_probe"]["max_abs_err"],
        "ms": t["device_ms"] if t["device_ms"] is not None else t["call_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
    })
    REPORT.parent.mkdir(exist_ok=True)
    REPORT.write_text(json.dumps(report, indent=1, default=str) + "\n")
    log(json.dumps({"phase_s": phases}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
