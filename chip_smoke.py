#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero with no
result line):

1. the card's name and power limit; build every kernel from ``csrc/``;
2. each kernel against its plain PyTorch version on the card, bit for
   bit, at the main path's shapes and harder ones, plus its timings;
3. the 8 pre-refactor goldens (cfd/HS3D x 4 paper architectures,
   192 rounds, kernel 1) through ``simulate`` on the card;
4. the main path: ``run_suite()`` over all 10 apps x 53 kernels x
   4 paper architectures at 1536 rounds on the paper geometry, with the
   launch counters zeroed just before and read just after; Fig. 8
   normalized IPC and geomean gains; ``ata`` again on the plain
   ``torch`` probe backend, which must give bit-equal results; kernel 0
   of every app against the stored reference results;
5. the per-phase times, the card line again, a ``kernels`` JSON line,
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
KERNELS = ("ata_probe_rank",)


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
                     ("goldens", lambda: phase_goldens(device)),
                     ("suite", lambda: phase_suite(device))):
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
