#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (a phase that fails is reported and the others still run; the
script then exits non-zero with no result line):

1. the card's name and power limit; build every kernel from ``csrc/``
   (four), one ``nvcc`` per source, all started together; the count of
   ``wgmma`` (HGMMA) and TMA-load (UTMALDG) instructions in the built
   ``flash_attention`` library, where the toolkit has ``cuobjdump``;
2. each kernel against its plain PyTorch version on the card, at its main
   path's shapes and harder ones, plus its timings: the two probes bit
   for bit (``ata_probe_rank`` also at 200 points, R up to 4096, 8192
   caches and all requests at one port; ``ata_tag_probe`` also on the
   serving engine's strided directory lane, sets outside [0, S)
   included), beside the launch floor (a one-element ``fill_``);
   ``flash_attention`` and ``wkv6`` within a tolerance stated per
   dtype (the LM prefill and decode shapes, a window, odd T, f32,
   ``kv_len=0`` rows, K != V, chained halves, w=-20; ``wkv6``'s 64
   chained one-step calls equal to one call bit for bit), beside
   ``scaled_dot_product_attention``'s time, the f32 attention kernel's
   time and ``wkv6``'s time at T=1 (a decode step);
3. the 8 pre-refactor goldens (cfd/HS3D x 4 paper architectures,
   192 rounds, kernel 1) through ``simulate`` on the card;
4. the simulator's main path: ``run_suite()`` over all 10 apps x 53
   kernels x 4 paper architectures at 1536 rounds on the paper geometry,
   with the launch counters zeroed just before and read just after;
   Fig. 8 normalized IPC and geomean gains, and Fig. 9, Fig. 10 and
   Table I from the same results; ``ata`` again on the plain ``torch``
   probe backend, which must give bit-equal results; kernel 0 of every
   app against the stored reference results;
5. the contention-policy zoo: ``run_suite()`` over the same 53 kernels
   under ``ata_bypass``, ``ata_fifo``, ``ciao`` and ``victim``, launch
   counters zeroed just before and read just after; kernel 0 of every
   app against the stored reference results of the zoo; the 18
   ``ciao``/``victim`` cells of the committed sensitivity baseline
   (``benchmarks/baselines/sensitivity_rounds96.json``); the ``cuda`` and
   ``torch`` probe backends bit-equal for the three policies that reach
   the probe kernel, at cut rounds; the zoo table; a profile of the
   ``victim`` round loop;
6. the sweep grid, multi-tenant mixes and the sensitivity report: the
   report at the committed baseline's configuration (HS3D kernel 0, 96
   rounds; solo, mix and NoC sections, the mix section from one
   ``mix_grid_run``) gated by ``compare_reports`` against
   ``benchmarks/baselines/sensitivity_rounds96.json``, with its 45 solo
   cells also within rel 1e-6 of the baseline; every point of the
   report's solo and NoC passes, and the composed points of two of its
   mixes under ``ata`` and ``victim``, bit-equal to per-point
   ``simulate()`` (phase 5's simulations reused); the NoC section's
   ``ata``/``victim`` x ``crossbar``/``ring`` points against the
   reference fixture ``reference_noc_HS3D.json``; ``cfd+HS3D`` at 1536
   rounds under ``private`` and ``ata`` (``run_mixes``) against the
   reference fixture ``reference_mix_cfd_HS3D.json``. The report and the
   pair each have the launch counters zeroed just before and read just
   after, and must launch ``ata_probe_rank`` exactly as often as their
   passes owe (phases 4 and 5 are held to the same count);
7. serving exactness: the engine on the card against the port's numpy
   oracle at the reference's test sizes (every policy x B, and the
   sequential stream), all 24 cells of the committed serving baseline
   (``benchmarks/baselines/serving_rounds512.json``), the ``cuda`` and
   ``torch`` probe backends bit-equal, NoC flit conservation;
8. telemetry and observability (``telemetry=`` of ``simulate``,
   ``SweepGrid.run`` and ``serve_stream``; ``repro_torch.obs``): the
   telemetry capture's simulator point (``cfd`` kernel 0, ``ata`` on the
   crossbar, 96 rounds, window 32) and one ``SweepGrid.run`` of ``cfd``
   kernel 0 under ``ata`` and ``victim`` (one stacked pass) and
   ``remote`` at 1536 rounds, every windowed cumulative array against the
   reference fixture ``reference_telemetry.json`` and every result bit
   for bit against phases 4 and 5, conservation checked, the Perfetto
   trace validated; the committed
   ``benchmarks/baselines/telemetry_smoke_trace.json`` regenerated on the
   card event for event; one 512-round serving baseline cell with
   telemetry against the cell and phase 7's replay, its p50/p99 read from
   the histogram equal to ``np.percentile``; the sensitivity report of
   phase 6 carrying its ``manifest`` (the card, its power limit, the four
   kernel builds); the phase's launches counted from 0 (``ata_probe_rank``
   exactly 96 + 2 x 1536); an ``ata`` round with telemetry profiled
   beside phase 4's plain one;
9. the serving main path at ``fig_serving_scale.py``'s shape cut to a
   quarter of its depth: one 16-shard chat+rag stream of about 250,000
   requests replayed under ``ata`` at B=4, with the launch counters
   zeroed just before and read just after, and a profile of 64
   sub-rounds;
10. the LM inference path at full width (qwen3-0.6b and rwkv6-3b, weights
    made on the card from fixed seeds): prefill ``forward`` at B=1, T=4096
    on the "kernel" route, launch counters zeroed just before and read
    just after, held against the "ref" route;
11. LM decode: 64 teacher-forced ``decode_step`` calls against
    ``forward``, and a profiled decode step; for rwkv6 also against a
    forward whose WKV6 is exact (f64), with per-layer counts of the bf16
    WKV6 outputs that differ from the exact ones;
12. ``ModelServer`` at the reference launcher's defaults cut to half its
    requests (8 requests, 4 shards, block 16, 8 decode steps, ``ata``)
    for both models, launch
    counters zeroed just before and read just after: the directory's
    stats against ``run_workload``, and one request served cold and warm;
13. the per-phase times, the card line again, a ``kernels`` JSON line,
    and as the last line ``{"ok": true, "device": {...}}``.

Details go to ``chiprun_out/chip_smoke_report.json``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
import subprocess
import sys
import time
import traceback
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
KERNELS = ("ata_probe_rank", "ata_tag_probe", "flash_attention",
           "wkv6")


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
    sass = sass_counts(built["flash_attention"][0], ("HGMMA", "UTMALDG"))
    log(f"flash_attention SASS: {sass} (wgmma and TMA-load instructions; "
        "None where the toolkit has no cuobjdump)")
    return {"build_s": secs, "flash_attention_sass": sass}


def sass_counts(lib, opcodes) -> dict:
    """How many times each opcode appears in the library's SASS, from
    cuobjdump where the toolkit has it (else None)."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True, timeout=120).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return {op: sass.count(op) for op in opcodes}


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version on the card
# ---------------------------------------------------------------------------
def probe_rank_inputs(P, R, seed, device, C=30, S=8, W=64, G=10,
                      one_port=False):
    """Paper-geometry inputs with planted same-set duplicates, dirty
    sources and denied lanes. With ``one_port`` every request misses its
    own row and hits one clean copy in cache 2: all R of a point queue
    at one port in arrival order."""
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
    deny = rng.random((P, R)) < 0.2
    if one_port:
        tags[:, :G] = 0
        qtag[:] = 7
        tags[:, 2, :, W - 3] = 7
        valid[:, 2, :, W - 3] = True
        dirty[:, 2] = False
        core = rng.integers(0, G, (P, R)).astype(np.int32)
        core[core == 2] = 3
        deny[:] = False
    cbase = (core // G) * G
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
    """Mean device time per call of ``fn`` spent in the kernels whose
    names hold ``name`` (torch.profiler); None when the profiler shows no
    device time."""
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
    return total / n / 1e3      # us -> ms


def launch_floor_ms(device) -> float:
    """Device time of a one-element ``torch.fill_``: what any launch
    costs on the device, the floor under a launch-sized kernel."""
    import torch
    x = torch.zeros(1, dtype=torch.int32, device=device)
    return kernel_device_ms(lambda: x.fill_(1), "FillFunctor")


def device_kernels(prof) -> list:
    """(device us, launches, name) of every kernel a profile saw."""
    import torch
    return [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.self_device_time_total > 0
            and ev.device_type == torch.autograd.DeviceType.CUDA]


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
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    worst = 0
    cases = []
    # (P, R, C, S, W, one_port): the main path's points and batches, more
    # points than SMs, R from 1 to 4096, 8192 caches (the limit), every
    # request of a point at one port, and W = 63 (the kernel's path for W
    # not a multiple of 8)
    shapes = [(P, R, 30, 8, 64, False) for P in (1, 53)
              for R in (60, 120, 150, 1500)]
    shapes += [(200, R, 30, 8, 64, False) for R in (1, 33, 4096)]
    shapes += [(200, 4096, 30, 8, 64, True), (2, 4096, 8192, 2, 8, False),
               (3, 1500, 8192, 2, 8, True), (5, 77, 30, 8, 63, False)]
    for P, R, C, S, W, one_port in shapes:
        args = probe_rank_inputs(P, R, seed=P * 10007 + R, device=device,
                                 C=C, S=S, W=W, one_port=one_port)
        got = kmod.ata_probe_rank(*args, cluster_size=10)
        want = kmod.ata_probe_rank_plain(*args, cluster_size=10)
        torch.cuda.synchronize()
        where = f"ata_probe_rank P={P} R={R} C={C} S={S} W={W}" + (
            " one port" if one_port else "")
        for name, g, w in zip(("local_hit", "hit_way", "remote_ok",
                               "src_cache", "prank", "psize"), got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"{where}: {name} differs from the "
                                     "plain version")
            worst = max(worst, int((g.long() - w.long()).abs().max()))
        hits = int(want[0].sum()) + int(want[2].sum())
        cases.append({"P": P, "R": R, "C": C, "S": S, "W": W,
                      "one_port": one_port,
                      "cluster_blocks": kmod.cluster_blocks(P, R, sms),
                      "local_hits": int(want[0].sum()),
                      "remote_ok": int(want[2].sum())})
        if one_port and not (bool(want[2].all()) and torch.equal(
                got[4][0], torch.arange(R, dtype=torch.int32,
                                        device=device))):
            raise AssertionError(f"{where}: not one queue 0 .. R - 1")
        if hits == 0 and R > 1:
            raise AssertionError(f"{where}: inputs exercise nothing")
    log(f"ata_probe_rank == plain on the card for {len(cases)} shapes "
        f"(max abs err {worst})")
    floor = launch_floor_ms(device)
    log(f"launch floor (one-element fill_): {floor} ms on the device")

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
                 bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops,
                 launch_floor_ms=floor,
                 cluster_blocks=kmod.cluster_blocks(P, R, sms))
        timings[f"P{P}_R{R}"] = t
        log(f"ata_probe_rank P={P} R={R} ({t['cluster_blocks']} CTAs per "
            f"point): kernel {t['device_ms']} ms on the device (launch floor"
            f" {floor} ms), {t['call_ms']:.5f} ms per call; plain {plain_ms}"
            f" ms; bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, {ops} "
            "compares)")
    return {"max_abs_err": worst, "cases": cases, "timings": timings,
            "launch_floor_ms": floor}


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


def directory_lane(C, S, W, R, seed, device):
    """The serving engine's packed directory (C * S + 1, W, 2) int32 of
    [tag, LRU key] lanes (empty ways tag 0) and requests against it: its
    tag lane ``dir[:C * S, :, 0]`` as a strided (C, S, W) view, sets
    (two outside [0, S)), tags (most present somewhere, some not, some
    0), and ``valid = lane != 0`` as the engine passes it."""
    import torch
    rng = np.random.default_rng(seed)
    d = np.zeros((C * S + 1, W, 2), np.int32)
    d[..., 0] = rng.integers(1, 3 * W + 2, (C * S + 1, W))
    d[..., 0][rng.random((C * S + 1, W)) < 0.3] = 0
    d[..., 1] = rng.integers(W, 50 * W, (C * S + 1, W))
    set_idx = rng.integers(0, S, R).astype(np.int32)
    qtag = d[rng.integers(0, C, R) * S + set_idx, rng.integers(0, W, R), 0]
    qtag[::4] = rng.integers(0, 3 * W + 2, len(qtag[::4]))
    qtag[::9] = 0
    set_idx[[0, R // 2]] = (-1, S)
    lane = torch.from_numpy(d).to(device)[:C * S, :, 0].view(C, S, W)
    return [torch.from_numpy(set_idx).to(device),
            torch.from_numpy(qtag).to(device), lane, lane != 0]


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
    # the engine's strided directory lane, read in place, against the
    # plain version on its contiguous copy; sets outside [0, S) miss; W =
    # 96 takes the kernel's path for W > 64
    for W in (6, 8, 64, 96):
        C, K, S = 16, 18, 64
        set_idx, qtag, lane, valid = directory_lane(C, S, W, C * K, W,
                                                    device)
        got = tmod.ata_tag_probe(set_idx, qtag, lane, valid)
        inr = (set_idx >= 0) & (set_idx < S)
        want = tmod.ata_tag_probe_plain(set_idx[inr], qtag[inr],
                                        lane.contiguous(), valid)
        torch.cuda.synchronize()
        for name, g, w in zip(("hits", "ways"), got, want):
            if g.dtype != w.dtype or not torch.equal(g[inr], w):
                raise AssertionError(f"ata_tag_probe on the directory lane "
                                     f"W={W}: {name} differs from plain")
            if g[~inr].any():
                raise AssertionError(f"ata_tag_probe W={W}: a set outside "
                                     "[0, S) reported a hit or a way")
        n_hits = int(want[0].sum())
        if not 0 < n_hits < want[0].numel():
            raise AssertionError(f"directory lane W={W}: inputs exercise "
                                 "nothing")
        cases.append({"R": C * K, "C": C, "S": S, "W": W, "hits": n_hits,
                      "layout": "directory lane, stride "
                                f"{tuple(lane.stride())}",
                      "sets_outside": int((~inr).sum())})
    log(f"ata_tag_probe == plain on the card for {len(cases)} shapes, the "
        f"engine's strided directory lane at W in (6, 8, 64, 96) among them"
        f" (max abs err {worst})")
    floor = launch_floor_ms(device)

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
    # the same shape as the engine passes it: the strided directory lane
    lane_args = directory_lane(C, 64, 8, C * K, 7, device)
    t["lane_device_ms"] = kernel_device_ms(
        lambda: tmod.ata_tag_probe(*lane_args), "ata_tag_probe_kernel")
    t.update(plain_ms=sum(plain_ms) / 2, plain_ms_runs=plain_ms,
             bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops,
             launch_floor_ms=floor)
    log(f"ata_tag_probe C={C} K={K} (R={C * K}): kernel {t['device_ms']} ms"
        f" on the device ({t['lane_device_ms']} ms on the directory lane; "
        f"launch floor {floor} ms), {t['call_ms']:.5f} / "
        f"{t['call_ms_2']:.5f} ms per call; plain {plain_ms} ms; bound "
        f"{bound_ms:.7f} ms ({bound_by}: {nbytes} B, {ops} compares)")
    return {"max_abs_err": worst, "cases": cases, "timing": t,
            "launch_floor_ms": floor}


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
# grid runs and the launches they owe
# ---------------------------------------------------------------------------
#: the policies whose L1 stage launches ``ata_probe_rank`` once a round
PROBING_ARCHS = ("ata", "ata_bypass", "ata_fifo", "victim")


@contextlib.contextmanager
def recorded_grid_runs():
    """Records (points, results) of every ``SweepGrid.run`` made inside
    the block, in order. An instrument of the checks: it launches
    nothing and counts nothing."""
    from repro_torch.core import sweep
    runs, orig = [], sweep.SweepGrid.run

    def run(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        runs.append((list(self.points), out.results))
        return out

    sweep.SweepGrid.run = run
    try:
        yield runs
    finally:
        sweep.SweepGrid.run = orig


def probe_launches_due(runs, device) -> int:
    """The ``ata_probe_rank`` launches that these grid runs owe: within a
    run, every batched pass launches the kernel once a round for each
    probing architecture among its points (each member of a stacked
    family runs its L1 stage on its own run of the pass's points). A
    pass is one (architecture family, NoC family, geometry structure,
    trace kind, probe backend); a trace kind fixes the rounds."""
    from repro_torch.core import get_noc, trace_kind
    from repro_torch.core.geometry import geom_structure
    from repro_torch.core.probe import resolve_probe_backend
    due = 0
    for points, _ in runs:
        member_passes = {
            (p.arch, get_noc(p.noc).stack_key, geom_structure(p.geom),
             trace_kind(p.trace))
            for p in points if p.arch in PROBING_ARCHS
            and resolve_probe_backend(p.probe_backend, device) == "cuda"}
        due += sum(kind[0][0] for *_, kind in member_passes)
    return due


def check_launches(got: int, runs, device, where: str) -> int:
    """``got`` launches counted from 0 over ``runs`` must be exactly what
    the runs owe, and at least one."""
    due = probe_launches_due(runs, device)
    if got != due or got < 1:
        raise AssertionError(f"{where}: ata_probe_rank launched {got} "
                             f"times, the grid runs owe {due}")
    return got


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
def phase_suite(device) -> dict:
    import torch
    from repro_torch.core import (APPS, HIGH_LOCALITY, LOW_LOCALITY,
                                  PAPER_ARCHITECTURES, app_traces, geomean,
                                  normalized_ipc, run_suite)
    from repro_torch.core import figures
    from repro_torch.kernels import ata_probe_rank as kmod

    t0 = time.perf_counter()
    n_traces = sum(len(app_traces(app)) for app in APPS)
    traces_s = time.perf_counter() - t0
    log(f"trace generation for the suite ({n_traces} kernels): "
        f"{traces_s:.3f} s (part of each run_suite call below)")

    suite, wall = {}, {}
    with recorded_grid_runs() as runs:
        kmod.launches = 0
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
    # ata: one pass for the m=2 apps and one for the m=4 apps
    check_launches(launches, runs, device, "paper suite")
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
    # Fig. 9, Fig. 10 and Table I from the same results: no extra
    # simulation
    rows = {"fig9": figures.fig9(suite), "fig10": figures.fig10(suite),
            "table1": figures.table1(suite)}
    log_rows("Fig. 9 per-kernel IPC vs private", rows["fig9"])
    log_rows("Fig. 10 L1 latency vs private", rows["fig10"])
    log_rows("Table I (high-locality apps)", rows["table1"])
    _SUITE.update(suite)

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
    _PROFILES["ata"] = profiled
    return {"launches": launches, "wall_s": wall, "traces_s": traces_s,
            "profile": profiled,
            "normalized_ipc": ipc, "ata_gain_high": hi, "ata_gain_low": lo,
            "fixture_max_rel_err": worst, "figures": rows}


#: the paper suite of phase 4, for the zoo table of phase 5
_SUITE = {}
#: the round-loop profile of phase 4 (``ata``), beside which the
#: telemetry phase puts its own
_PROFILES = {}


def log_rows(title, rows) -> None:
    """Figure rows (name, derived), several to a line."""
    log(f"{title}:")
    for i in range(0, len(rows), 6):
        log("  " + "  ".join(f"{n}={d}" for n, d in rows[i:i + 6]))


def profile_round_loop(device, rounds: int = 64, arch="ata",
                       telemetry=None) -> dict:
    """Where a round's time goes: ``arch`` on the 46-kernel m=4 batch for
    ``rounds`` rounds under torch.profiler — host wall per round, device
    busy time per round (sum of kernel self times), kernel launches per
    round, and the kernels that take the most device time. ``arch`` is
    one architecture (a plain batch) or a tuple of one stacking family's
    members (one stacked ``SweepGrid`` pass over every trace under
    each, with ``telemetry`` if given)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import APPS, SweepGrid, app_traces, simulate_batch
    traces = [t for app in APPS if APPS[app].m == 4
              for t in app_traces(app, rounds=rounds)]
    if isinstance(arch, str):
        def run():
            return simulate_batch(arch, traces, device=device)
    else:
        grid = SweepGrid(arch, None, traces)

        def run():
            return grid.run(device=device, telemetry=telemetry).results
    points = len(run())                                     # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = device_kernels(prof)
    busy_us = sum(d for d, _, _ in per_kernel)
    launches = sum(c for _, c, _ in per_kernel)
    out = {"arch": arch, "points": points, "rounds": rounds,
           "telemetry": telemetry is not None,
           "wall_ms_per_round": wall * 1e3 / rounds,
           "device_busy_ms_per_round": busy_us / 1e3 / rounds,
           "device_busy_share": busy_us / 1e6 / wall,
           "kernel_launches_per_round": launches / rounds,
           "top_kernels_ms_per_round": [
               (k[:90], d / 1e3 / rounds, c / rounds)
               for d, c, k in sorted(per_kernel, reverse=True)[:8]]}
    log(f"{arch} round loop{' with telemetry' if telemetry else ''}, "
        f"P={points}: "
        f"{out['wall_ms_per_round']:.3f} ms"
        f" wall per round, device busy {out['device_busy_ms_per_round']:.4f}"
        f" ms ({100 * out['device_busy_share']:.1f}%), "
        f"{out['kernel_launches_per_round']:.1f} kernel launches per round")
    for k, ms, c in out["top_kernels_ms_per_round"]:
        log(f"  {ms:.4f} ms/round  x{c:.1f}  {k}")
    return out


# ---------------------------------------------------------------------------
# phase 5: the contention-policy zoo
# ---------------------------------------------------------------------------
ZOO_ARCHITECTURES = ("ata_bypass", "ata_fifo", "ciao", "victim")
SENSITIVITY = ROOT / "benchmarks" / "baselines" / "sensitivity_rounds96.json"
SENSITIVITY_METRICS = ("ipc", "l1_hit_rate", "remote_hit_rate", "noc_flits",
                       "l1_latency")
ZOO_BACKEND_ROUNDS = 256     # cut rounds of the probe-backend comparison
#: phase 5's per-point simulate() of the sensitivity baseline's zoo
#: points, {(arch, geometry, noc): SimResult}, reused by phase 6
_ZOO_MEMO = {}
#: the zoo suite of phase 5, for the telemetry phase
_ZOO_SUITE = {}


def phase_zoo(device) -> dict:
    import dataclasses
    import torch
    from repro_torch.core import PAPER_GEOMETRY, APPS, make_trace, run_suite
    from repro_torch.core import figures, simulate
    from repro_torch.kernels import ata_probe_rank as kmod

    suite, wall = {}, {}
    with recorded_grid_runs() as runs:
        kmod.launches = 0
        for arch in ZOO_ARCHITECTURES:
            t0 = time.perf_counter()
            part = run_suite(archs=(arch,), device=device)
            torch.cuda.synchronize()
            wall[arch] = time.perf_counter() - t0
            for app, cells in part.items():
                suite.setdefault(app, {}).update(cells)
        launches = kmod.launches
    n_kernels = sum(len(c["victim"].per_kernel) for c in suite.values())
    if n_kernels != 53 or len(suite) != 10:
        raise AssertionError(f"zoo suite has {len(suite)} apps, {n_kernels}"
                             " kernels")
    # ata_bypass, ata_fifo and victim probe through the kernel; ciao not
    check_launches(launches, runs, device, "zoo suite")
    for app, cells in suite.items():
        for arch, res in cells.items():
            for r in res.per_kernel:
                vals = [v for k, v in r._asdict().items()
                        if k not in ("per_app", "noc")]
                if not all(math.isfinite(v) for v in vals) or r.ipc <= 0:
                    raise AssertionError(f"{app}/{arch}: non-finite {r}")
    for arch, sec in wall.items():
        log(f"zoo suite wall time {arch}: {sec:.3f} s")
    log(f"ata_probe_rank launches over the zoo suite: {launches}")

    # kernel 0 of every app against the stored reference results
    with open(SRC / "repro_torch" / "data" /
              "reference_zoo_kernel0.json") as f:
        ref = json.load(f)["results"]
    worst = 0.0
    for app, cells in suite.items():
        for arch, res in cells.items():
            worst = max(worst, max_rel_err(result_dict(res.per_kernel[0]),
                                           ref[app][arch],
                                           f"zoo fixture {app}/{arch}"))
    log(f"kernel 0 of 10 apps x 4 zoo policies match the reference fixture "
        f"(max rel err {worst:.3g})")

    # the 18 ciao/victim cells of the committed sensitivity baseline
    with open(SENSITIVITY) as f:
        base = json.load(f)
    cfg = base["config"]
    trace = make_trace(dataclasses.replace(APPS[cfg["app"]],
                                           rounds=cfg["rounds"]), kernel=0)
    t0 = time.perf_counter()
    n_cells, sens_worst, memo = 0, 0.0, _ZOO_MEMO
    for c in base["cells"]:
        if c["arch"] not in ZOO_ARCHITECTURES:
            continue
        geom = dataclasses.replace(PAPER_GEOMETRY, **{c["knob"]: c["value"]})
        key = (c["arch"], geom, "ideal")
        if key not in memo:
            memo[key] = simulate(c["arch"], trace, geom, device=device)
        r = memo[key]
        got = {m: float(getattr(r, m)) for m in SENSITIVITY_METRICS}
        want = {m: c[m] for m in SENSITIVITY_METRICS}
        sens_worst = max(sens_worst, max_rel_err(
            got, want, f"sensitivity {c['arch']} {c['knob']}={c['value']}"))
        n_cells += 1
    if n_cells != 18:
        raise AssertionError(f"{n_cells} zoo cells in the sensitivity "
                             "baseline, want 18")
    sens_s = time.perf_counter() - t0
    log(f"18 ciao/victim cells of {SENSITIVITY.name} hold on the card (max "
        f"rel err {sens_worst:.3g}; {len(memo)} simulations, {sens_s:.2f} s)")

    # both probe backends bit-equal for the policies that reach the kernel
    t0 = time.perf_counter()
    for arch in ("ata_bypass", "ata_fifo", "victim"):
        a = run_suite(archs=(arch,), rounds=ZOO_BACKEND_ROUNDS,
                      probe_backend="cuda", device=device)
        b = run_suite(archs=(arch,), rounds=ZOO_BACKEND_ROUNDS,
                      probe_backend="torch", device=device)
        for app in a:
            if ([tuple(r) for r in a[app][arch].per_kernel]
                    != [tuple(r) for r in b[app][arch].per_kernel]):
                raise AssertionError(f"{arch} {app}: cuda and torch probe "
                                     "backends disagree")
    backends_s = time.perf_counter() - t0
    log(f"ata_bypass, ata_fifo, victim: cuda and torch probe backends "
        f"bit-equal over 53 kernels at {ZOO_BACKEND_ROUNDS} rounds "
        f"({backends_s:.2f} s)")
    _ZOO_SUITE.update(suite)

    if not _SUITE:
        raise AssertionError("the zoo table needs the paper suite of "
                             "phase 'suite'")
    table = figures.zoo_table({app: {**_SUITE[app], **suite[app]}
                               for app in suite})
    log_rows("zoo table (geomean IPC vs private, mean L1 hit rate, NoC "
             "flits over 53 kernels)", table)
    profiled = profile_round_loop(device, arch="victim")
    return {"launches": launches, "wall_s": wall, "fixture_max_rel_err": worst,
            "sensitivity_max_rel_err": sens_worst, "sensitivity_s": sens_s,
            "backends_s": backends_s, "zoo_table": table,
            "profile_victim": profiled}


# ---------------------------------------------------------------------------
# phase 6: the sweep grid, multi-tenant mixes and the sensitivity report
# ---------------------------------------------------------------------------
MIX_FIXTURE = SRC / "repro_torch" / "data" / "reference_mix_cfd_HS3D.json"
NOC_FIXTURE = SRC / "repro_torch" / "data" / "reference_noc_HS3D.json"
SOLO_EXECUTABLES = 9         # the baseline's solo passes: 3 families x 3
#                              l1_ways structures
#: mixes of the report's mix section whose composed points under ``ata``
#: and ``victim`` are held against per-point simulate(): a two-app and
#: the three-app trace kind
CHECKED_MIXES = (("cfd", "HS3D"), ("cfd", "b+tree", "HS3D"))
#: the sensitivity report of phase 6, for the telemetry phase
_SWEEP_REPORT = {}


def same_results(got, want, where: str) -> None:
    """SimResults equal bit for bit, field by field (NaN where NaN)."""
    g, w = result_dict(got), result_dict(want)
    if json.dumps(g, sort_keys=True) != json.dumps(w, sort_keys=True):
        diff = sorted(k for k in w if g[k] != w[k])
        raise AssertionError(f"{where}: stacked != per-point in {diff}")


def phase_sweep(device) -> dict:
    import dataclasses
    import torch
    from repro_torch.core import (APPS, PAPER_NOCS, WorkloadMix,
                                  make_trace, run_mixes, simulate)
    from repro_torch.core import figures, report as sens
    from repro_torch.kernels import ata_probe_rank as kmod

    with open(SENSITIVITY) as f:
        base = json.load(f)
    cfg = base["config"]

    # 1. the whole report at the baseline's configuration, gated; its
    # launches counted from 0 just before and read just after
    with recorded_grid_runs() as runs:
        kmod.launches = 0
        t0 = time.perf_counter()
        mix_run = sens.mix_grid_run(rounds=cfg["rounds"], device=device)
        rep = sens.run_sensitivity(
            rounds=cfg["rounds"], kernels_per_app=1,
            mix_pairings=sens.MIX_PAIRINGS, mix_run=mix_run,
            noc_models=PAPER_NOCS, device=device)
        torch.cuda.synchronize()
        report_s = time.perf_counter() - t0
        report_launches = kmod.launches
    if len(runs) != 3:
        raise AssertionError(f"the report made {len(runs)} grid runs, want "
                             "3 (mix, solo, noc)")
    section_runs = dict(zip(("mix", "solo", "noc"), runs))
    due = {name: probe_launches_due([r], device)
           for name, r in section_runs.items()}
    check_launches(report_launches, runs, device, "sensitivity report")
    sections = {name: sec["sweep"] for name, sec in
                (("solo", rep), ("mix", rep["mix"]), ("noc", rep["noc"]))}
    for name, sw in sections.items():
        log(f"report {name}: {sw['n_points']} points, {sw['n_executables']}"
            f" executables, {sw['wall_s']:.3f} s, {due[name]} "
            "ata_probe_rank launches")
    failures = sens.compare_reports(base, rep)
    if failures:
        raise AssertionError(f"compare_reports: {failures}")
    if rep["sweep"]["n_executables"] > SOLO_EXECUTABLES:
        raise AssertionError(f"solo executables {rep['sweep']} > "
                             f"{SOLO_EXECUTABLES}")
    got = {(c["arch"], c["knob"], c["value"]): c for c in rep["cells"]}
    worst = 0.0
    for c in base["cells"]:
        key = (c["arch"], c["knob"], c["value"])
        worst = max(worst, max_rel_err(
            {m: got[key][m] for m in SENSITIVITY_METRICS},
            {m: c[m] for m in SENSITIVITY_METRICS}, f"report cell {key}"))
    if len(base["cells"]) != 45 or rep["schema"] != 3:
        raise AssertionError(f"{len(base['cells'])} baseline cells, "
                             f"schema {rep['schema']}")
    log(f"sensitivity report (schema 3) gated against {SENSITIVITY.name}: "
        f"no failure; 45 solo cells within rel {worst:.3g} of the "
        f"baseline; {report_s:.2f} s; ata_probe_rank launched "
        f"{report_launches} times (= what its passes owe)")
    fairness = figures.mix_fairness(mix_run)
    log_rows("mix fairness at 96 rounds", fairness)

    # 2. the report's own passes against per-point simulate(), whole
    # SimResults bit for bit: every point of the solo and NoC sections
    # (phase 5's simulations reused) and the composed points of two
    # mixes under ata and victim
    t0 = time.perf_counter()
    trace = make_trace(dataclasses.replace(APPS[cfg["app"]],
                                           rounds=cfg["rounds"]), kernel=0)
    memo, n_new, n_checked = _ZOO_MEMO, 0, 0
    for name in ("solo", "noc"):
        points, results = section_runs[name]
        for p, r in zip(points, results):
            if not np.array_equal(p.trace.addr, trace.addr):
                raise AssertionError(f"{name}: a point off HS3D kernel 0")
            key = (p.arch, p.geom, p.noc)
            if key not in memo:
                memo[key] = simulate(p.arch, trace, p.geom, noc=p.noc,
                                     device=device)
                n_new += 1
            same_results(r, memo[key], f"{name} {p.arch}/{p.noc} "
                         f"l1_ways={p.geom.l1_ways} noc_bw={p.geom.noc_bw} "
                         f"hide={p.geom.hide}")
            n_checked += 1
    composed = {apps: WorkloadMix(apps=apps, rounds=cfg["rounds"]).compose(
        trace.n_cores) for apps in CHECKED_MIXES}
    checked = {(a, apps) for a in ("ata", "victim") for apps in composed}
    points, results = section_runs["mix"]
    for p, r in zip(points, results):
        for apps, tr in composed.items():
            if ((p.arch, apps) in checked and p.trace.n_apps == len(apps)
                    and np.array_equal(p.trace.addr, tr.addr)):
                same_results(r, simulate(p.arch, p.trace, p.geom,
                                         device=device),
                             f"mix {'+'.join(apps)}/{p.arch}")
                checked.discard((p.arch, apps))
    if checked:
        raise AssertionError(f"mix points not found: {sorted(checked)}")
    stacked_s = time.perf_counter() - t0
    log(f"the report's passes == per-point simulate() on the card, whole "
        f"SimResults bit for bit: {n_checked} solo and NoC points "
        f"({n_new} simulated here, the rest from phase zoo) and "
        f"{2 * len(CHECKED_MIXES)} composed mix points ({stacked_s:.2f} s)")

    # 3. the NoC section's crossbar and ring points of ata and victim
    # against the reference's per-point simulate()
    with open(NOC_FIXTURE) as f:
        noc_fix = json.load(f)
    points, results = section_runs["noc"]
    noc_worst, n_fix = 0.0, 0
    for p, r in zip(points, results):
        want = noc_fix["results"].get(p.arch, {}).get(p.noc, {}).get(
            repr(float(p.geom.noc_bw)))
        if want is not None:
            noc_worst = max(noc_worst, max_rel_err(
                result_dict(r), want,
                f"noc fixture {p.arch}/{p.noc}/noc_bw={p.geom.noc_bw}"))
            n_fix += 1
    want_n = sum(len(v) for by_noc in noc_fix["results"].values()
                 for v in by_noc.values())
    if n_fix != want_n:
        raise AssertionError(f"{n_fix} NoC points matched {NOC_FIXTURE.name}"
                             f", want {want_n}")
    log(f"{n_fix} crossbar/ring points of the report's NoC section match "
        f"{NOC_FIXTURE.name} (max rel err {noc_worst:.3g})")

    # 4. one pairing at full length against the reference fixture; its
    # launches counted from 0 just before and read just after
    with open(MIX_FIXTURE) as f:
        fixture = json.load(f)
    with recorded_grid_runs() as pair_runs:
        kmod.launches = 0
        t0 = time.perf_counter()
        pair = run_mixes([WorkloadMix(apps=tuple(fixture["apps"]))],
                         archs=tuple(fixture["results"]), device=device)
        torch.cuda.synchronize()
        pair_s = time.perf_counter() - t0
        pair_launches = kmod.launches
    check_launches(pair_launches, pair_runs, device, "cfd+HS3D pair")
    (mid, per_arch), = pair.results.items()
    pair_worst = 0.0
    for arch, mr in per_arch.items():
        want = fixture["results"][arch]
        pair_worst = max(
            pair_worst,
            max_rel_err(result_dict(mr.shared), want["shared"],
                        f"{mid}/{arch}/shared"),
            *(max_rel_err(result_dict(s), w, f"{mid}/{arch}/solo{i}")
              for i, (s, w) in enumerate(zip(mr.solo, want["solo"]))))
    ws = {a: mr.weighted_speedup for a, mr in per_arch.items()}
    unfair = {a: mr.unfairness for a, mr in per_arch.items()}
    ratio = ws["ata"] / ws["private"]
    log(f"{mid} at {fixture['rounds']} rounds ({pair.report.n_points} "
        f"points, {pair.report.n_executables} passes, {pair_s:.2f} s, "
        f"{pair_launches} ata_probe_rank launches) matches "
        f"{MIX_FIXTURE.name} (max rel err {pair_worst:.3g}): "
        f"weighted speedup private {ws['private']:.4f}, ata {ws['ata']:.4f};"
        f" unfairness private {unfair['private']:.4f}, ata "
        f"{unfair['ata']:.4f}; ata_vs_private {ratio:.4f}")

    _SWEEP_REPORT.update(rep)
    launches = report_launches + pair_launches
    log(f"ata_probe_rank launches on the sweep phase's main path (the "
        f"report and the pair): {launches}")
    # what a stacked round costs: ata and victim over the same 46 traces
    # in one pass, beside phases 4 and 5's single-policy profiles
    profiled = profile_round_loop(device, rounds=32, arch=("ata", "victim"))
    return {"launches": launches, "report_launches": report_launches,
            "section_launches": due, "pair_launches": pair_launches,
            "report_s": report_s, "sections": sections,
            "report_max_rel_err": worst, "stacked_s": stacked_s,
            "per_point_checked": n_checked, "per_point_simulated": n_new,
            "noc_fixture_max_rel_err": noc_worst,
            "pair": {"mix": mid, "s": pair_s, "max_rel_err": pair_worst,
                     "weighted_speedup": ws, "unfairness": unfair,
                     "ata_vs_private": ratio},
            "fairness": fairness, "profile_stacked": profiled}


# ---------------------------------------------------------------------------
# phase 7: serving exactness
# ---------------------------------------------------------------------------
BASELINE = ROOT / "benchmarks" / "baselines" / "serving_rounds512.json"
SERVE_COUNTERS = ("local_hits", "remote_hits", "recomputed_blocks",
                  "probe_messages", "remote_fetch_blocks")
SERVE_FLOATS = ("hit_rate", "load_imbalance", "p50_latency", "p99_latency",
                "requests_per_kcycle")
#: two baseline cells replayed again on the plain ``torch`` probe
TORCH_PROBE_CELLS = ((16, "chat+batch", "broadcast", 4),
                     (8, "chat+rag", "ata", 4))
#: phase 7's streams, results and baseline cells, for the telemetry phase
_SERVE_EXACT = {}


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
    _SERVE_EXACT.update(streams=streams, results=results,
                        cells={(c["shards"], c["mix"], c["policy"],
                                c["slots"]): c for c in rep["cells"]})

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
# phase 8: telemetry and observability
# ---------------------------------------------------------------------------
TELEMETRY_FIXTURE = SRC / "repro_torch" / "data" / "reference_telemetry.json"
SMOKE_TRACE = ROOT / "benchmarks" / "baselines" / "telemetry_smoke_trace.json"
#: the baseline cell replayed again with telemetry (phase 7's result)
TELEMETRY_SERVE_CELL = (8, "chat+rag", "ata", 4)


def same_timeline(tl, want: dict, where: str) -> None:
    """A SimTimeline's cumulative arrays equal a fixture point's: the
    same counters, dtypes and shapes, element for element."""
    if set(tl.cumulative) != set(want["cumulative"]):
        raise AssertionError(f"{where}: counters {sorted(tl.cumulative)}")
    for k, v in want["cumulative"].items():
        w, g = np.asarray(v, want["dtypes"][k]), tl.cumulative[k]
        if g.dtype != w.dtype or g.shape != w.shape \
                or not np.array_equal(g, w):
            raise AssertionError(f"{where}: {k} differs from the reference "
                                 f"({g.dtype}{g.shape} vs {w.dtype}"
                                 f"{w.shape})")


def phase_telemetry(device) -> dict:
    import torch
    from repro_torch.core import (PAPER_GEOMETRY, SweepGrid, SweepPoint,
                                  TelemetryConfig, app_traces, simulate)
    from repro_torch.core import report as sens
    from repro_torch.core.trace.serving import ServingMix
    from repro_torch.kernels import ata_probe_rank as kmod
    from repro_torch.kernels import ata_tag_probe as tmod
    from repro_torch.obs import trace_events, validate_trace
    from repro_torch.serving import serve_stream

    fixture = json.loads(TELEMETRY_FIXTURE.read_text())
    points = fixture["points"]
    tc = TelemetryConfig(window=fixture["window"])
    walls = {}
    with recorded_grid_runs() as runs:
        kmod.launches = tmod.launches = 0
        # 1. the telemetry capture's simulator point
        t0 = time.perf_counter()
        cap = points["capture"]
        trace = app_traces("cfd", PAPER_GEOMETRY, [0],
                           rounds=cap["rounds"])[0]
        res, tl = simulate(cap["arch"], trace, noc=cap["noc"], telemetry=tc,
                           device=device)
        torch.cuda.synchronize()
        walls["capture"] = time.perf_counter() - t0
        cap_launches = kmod.launches
        same_timeline(tl, cap, "capture")
        cap_err = max_rel_err(result_dict(res), cap["result"], "capture")
        tl.check(res)
        validate_trace(trace_events(tl))
        log(f"(1) cfd kernel 0 under {cap['arch']}/{cap['noc']}, "
            f"{cap['rounds']} rounds, window {tc.window}: every cumulative "
            f"array == {TELEMETRY_FIXTURE.name}, conservation holds, the "
            f"Perfetto trace validates ({tl.n_windows} windows, "
            f"{walls['capture']:.2f} s)")

        # 2. ata and victim stacked (and remote, whose per-app latency sum
        # passes 2**20) at the full length: the fixture's timelines, and
        # the results of phases 4 and 5 bit for bit
        if not _SUITE or not _ZOO_SUITE:
            raise AssertionError("the telemetry phase needs the suites of "
                                 "phases 'suite' and 'zoo'")
        full = [n for n in points if n != "capture"]
        trace = app_traces("cfd", PAPER_GEOMETRY, [0])[0]
        grid = SweepGrid.from_points(
            [SweepPoint(points[n]["arch"], PAPER_GEOMETRY, trace)
             for n in full])
        t0 = time.perf_counter()
        run = grid.run(telemetry=tc, device=device)
        torch.cuda.synchronize()
        walls["grid"] = time.perf_counter() - t0
        grid_launches = kmod.launches - cap_launches
        for name, p, r, tl in zip(full, grid.points, run.results,
                                  run.timelines):
            same_timeline(tl, points[name], name)
            tl.check(r)
            suite = _ZOO_SUITE if p.arch in _ZOO_SUITE["cfd"] else _SUITE
            same_results(r, suite["cfd"][p.arch].per_kernel[0],
                         f"{name} with telemetry vs its suite phase")
        big = max(float(tl.total("app_lat_sum")[0]) for tl in run.timelines)
        log(f"(2) SweepGrid.run(telemetry=) over cfd kernel 0 under "
            f"{', '.join(p.arch for p in grid.points)} at {trace.addr.shape[0]}"
            f" rounds ({run.report.n_executables} passes, {walls['grid']:.2f}"
            f" s): every timeline == the fixture's (largest per-app latency "
            f"sum {big:.1f}, 2**20 = {2 ** 20}), every result bit-equal to "
            "phases suite and zoo")
        sim_launches = kmod.launches
        due = cap["rounds"] + probe_launches_due(runs, device)
        if sim_launches != due or due != cap["rounds"] + 2 * 1536:
            raise AssertionError(f"ata_probe_rank launched {sim_launches} "
                                 f"times, the capture and the grid owe {due}")

        # 3. the committed smoke trace, regenerated on the card
        want = json.loads(SMOKE_TRACE.read_text())
        od = want["otherData"]
        stream = ServingMix(tuple(od["tenants"].split("+")),
                            name=od["tenants"]).make_stream(
            n_shards=od["shards"], rounds=od["rounds"], seed=0)
        t0 = time.perf_counter()
        res, tl = serve_stream(od["policy"], stream,
                               telemetry=TelemetryConfig(window=od["window"]),
                               device=device)
        walls["smoke_trace"] = time.perf_counter() - t0
        tl.check(res)
        got = json.loads(json.dumps(trace_events(tl)))
        if got != want:
            raise AssertionError(f"{SMOKE_TRACE.name}: the card's trace "
                                 "differs")
        smoke_probes = tmod.launches
        log(f"(3) {SMOKE_TRACE.name} regenerated on the card: "
            f"{len(got['traceEvents'])} events, equal event for event "
            f"({walls['smoke_trace']:.2f} s)")

        # 4. a 512-round baseline cell with telemetry, against the cell and
        # phase 7's replay without it
        ck = TELEMETRY_SERVE_CELL
        if not _SERVE_EXACT:
            raise AssertionError("the telemetry phase needs phase "
                                 "'serving_exact'")
        cell = _SERVE_EXACT["cells"][ck]
        stream = _SERVE_EXACT["streams"][ck[:2]].batched(ck[3])
        t0 = time.perf_counter()
        res, tl = serve_stream(ck[2], stream, telemetry=tc, device=device)
        torch.cuda.synchronize()
        walls["serve_cell"] = time.perf_counter() - t0
        plain = _SERVE_EXACT["results"][ck]
        if not same_serve_result(res._replace(lat_hist=None,
                                              hist_exact=False), plain):
            raise AssertionError(f"{ck}: telemetry changed the replay")
        for f in SERVE_COUNTERS:
            if getattr(res, f) != cell[f]:
                raise AssertionError(f"{ck}: {f} {getattr(res, f)} != "
                                     f"{cell[f]}")
        tl.check(res)
        if not res.hist_exact:
            raise AssertionError(f"{ck}: the histogram is not exact")
        pct = {}
        for q, key in ((50.0, "p50_latency"), (99.0, "p99_latency")):
            h, p = (res.latency_percentile(q),
                    float(np.percentile(res.request_latencies, q)))
            if not h == p == cell[key] == tl.hist_percentile(q):
                raise AssertionError(f"{ck}: p{q:g} histogram {h}, "
                                     f"np.percentile {p}, baseline "
                                     f"{cell[key]}")
            pct[key] = h
        tag_launches = tmod.launches
        T = stream.hashes.shape[0]
        if tag_launches - smoke_probes != T \
                or smoke_probes != od["rounds"]:
            raise AssertionError(f"ata_tag_probe launched {tag_launches} "
                                 f"times, want {od['rounds']} + {T}")
        log(f"(4) {ck} with telemetry ({walls['serve_cell']:.2f} s, "
            f"{tl.n_windows} windows): == the baseline cell and phase "
            f"serving_exact's replay, conservation holds, p50/p99 from the "
            f"histogram {pct['p50_latency']}/{pct['p99_latency']} == "
            "np.percentile == the baseline")
        launches = {"ata_probe_rank": kmod.launches,
                    "ata_tag_probe": tmod.launches}

    # 5. the sensitivity report of phase 6 carries its manifest
    if not _SWEEP_REPORT:
        raise AssertionError("the telemetry phase needs phase 'sweep'")
    man = _SWEEP_REPORT["manifest"]
    builds = man["kernel_builds"]
    if (man["device_name"] != torch.cuda.get_device_name(0)
            or man["power_limit"] != card_line()
            or sorted(builds) != sorted(KERNELS)
            or not all(b["exists"] for b in builds.values())):
        raise AssertionError(f"report manifest: {man}")
    if sens.compare_reports(json.loads(SENSITIVITY.read_text()),
                            _SWEEP_REPORT):
        raise AssertionError("compare_reports fails with the manifest")
    log(f"(5) the sensitivity report's manifest: {man['device_name']} "
        f"({man['power_limit']}), torch {man['torch_version']}, CUDA "
        f"{man['cuda_version']}, builds " + ", ".join(
            f"{k}={b['source_sha256_16']}"
            f"{' (built here)' if b['built_by_this_process'] else ''}"
            for k, b in sorted(builds.items())) + "; the gate passes")

    # 6. what telemetry adds to an ata round on the 46-kernel batch,
    # beside phase 4's plain profile of the same 64 rounds (one profile:
    # the profiler's own cost is most of a profile's wall)
    if "ata" not in _PROFILES:
        raise AssertionError("the telemetry phase needs the profile of "
                             "phase 'suite'")
    profiles = {"ata_telemetry": profile_round_loop(
        device, rounds=64, arch=("ata",), telemetry=tc)}
    per_round = {k: v["kernel_launches_per_round"]
                 for k, v in {**_PROFILES, **profiles}.items()}
    log(f"(6) kernel launches per round on the 46-kernel batch: ata "
        f"{per_round['ata']:.1f} (phase suite), with telemetry "
        f"{per_round['ata_telemetry']:.1f}")
    log(f"ata_probe_rank launches in the telemetry phase: "
        f"{launches['ata_probe_rank']} (= {cap['rounds']} + 2 x 1536); "
        f"ata_tag_probe: {launches['ata_tag_probe']}")
    return {"launches": launches, "wall_s": walls,
            "capture_max_rel_err": cap_err, "max_app_lat_sum": big,
            "serve_percentiles": pct, "manifest": man,
            "launches_per_round": per_round, "profiles": profiles}


# ---------------------------------------------------------------------------
# phase 9: the serving main path at scale
# ---------------------------------------------------------------------------
SCALE_SHARDS = 16
SCALE_MIX = ("chat", "rag")
#: fig_serving_scale.DEFAULT_REQUESTS is 1,000,000; the replay is cut to a
#: quarter of that depth. The 1M replay took 217-238 s on one H100; with
#: it the whole script, LM path included, would take ~815 s on the
#: fastest host measured and ~1,040 s on the slowest, too near its
#: 1,200 s limit; at a quarter it took 823 s on the slowest (PERF.md §4)
SCALE_REQUESTS = 250_000
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
    per_kernel = device_kernels(prof)
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


# ---------------------------------------------------------------------------
# phase 2, continued: flash_attention and wkv6 against their plain versions
# ---------------------------------------------------------------------------
BF16_PEAK_OPS_PER_S = 989e12   # dense bf16 tensor-core rate
#: kernel against plain version, elementwise |got - want| <= atol + rtol
#: |want| in f32, where both sides differ in summation order only
ATTN_TOL = {"float32": (1e-5, 1e-4)}
STATE_TOL = (1e-4, 1e-4)
#: bf16 outputs, kernel against plain version: both compute in f32 and
#: round once, so they may differ by one bf16 rounding step where the f32
#: values straddle it, |got - want| <= ulp_bf16(max(|got|, |want|)) +
#: BF16_ATOL (f32 noise near 0). The readings in PERF.md are exactly one
#: step (flash_attention 0.00195 at |o| < 0.5, wkv6 0.0156 at |o| < 4)
BF16_ATOL = 1e-5
#: scaled_dot_product_attention multiplies P by V in bf16 on the tensor
#: cores, so the kernel is held against it only as a sanity check
SDPA_TOL = (1e-2, 1e-2)
LM_SEQ = 4096                  # prefill length of the LM phases


def check_close(got, want, tol, where) -> float:
    """Raise unless |got - want| <= atol + rtol |want| everywhere (and
    both finite); returns the max abs error."""
    import torch
    atol, rtol = tol
    g, w = got.float(), want.float()
    if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
        raise AssertionError(f"{where}: non-finite values")
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    if bool(bad.any()):
        raise AssertionError(f"{where}: {int(bad.sum())} elements outside "
                             f"atol {atol} rtol {rtol} (max abs err "
                             f"{float(err.max())})")
    return float(err.max())


def check_bf16_step(got, want, where) -> float:
    """Raise unless bf16 ``got`` and ``want`` are within one bf16
    rounding step of each other everywhere (see BF16_ATOL); returns the
    max abs error."""
    import torch
    g, w = got.float(), want.float()
    if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
        raise AssertionError(f"{where}: non-finite values")
    err = (g - w).abs()
    mag = torch.maximum(g.abs(), w.abs())
    _, e = torch.frexp(mag)                   # mag = m * 2**e, m in [.5, 1)
    step = torch.where(mag > 0, torch.ldexp(torch.ones_like(mag), e - 8),
                       torch.zeros_like(mag))
    bad = err > step + BF16_ATOL
    if bool(bad.any()):
        raise AssertionError(f"{where}: {int(bad.sum())} elements more than "
                             f"one bf16 step apart (max abs err "
                             f"{float(err.max())})")
    return float(err.max())


def bound(nbytes: int, ops: float, ops_per_s: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def visible_pairs(B, Hq, Tq, Tk, causal, window, kv_len) -> int:
    """(query, key) pairs the attention mask lets through for these
    inputs: the work the kernel has to do."""
    qpos = np.arange(Tq)[:, None] + (Tk - Tq)
    kpos = np.arange(Tk)[None, :]
    mask = np.ones((Tq, Tk), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    lens = [Tk] * B if kv_len is None else kv_len
    return Hq * sum(int(mask[:, :min(int(n), Tk)].sum()) for n in lens)


def attn_inputs(B, Hq, Hkv, Tq, Tk, D, dtype, device, seed):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(s, generator=g, device=device).to(dtype)
            for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D))]


#: name: (B, Hq, Hkv, Tq, Tk, D, dtype, causal, window, kv_len)
ATTN_CASES = {
    "qwen3_prefill": (1, 16, 8, LM_SEQ, LM_SEQ, 128, "bfloat16", True, None,
                      None),
    "decode_kv_len": (4, 16, 8, 1, 512, 128, "bfloat16", False, None,
                      (1, 100, 333, 512)),
    "window": (1, 16, 8, 1024, 1024, 128, "bfloat16", True, 256, None),
    "odd_T": (2, 4, 2, 193, 193, 64, "float32", True, None, None),
    "f32": (1, 16, 8, 1024, 1024, 128, "float32", True, None, None),
    "kv_len_0": (3, 4, 2, 16, 64, 32, "float32", False, None, (0, 10, 64)),
}


def phase_flash_attention(device) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fmod
    cases, worst = {}, 0.0
    for name, (B, Hq, Hkv, Tq, Tk, D, dt, causal, window,
               kv_len) in ATTN_CASES.items():
        dtype = getattr(torch, dt)
        q, k, v = attn_inputs(B, Hq, Hkv, Tq, Tk, D, dtype, device,
                              seed=Tq + Tk + D)
        kl = (None if kv_len is None else
              torch.tensor(kv_len, dtype=torch.int32, device=device))
        got = fmod.flash_attention(q, k, v, kl, causal=causal, window=window)
        want = fmod.flash_attention_plain(q, k, v, kl, causal=causal,
                                          window=window)
        torch.cuda.synchronize()
        if got.dtype != dtype or got.shape != (B, Hq, Tq, D):
            raise AssertionError(f"flash_attention {name}: {got.dtype} "
                                 f"{tuple(got.shape)}")
        where = f"flash_attention {name}"
        err = (check_bf16_step(got, want, where) if dt == "bfloat16"
               else check_close(got, want, ATTN_TOL[dt], where))
        tol = ATTN_TOL.get(dt, "one bf16 step")
        if kv_len is not None and 0 in kv_len:
            if not bool((got[kv_len.index(0)] == 0).all()):
                raise AssertionError("flash_attention: a kv_len=0 row is "
                                     "not zero")
        cases[name] = {"max_abs_err": err, "tol": tol}
        worst = max(worst, err)
        log(f"flash_attention {name} ({B},{Hq},{Hkv},{Tq},{Tk},{D}) {dt}: "
            f"max abs err {err:.3g} vs plain (tol {tol})")

    # timings at the main path's shape (qwen3 prefill, one layer)
    B, Hq, Hkv, Tq, Tk, D, dt, causal, window, kv_len = \
        ATTN_CASES["qwen3_prefill"]
    q, k, v = attn_inputs(B, Hq, Hkv, Tq, Tk, D, torch.bfloat16, device, 1)
    kernel = lambda: fmod.flash_attention(q, k, v, causal=True)  # noqa: E731
    plain = lambda: fmod.flash_attention_plain(q, k, v, causal=True)  # noqa: E731,E501
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    check_close(kernel(), library(), SDPA_TOL,
                "flash_attention vs scaled_dot_product_attention")
    pairs = visible_pairs(B, Hq, Tq, Tk, causal, window, kv_len)
    ops = 4 * D * pairs
    nbytes = 2 * (2 * B * Hq * Tq * D + 2 * B * Hkv * Tk * D)
    bound_ms, bound_by = bound(nbytes, ops, BF16_PEAK_OPS_PER_S)
    t = {"plain_ms_runs": [time_ms(plain, n=3, warm=1)],
         "library_ms_runs": [time_ms(library, n=20, warm=3)],
         "call_ms": time_ms(kernel, n=20, warm=2),
         "device_ms": kernel_device_ms(kernel, "attn_bf16_kernel", n=10)}
    t["library_ms_runs"].append(time_ms(library, n=20, warm=3))
    t["plain_ms_runs"].append(time_ms(plain, n=3, warm=1))
    t.update(plain_ms=sum(t["plain_ms_runs"]) / 2,
             library_ms=sum(t["library_ms_runs"]) / 2, bound_ms=bound_ms,
             bound_by=bound_by, bytes=nbytes, ops=ops, pairs=pairs)
    t["tflops"] = ops / ((t["device_ms"] or t["call_ms"]) * 1e-3) / 1e12
    # the f32 CUDA-core kernel, at the f32 case
    B, Hq, Hkv, Tq, Tk, D, dt, causal, window, kv_len = ATTN_CASES["f32"]
    q32, k32, v32 = attn_inputs(B, Hq, Hkv, Tq, Tk, D, torch.float32, device,
                                2)
    f32 = lambda: fmod.flash_attention(q32, k32, v32, causal=causal)  # noqa: E731,E501
    pairs32 = visible_pairs(B, Hq, Tq, Tk, causal, window, kv_len)
    t["f32"] = {"shape": [B, Hq, Hkv, Tq, Tk, D],
                "device_ms": kernel_device_ms(f32, "attn_f32_kernel", n=10),
                "call_ms": time_ms(f32, n=10, warm=2),
                "bound_ms": bound(4 * (2 * B * Hq * Tq * D + 2 * B * Hkv * Tk
                                       * D), 4 * D * pairs32,
                                  FP32_OPS_PER_S)[0]}
    log(f"flash_attention f32 case {t['f32']['shape']}: kernel "
        f"{t['f32']['device_ms']} ms on the device, bound "
        f"{t['f32']['bound_ms']:.5f} ms (f32 operations)")
    log(f"flash_attention qwen3 prefill shape: kernel {t['device_ms']} ms on "
        f"the device, {t['call_ms']:.4f} ms per call ({t['tflops']:.1f} "
        f"TFLOP/s); plain {t['plain_ms_runs']} ms; SDPA "
        f"{t['library_ms_runs']} ms; bound {bound_ms:.5f} ms ({bound_by}: "
        f"{nbytes} B, {ops:.4g} flops over {pairs} visible pairs)")
    return {"max_abs_err": worst, "cases": cases, "timing": t}


def wkv6_inputs(B, H, T, K, V, device, seed, *, decay=None):
    """r, k, v bf16 and w f32 <= 0 as the model hands them over (w =
    -exp(normal), or a constant ``decay``); u (H, K) f32."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)

    def n(*s, scale=0.5):
        return torch.randn(s, generator=g, device=device) * scale
    r, k, v = (n(B, H, T, d).to(torch.bfloat16) for d in (K, K, V))
    w = (-torch.exp(n(B, H, T, K, scale=1.0)) if decay is None
         else torch.full((B, H, T, K), decay, device=device))
    return r, k, v, w, n(H, K)


def phase_wkv6(device) -> dict:
    import torch
    from repro_torch.kernels import wkv6 as wmod
    cases, worst = {}, 0.0

    def check(name, got, want):
        nonlocal worst
        e_o = check_bf16_step(got[0], want[0], f"wkv6 {name} o")
        e_s = check_close(got[1], want[1], STATE_TOL, f"wkv6 {name} state")
        worst = max(worst, e_o, e_s)
        cases[name] = {"o_max_abs_err": e_o, "state_max_abs_err": e_s}
        log(f"wkv6 {name}: max abs err o {e_o:.3g} (bf16), state {e_s:.3g}"
            " vs plain")

    H, K = 40, 64                         # rwkv6-3b: 40 heads of 64
    x = wkv6_inputs(1, H, LM_SEQ, K, K, device, 0)
    check("rwkv6_prefill", wmod.wkv6(*x), wmod.wkv6_plain(*x))
    s0 = torch.randn((1, H, K, K), device=device)
    x1 = wkv6_inputs(1, H, 1, K, K, device, 1)
    check("decode_T1", wmod.wkv6(*x1, s0), wmod.wkv6_plain(*x1, s0))
    x2 = wkv6_inputs(2, 4, 300, 32, 64, device, 2)
    check("K32_V64", wmod.wkv6(*x2), wmod.wkv6_plain(*x2))
    # the length of the LM decode check's forward, in one call and as
    # one-step calls chained through the state (what decode_step
    # launches): the two must be equal bit for bit
    x4 = wkv6_inputs(1, H, DECODE_TOKENS, K, K, device, 4)
    one = wmod.wkv6(*x4, s0)
    check("one_chunk_T64", one, wmod.wkv6_plain(*x4, s0))
    s, outs = s0, []
    for i in range(DECODE_TOKENS):
        o, s = wmod.wkv6(*(y[:, :, i:i + 1] for y in x4[:4]), x4[4], s)
        outs.append(o)
    chain = torch.cat(outs, 2)
    differ = {"o": int((chain != one[0]).sum()), "state": int(
        (s != one[1]).sum())}
    cases["decode_chain_T64"] = {"elements_unequal_to_one_call": differ}
    log(f"wkv6 {DECODE_TOKENS} chained T=1 calls against one call: "
        f"elements that differ {differ}")
    if any(differ.values()):
        raise AssertionError(f"wkv6: chained T=1 calls differ from one "
                             f"T={DECODE_TOKENS} call in {differ}")
    # two halves chained through the state equal the whole
    r, k, v, w, u = x
    h = LM_SEQ // 2
    o1, s1 = wmod.wkv6(r[:, :, :h], k[:, :, :h], v[:, :, :h], w[:, :, :h], u)
    o2, s2 = wmod.wkv6(r[:, :, h:], k[:, :, h:], v[:, :, h:], w[:, :, h:], u,
                       s1)
    check("chained_halves", (torch.cat([o1, o2], 2), s2), wmod.wkv6(*x))
    x3 = wkv6_inputs(1, 4, 512, K, K, device, 3, decay=-20.0)
    got = wmod.wkv6(*x3)
    if not all(bool(torch.isfinite(t).all()) for t in got):
        raise AssertionError("wkv6 w=-20: non-finite output")
    check("decay_-20", got, wmod.wkv6_plain(*x3))
    torch.cuda.synchronize()

    kernel = lambda: wmod.wkv6(*x)  # noqa: E731
    plain = lambda: wmod.wkv6_plain(*x)  # noqa: E731
    B, T, V = 1, LM_SEQ, K
    nbytes = (B * H * T * (2 * K + 2 * K + 2 * V + 4 * K)   # r, k, v, w
              + H * K * 4 + B * H * T * V * 2 + B * H * K * V * 4)
    # per step and (i, j): r_i S_ij (2 flops) and S_ij e^w_i + k_i v_j (3);
    # the bonus term factors as v_j sum_i r_i u_i k_i, O(K + V) a step
    ops = B * H * T * (5 * K * V + 3 * K + 2 * V)
    bound_ms, bound_by = bound(nbytes, ops, FP32_OPS_PER_S)
    t = {"plain_ms_runs": [time_ms(plain, n=1, warm=0)],
         "call_ms": time_ms(kernel, n=20, warm=2),
         "device_ms": kernel_device_ms(kernel, "wkv6_scan_kernel", n=10)}
    t["plain_ms_runs"].append(time_ms(plain, n=1, warm=0))
    t.update(plain_ms=sum(t["plain_ms_runs"]) / 2, bound_ms=bound_ms,
             bound_by=bound_by, bytes=nbytes, ops=ops)
    # T=1 from an initial state, 40 heads: the decode step ModelServer
    # launches; its bound counts bytes, each
    # input read once (s0 f32 included) and each output written once
    step = lambda: wmod.wkv6(*x1, s0)  # noqa: E731
    t1_bytes = (H * (2 * K + 2 * K + 2 * K + 4 * K) + H * K * 4
                + 2 * H * K * K * 4 + H * K * 2)
    t1_ops = H * (5 * K * K + 3 * K + 2 * K)
    t["t1"] = {"device_ms": kernel_device_ms(step, "wkv6_scan_kernel",
                                             n=50),
               "call_ms": time_ms(step, n=50, warm=5), "bytes": t1_bytes,
               "ops": t1_ops}
    t["t1"]["bound_ms"], t["t1"]["bound_by"] = bound(t1_bytes, t1_ops,
                                                     FP32_OPS_PER_S)
    log(f"wkv6 T=1 (40 heads, initial state): kernel {t['t1']['device_ms']}"
        f" ms on the device, {t['t1']['call_ms']:.4f} ms per call; bound "
        f"{t['t1']['bound_ms']:.6f} ms ({t['t1']['bound_by']}: {t1_bytes} B)")
    log(f"wkv6 rwkv6 prefill shape: kernel {t['device_ms']} ms on the "
        f"device, {t['call_ms']:.4f} ms per call; plain {t['plain_ms_runs']}"
        f" ms; bound {bound_ms:.5f} ms "
        f"({bound_by}: {nbytes} B, {ops} f32 flops)")
    return {"max_abs_err": worst, "cases": cases, "timing": t}


# ---------------------------------------------------------------------------
# phases 10-12: the LM inference path at full width
# ---------------------------------------------------------------------------
LM_ARCHS = ("qwen3-0.6b", "rwkv6-3b")
LM_SEEDS = {"qwen3-0.6b": 0, "rwkv6-3b": 1}
#: The full-width checks of the LM path. In f32 the "kernel" and "ref"
#: routes differ only in summation order (rel ~1e-6), so they are held
#: tight. In bf16 (the configs' dtype) the two routes are not the same
#: function, as in the reference: "ref"'s WKV6 oracle hands the group
#: norm f32 output, the kernel bf16; and a 32-layer random-weight model
#: amplifies a rounding step to several percent of the largest logit (on
#: the CPU, with the plain versions in both routes, a d=512 rwkv6 stack
#: shows kernel vs ref rel 0.023 / 0.036 / 0.055 at 4 / 16 / 32 layers,
#: each route ~0.038 from f32 at 32). So the bf16 "kernel" route is held
#: to fixed limits set from the readings in PERF.md at these seeds (1.5x
#: the reading, rounded up): against the f32 "ref" route (qwen3 0.0177,
#: rwkv6 0.0875) and against the bf16 "ref" route (0.0188, 0.0607).
F32_ROUTE_TOL = 1e-4
BF16_VS_F32_TOL = {"qwen3-0.6b": 0.03, "rwkv6-3b": 0.14}
BF16_ROUTES_TOL = {"qwen3-0.6b": 0.03, "rwkv6-3b": 0.1}
#: decode against forward, the reference's own check and tolerance
#: (tests/test_models.py, which runs it in f32)
DECODE_REL_TOL = 2e-2
#: the same in bf16: 1.5x the largest reading in PERF.md (qwen3 0.0207;
#: rwkv6 0)
DECODE_BF16_TOL = 3.2e-2
DECODE_TOKENS = 64
_MODELS = {}


def lm_model(arch, device):
    """Full-width weights made on the card from a fixed seed: the f32
    master weights, and the model the main path serves, whose matmul
    operands are cast to bf16 once at load (bit for bit the per-call
    casts' results; ``transformer.cast_for_compute``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    if arch not in _MODELS:
        cfg = get_config(arch)
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(LM_SEEDS[arch])
        params = T.init_params(cfg, generator=gen, device=device)
        torch.cuda.synchronize()
        n = sum(p.numel() for p in params.parameters())
        log(f"{arch}: {n} parameters made on the card in "
            f"{time.perf_counter() - t0:.2f} s (param_count() "
            f"{cfg.param_count()})")
        _MODELS[arch] = (cfg, params, T.cast_for_compute(params, cfg))
    return _MODELS[arch]


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def lm_tokens(cfg, T, seed=0):
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, T)))


def reset_lm_counts():
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import wkv6 as wmod
    fmod.launches = wmod.launches = 0


def lm_counts() -> dict:
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import wkv6 as wmod
    return {"flash_attention": fmod.launches, "wkv6": wmod.launches}


def phase_lm_prefill(device) -> dict:
    """``transformer.forward`` at full width, B=1, T=4096: the "kernel"
    route in bf16 (the main path: launch counts zeroed just before, read
    just after), then the "ref" route, and both again in f32, on the same
    weights."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as T
    out = {}
    for arch in LM_ARCHS:
        cfg, master, served = lm_model(arch, device)
        tokens = lm_tokens(cfg, LM_SEQ).to(device)
        T.forward(served, cfg, tokens)                    # warm
        torch.cuda.synchronize()
        reset_lm_counts()
        t0 = time.perf_counter()
        k16, _ = T.forward(served, cfg, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = lm_counts()
        want = ({"flash_attention": cfg.n_layers, "wkv6": 0}
                if arch == "qwen3-0.6b" else
                {"flash_attention": 0, "wkv6": cfg.n_layers})
        if counts != want:
            raise AssertionError(f"{arch} forward launched {counts}, want "
                                 f"{want}")
        if k16.shape != (1, LM_SEQ, T.padded_vocab(cfg)) or not bool(
                torch.isfinite(k16).all()):
            raise AssertionError(f"{arch}: logits {tuple(k16.shape)}, "
                                 "or non-finite")
        logits, secs = {("kernel", "bfloat16"): k16}, {}
        for impl, dt in (("ref", "bfloat16"), ("kernel", "float32"),
                         ("ref", "float32")):
            t0 = time.perf_counter()
            logits[impl, dt], _ = T.forward(
                served if dt == cfg.dtype else master,
                dataclasses.replace(cfg, attention_impl=impl, dtype=dt),
                tokens)
            torch.cuda.synchronize()
            secs[f"{impl}_{dt}"] = time.perf_counter() - t0
        f32, r16 = logits["ref", "float32"], logits["ref", "bfloat16"]
        rel = {"kernel_vs_ref_f32": rel_err(logits["kernel", "float32"], f32),
               "kernel_vs_ref_bf16": rel_err(k16, r16),
               "kernel_bf16_vs_ref_f32": rel_err(k16, f32),
               "ref_bf16_vs_ref_f32": rel_err(r16, f32)}
        del logits, f32, r16, k16
        if rel["kernel_vs_ref_f32"] > F32_ROUTE_TOL:
            raise AssertionError(f"{arch}: f32 kernel vs ref route rel "
                                 f"{rel['kernel_vs_ref_f32']} > "
                                 f"{F32_ROUTE_TOL}")
        lim = {"kernel_bf16_vs_ref_f32": BF16_VS_F32_TOL[arch],
               "kernel_vs_ref_bf16": BF16_ROUTES_TOL[arch]}
        for key, tol in lim.items():
            if rel[key] > tol:
                raise AssertionError(f"{arch}: bf16 kernel route {key} "
                                     f"{rel[key]} > {tol} ({rel})")
        out[arch] = {"wall_s": wall, "tokens_per_s": LM_SEQ / wall,
                     "launches": counts, "rel_err": rel,
                     "route_wall_s": secs}
        log(f"{arch} prefill B=1 T={LM_SEQ}: {wall * 1e3:.1f} ms, "
            f"{LM_SEQ / wall:.0f} tokens/s; launches per forward {counts}; "
            f"kernel vs ref route rel {rel['kernel_vs_ref_f32']:.3g} in f32 "
            f"(tol {F32_ROUTE_TOL}), {rel['kernel_vs_ref_bf16']:.3g} in bf16"
            f" (tol {lim['kernel_vs_ref_bf16']}); bf16 vs f32 ref route: "
            f"kernel {rel['kernel_bf16_vs_ref_f32']:.3g} (tol "
            f"{lim['kernel_bf16_vs_ref_f32']}), ref "
            f"{rel['ref_bf16_vs_ref_f32']:.3g}; "
            f"other routes {secs}")
    return out


def profile_decode(cfg, params, cache, token, steps=8) -> dict:
    """One decode step under torch.profiler (the mean of ``steps``):
    host wall, device busy time, kernel launches per token."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    T.decode_step(params, cfg, token, cache)            # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        c = cache
        for _ in range(steps):
            _, c = T.decode_step(params, cfg, token, c)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = device_kernels(prof)
    busy_us = sum(d for d, _, _ in per_kernel)
    return {"wall_ms_per_token": wall * 1e3 / steps,
            "device_busy_ms_per_token": busy_us / 1e3 / steps,
            "device_busy_share": busy_us / 1e6 / wall,
            "launches_per_token": sum(c for _, c, _ in per_kernel) / steps,
            "top_kernels_ms_per_token": [
                (k[:90], d / 1e3 / steps, c / steps)
                for d, c, k in sorted(per_kernel, reverse=True)[:6]]}


def wkv6_f64(r, k, v, w, u, s0):
    """The WKV6 recurrence in f64 (``wkv6_plain``'s loop) from the state
    s0, o rounded once to r's dtype and the state to f32: what a kernel
    that made no f32 rounding error would return."""
    import torch
    rf, kf, vf, wf = (x.double() for x in (r, k, v, w))
    uu = u.double()[None, :, :, None]
    S = s0.double()
    outs = []
    for t in range(r.shape[2]):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, t], S + uu * kv))
        S = torch.exp(wf[:, :, t])[..., None] * S + kv
    return torch.stack(outs, 2).to(r.dtype), S.float()


def exact_wkv6_forward(params, cfg, tokens) -> tuple:
    """``forward`` with every layer's WKV6 taken in f64 (``wkv6_f64``),
    and, layer by layer on the same inputs, how many bf16 outputs of the
    kernel (one call over the T tokens) and of T chained T=1 kernel calls
    (what ``decode_step`` launches) differ from it."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    kernel = ops.wkv6_kernel
    flips = {"kernel": [], "decode_chain": [], "kernel_vs_decode_chain": []}

    def layer(r, k, v, w, u, s0, **kw):
        want = wkv6_f64(r, k, v, w, u, s0)
        got = kernel(r, k, v, w, u, s0)[0]
        s, outs = s0, []
        for t in range(r.shape[2]):
            o, s = kernel(*(x[:, :, t:t + 1] for x in (r, k, v, w)), u, s)
            outs.append(o)
        chain = torch.cat(outs, 2)
        for key, a, b in (("kernel", got, want[0]),
                          ("decode_chain", chain, want[0]),
                          ("kernel_vs_decode_chain", got, chain)):
            flips[key].append(int((a != b).sum()))
        return want

    ops.wkv6_kernel = layer
    try:
        logits, _ = T.forward(params, cfg, tokens)
    finally:
        ops.wkv6_kernel = kernel
    return logits, flips


def phase_lm_decode(device) -> dict:
    """The reference's decode-vs-forward check at full width: teacher-force
    64 tokens through ``decode_step`` against ``forward``'s logits, in f32
    as the reference runs it (rel < 2e-2) and in bf16, the configs' dtype
    (within DECODE_BF16_TOL); then a profiled bf16 decode step. For
    rwkv6, beside the bf16 reading: the same check against a forward whose
    WKV6 is exact (``exact_wkv6_forward``), with its per-layer counts of
    bf16 outputs that differ. Every model is read and profiled before a
    failed check raises."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as T
    out, failed = {}, []
    for arch in LM_ARCHS:
        cfg, master, served = lm_model(arch, device)
        tokens = lm_tokens(cfg, DECODE_TOKENS, seed=1).to(device)
        res, full, dec = {}, {}, {}
        for dt in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, dtype=dt)
            params = served if dt == cfg.dtype else master
            full[dt], _ = T.forward(params, c, tokens)
            cache = T.init_cache(c, 1, DECODE_TOKENS + 8, device=device)
            outs = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(DECODE_TOKENS):
                lg, cache = T.decode_step(params, c, tokens[:, t:t + 1],
                                          cache)
                outs.append(lg[:, 0])
            torch.cuda.synchronize()
            dec[dt] = torch.stack(outs, 1)
            res[dt] = {"rel_err_vs_forward": rel_err(dec[dt], full[dt]),
                       "wall_ms_per_token":
                       (time.perf_counter() - t0) * 1e3 / DECODE_TOKENS}
        noise = rel_err(full["bfloat16"], full["float32"])
        tol16 = DECODE_BF16_TOL
        exact = None
        if arch == "rwkv6-3b":
            lg, flips = exact_wkv6_forward(served, cfg, tokens)
            exact = {"rel_err_vs_decode": rel_err(dec["bfloat16"], lg),
                     "rel_err_vs_forward": rel_err(lg, full["bfloat16"]),
                     "flips_total": {k: sum(v) for k, v in flips.items()},
                     "flips_per_layer": flips,
                     "outputs_per_layer": DECODE_TOKENS * cfg.d_model}
            del lg
        if not res["float32"]["rel_err_vs_forward"] < DECODE_REL_TOL:
            failed.append(f"{arch}: f32 decode vs forward {res}")
        if not res["bfloat16"]["rel_err_vs_forward"] <= tol16:
            failed.append(f"{arch}: bf16 decode vs forward {res}, tol "
                          f"{tol16}; forward with an exact WKV6: {exact}")
        prof = profile_decode(cfg, served, cache, tokens[:, -1:])
        out[arch] = {"f32": res["float32"], "bf16": res["bfloat16"],
                     "bf16_forward_vs_f32": noise, "bf16_tol": tol16,
                     "bf16_exact_wkv6": exact, "profile": prof}
        log(f"{arch} decode: {DECODE_TOKENS} teacher-forced tokens vs "
            f"forward rel {res['float32']['rel_err_vs_forward']:.3g} in f32 "
            f"(tol {DECODE_REL_TOL}), "
            f"{res['bfloat16']['rel_err_vs_forward']:.3g} in bf16 (tol "
            f"{tol16:.3g}; bf16 forward vs f32 {noise:.3g}); "
            f"{res['bfloat16']['wall_ms_per_token']:.2f} ms per bf16 token; "
            f"profiled step: {prof['wall_ms_per_token']:.2f} ms wall, device "
            f"busy {prof['device_busy_ms_per_token']:.3f} ms "
            f"({100 * prof['device_busy_share']:.1f}%), "
            f"{prof['launches_per_token']:.0f} launches per token")
        if exact is not None:
            log(f"{arch} bf16 decode vs a forward with an exact (f64) WKV6: "
                f"rel {exact['rel_err_vs_decode']:.3g} (that forward vs the "
                f"kernel's: {exact['rel_err_vs_forward']:.3g}); bf16 WKV6 "
                f"outputs unlike the exact ones, summed over "
                f"{cfg.n_layers} layers of {exact['outputs_per_layer']}: "
                f"{exact['flips_total']}")
        for k, ms, c in prof["top_kernels_ms_per_token"]:
            log(f"  {ms:.4f} ms/token  x{c:.1f}  {k}")
    if failed:
        raise AssertionError("; ".join(failed))
    return out


SERVE_STATS = ("local_hits", "remote_hits", "recomputed_blocks",
               "probe_messages", "remote_fetch_blocks",
               "directory_sync_entries")


def phase_lm_serve(device) -> dict:
    """``ModelServer`` at the reference launcher's defaults cut to half
    its 16 synthetic requests (8 requests, 4 shards, block 16, 8 decode
    steps, ``ata``) for both models; the directory's stats against ``run_workload``; one request
    served cold and then warm."""
    import torch
    from repro_torch.launch.serve import ModelServer
    from repro_torch.serving.ref import (AtaCacheConfig, AtaPrefixCache,
                                         run_workload, synth_requests)
    # 16 requests took 255-330 s of the script's 1,200 s on the H100
    # (host-bound decode); 8 keep every check at half the wall
    shards, n_req, steps = 4, 8, 8
    acfg = AtaCacheConfig(n_shards=shards, block_tokens=16)
    out = {}
    for arch in LM_ARCHS:
        cfg, _, params = lm_model(arch, device)
        reqs = synth_requests(n_req, n_shards=shards, vocab=cfg.vocab_size,
                              shared_frac=0.7)
        ata = AtaPrefixCache(acfg, "ata")
        servers = [ModelServer(cfg, params, ata, s, device=device)
                   for s in range(shards)]
        torch.cuda.synchronize()
        reset_lm_counts()
        t0 = time.perf_counter()
        metrics = [servers[int(s)].serve(np.asarray(toks), steps)[1]
                   for s, toks in reqs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = lm_counts()
        want = run_workload("ata", acfg, reqs)
        for f in SERVE_STATS:
            if getattr(ata.stats, f) != getattr(want, f):
                raise AssertionError(f"{arch} serve: {f} "
                                     f"{getattr(ata.stats, f)} != "
                                     f"run_workload's {getattr(want, f)}")
        if not np.array_equal(ata.stats.shard_load, want.shard_load):
            raise AssertionError(f"{arch} serve: shard_load differs")
        prefill = sum(m["prefill_tokens"] for m in metrics)
        decode_calls = prefill + n_req * steps
        if counts["wkv6"] != (cfg.n_layers * decode_calls
                              if arch == "rwkv6-3b" else 0):
            raise AssertionError(f"{arch} serve: launches {counts} for "
                                 f"{decode_calls} decode steps")
        del ata, servers
        torch.cuda.empty_cache()

        # one request (40 tokens, as in the reference's own test of this
        # claim: two full blocks and a tail), cold then warm
        toks = np.asarray(reqs[0][1][:40])
        solo = AtaPrefixCache(AtaCacheConfig(n_shards=1, block_tokens=16),
                              "ata")
        srv = ModelServer(cfg, params, solo, 0, device=device)
        cold, _ = srv.serve(toks, steps)
        warm, m = srv.serve(toks, steps)
        if m["reused_blocks"] != len(toks) // 16 or warm != cold:
            raise AssertionError(f"{arch} serve: warm {warm} (reused "
                                 f"{m['reused_blocks']}) != cold {cold}")
        del solo, srv
        torch.cuda.empty_cache()
        out[arch] = {"requests": n_req, "wall_s": wall,
                     "wall_s_per_request": wall / n_req,
                     "decode_steps": decode_calls,
                     "decode_tokens_per_s": decode_calls / wall,
                     "prefill_tokens": prefill,
                     "reused_blocks": sum(m["reused_blocks"]
                                          for m in metrics),
                     "launches": counts, "hit_rate": want.hit_rate,
                     "warm_equals_cold": True}
        log(f"{arch} serve: {n_req} requests in {wall:.2f} s "
            f"({wall / n_req * 1e3:.1f} ms per request), {decode_calls} "
            f"decode steps ({decode_calls / wall:.1f} per s: {prefill} "
            f"teacher-forced + {n_req * steps} generated); launches {counts};"
            f" stats == run_workload (hit rate {want.hit_rate:.3f}); warm == "
            "cold")
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

    phases, report, failed = {}, {"card": card}, {}
    for name, fn in (("build", phase_build),
                     ("kernels", lambda: phase_kernels(device)),
                     ("tag_probe", lambda: phase_tag_probe(device)),
                     ("flash_attention",
                      lambda: phase_flash_attention(device)),
                     ("wkv6", lambda: phase_wkv6(device)),
                     ("goldens", lambda: phase_goldens(device)),
                     ("suite", lambda: phase_suite(device)),
                     ("zoo", lambda: phase_zoo(device)),
                     ("sweep", lambda: phase_sweep(device)),
                     ("serving_exact", lambda: phase_serving_exact(device)),
                     ("telemetry", lambda: phase_telemetry(device)),
                     ("serving_scale", lambda: phase_serving_scale(device)),
                     ("lm_prefill", lambda: phase_lm_prefill(device)),
                     ("lm_decode", lambda: phase_lm_decode(device)),
                     ("lm_serve", lambda: phase_lm_serve(device))):
        t0 = time.perf_counter()
        try:
            report[name] = fn()
        except Exception as e:  # reported; the run fails after the rest
            traceback.print_exc()
            failed[name] = f"{type(e).__name__}: {e}"
            log(f"phase {name} FAILED: {failed[name]}")
        phases[name] = time.perf_counter() - t0
        log(f"phase {name}: {phases[name]:.2f} s")
    report["phase_s"] = phases
    REPORT.parent.mkdir(exist_ok=True)
    if failed:
        report["failed"] = failed
        REPORT.write_text(json.dumps(report, indent=1, default=str) + "\n")
        log(json.dumps({"phase_s": phases}))
        log(f"chip_smoke: {len(failed)} phase(s) failed: {sorted(failed)}")
        return 1

    t = report["kernels"]["timings"]["P46_R120"]
    kernels = [{
        "name": "ata_probe_rank", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ata_probe_rank.cu",
        "replaces": "src/repro/kernels/ata_probe_rank.py:54",
        # the paper suite's, the zoo suite's, the sweep phase's and the
        # telemetry phase's runs, each counted from 0
        "launches": (report["suite"]["launches"] + report["zoo"]["launches"]
                     + report["sweep"]["launches"]
                     + report["telemetry"]["launches"]["ata_probe_rank"]),
        "max_abs_err": report["kernels"]["max_abs_err"],
        "ms": t["device_ms"] if t["device_ms"] is not None else t["call_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "launch_floor_ms": t["launch_floor_ms"],
    }]
    t = report["tag_probe"]["timing"]
    kernels.append({
        "name": "ata_tag_probe", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ata_tag_probe.cu",
        "replaces": "src/repro/kernels/ata_tag_probe.py:32",
        # the scale replay's and the telemetry phase's, each from 0
        "launches": (report["serving_scale"]["launches"]["ata_tag_probe"]
                     + report["telemetry"]["launches"]["ata_tag_probe"]),
        "max_abs_err": report["tag_probe"]["max_abs_err"],
        "ms": t["device_ms"] if t["device_ms"] is not None else t["call_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "launch_floor_ms": t["launch_floor_ms"],
    })
    t = report["flash_attention"]["timing"]
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": report["lm_prefill"]["qwen3-0.6b"]["launches"][
            "flash_attention"],
        "max_abs_err": report["flash_attention"]["max_abs_err"],
        "ms": t["device_ms"] if t["device_ms"] is not None else t["call_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "f32_ms": t["f32"]["device_ms"],
    })
    t = report["wkv6"]["timing"]
    kernels.append({
        "name": "wkv6", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6.py:36",
        "launches": report["lm_serve"]["rwkv6-3b"]["launches"]["wkv6"],
        "max_abs_err": report["wkv6"]["max_abs_err"],
        "ms": t["device_ms"] if t["device_ms"] is not None else t["call_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "t1_ms": t["t1"]["device_ms"], "t1_bound_ms": t["t1"]["bound_ms"],
    })
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
