"""Runner of the simulator's sweep cells: whole ``SweepGrid`` passes of
``repro_torch`` over a grid of (kernel trace x trace draw x timing
geometry) points, back to back.

The traffic file names the kernels (``m``, optionally ``high_locality``
or ``apps``), the ``draws`` of each kernel's trace and the timing
``knobs`` whose factorial gives the geometries; the configuration file
names the architecture, the NoC model, the probe backend, the rounds a
trace runs and the Table II geometry the knobs vary. Draw j of run seed
s is generated at trace seed ``s * 4096 + j``.

Set-up generates the traces, builds the grid and runs the first draw's
points (every kernel under every geometry) once at 8 rounds, which loads
every kernel and operator the window's rounds launch. The window then
runs whole sweeps at the configuration's rounds, each timed from the
call to its return, and starts one only while the mean sweep so far
fits in the time left. ``sim_requests_per_s`` is every sweep's simulated
requests over the sum of their walls. A traced run profiles one whole
sweep instead. The set-up's phases and the sweeps' walls go to standard
error.

Correctness: every point of every sweep of the window against the plain
reference (``simbench.reference``), run once over all the points after
the window.
"""
from __future__ import annotations

import dataclasses
import importlib
import itertools
import sys
import time
import traceback
from typing import Dict, List

from simbench import check, devtrace, tracegen

#: rounds of the set-up sweep
WARM_ROUNDS = 8


def kernels(traffic: Dict) -> List[tuple]:
    """(app, kernel) of every kernel the mix names, in table order."""
    apps = traffic.get("apps") or list(tracegen.APPS)
    out = []
    for name in apps:
        app = tracegen.APPS[name]
        if app.m != traffic.get("m", app.m):
            continue
        if traffic.get("high_locality", app.high_locality) \
                != app.high_locality:
            continue
        out += [(name, k) for k in range(app.n_kernels)]
    return out


def geometries(config: Dict, traffic: Dict) -> List[Dict]:
    """The configuration's geometry under every combination of the
    mix's knob values (the last knob fastest)."""
    knobs = traffic["knobs"]
    out = []
    for values in itertools.product(*knobs.values()):
        geom = dict(config["geometry"])
        geom.update(zip(knobs, values))
        out.append(geom)
    return out


def traces(config: Dict, traffic: Dict, seed: int) -> List[tracegen.Trace]:
    """Every draw of every kernel: draw-major, then kernels in order."""
    return [tracegen.make_trace(
                dataclasses.replace(tracegen.APPS[app],
                                    rounds=config["rounds"]),
                kernel=k, seed=seed * 4096 + j)
            for j in range(traffic["draws"]) for app, k in kernels(traffic)]


def _grid(config, geoms, frozen, rounds, device):
    from repro_torch.core import GpuGeometry, SweepGrid, Trace
    ts = [Trace(t.addr[:rounds], t.is_write[:rounds], t.insn_per_req)
          for t in frozen]
    backend = config["probe_backend"] if device.type == "cuda" else None
    return SweepGrid([config["arch"]], [GpuGeometry(**g) for g in geoms],
                     ts, nocs=[config["noc"]], probe_backends=[backend])


def reference_results(config, frozen, geoms, points, device, **kw):
    """The plain reference's results of ``points`` (indices into the
    grid: geometry-major, trace fastest)."""
    return reference_of(config).simulate(
        config["arch"], [frozen[i % len(frozen)] for i in points],
        [geoms[i // len(frozen)] for i in points], device=device, **kw)


def reference_of(config: Dict):
    """The plain reference the configuration names."""
    return importlib.import_module(f"simbench.reference.{config['reference']}")


def warm(config, traffic, geoms, frozen, device):
    """The set-up sweep: the first draw's traces under every geometry of
    the cell, at :data:`WARM_ROUNDS` rounds."""
    first = frozen[:len(kernels(traffic))]
    _grid(config, geoms, first, WARM_ROUNDS, device).run(device=device)


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell) -> Dict:
    import torch
    config, traffic, device = cell.config, cell.traffic, cell.device
    phases = {"imports": time.perf_counter() - cell.t0}
    frozen = traces(config, traffic, cell.seed)
    geoms = geometries(config, traffic)
    rounds = config["rounds"]
    phases["traces"] = time.perf_counter() - cell.t0
    grid = _grid(config, geoms, frozen, rounds, device)
    P = len(grid.points)
    requests = P * rounds * frozen[0].addr[0].size
    phases["grid"] = time.perf_counter() - cell.t0
    try:
        warm(config, traffic, geoms, frozen, device)
    except Exception:           # the window's sweeps fail and report it
        traceback.print_exc()
    _sync(device)
    setup_s = phases["warm"] = time.perf_counter() - cell.t0
    print("set-up phases ending at (s): " + " ".join(
        f"{k} {v:.4f}" for k, v in phases.items()), file=sys.stderr)

    kept, failed, out = [], 0, {}

    def sweep_once():
        """One sweep's results; a sweep that raises returns none, and
        every point of it counts as failed."""
        nonlocal failed
        try:
            results = grid.run(device=device).results
            _sync(device)
        except Exception:       # the run goes on to report it
            traceback.print_exc()
            failed += P
            return False
        kept.append(results)
        failed += sum(r is None for r in results)
        return True

    if cell.trace:
        from torch.profiler import ProfilerActivity, profile as torch_profile
        from torch.profiler import record_function
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with torch_profile(activities=acts) as prof:
            with record_function(devtrace.WINDOW):
                sweep_once()
        sweeps = 1
        out["capture"] = devtrace.capture(prof, {
            "rounds": rounds, "points": P, "traces": frozen,
            "geometry": config["geometry"]})
    else:
        walls = []
        start = time.perf_counter()
        while True:
            t = time.perf_counter()
            done = sweep_once()
            walls.append(time.perf_counter() - t)
            left = cell.seconds - (time.perf_counter() - start)
            if not done or sum(walls) / len(walls) > left:
                break
        sweeps = len(walls)
        print("sweep walls (s): " + " ".join(f"{w:.4f}" for w in walls),
              file=sys.stderr)
        rate = len(kept) * requests / sum(walls)
        out["metrics"] = {"sim_requests_per_s": rate, "setup_s": setup_s}
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    del grid
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    reference = reference_results(config, frozen, geoms, range(P), device)
    print(f"reference (s): {time.perf_counter() - t:.4f}", file=sys.stderr)
    out.update(attempted=sweeps * P, failed=failed,
               numbers=check.compare(kept or [[None] * P], reference))
    return out
