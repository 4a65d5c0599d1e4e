"""The benchmark's harness: finds a cell of ``BENCHMARK.json`` by name,
runs it through the runner its configuration names, and prints the
result line.

Everything that belongs to one cell is found by name:

* the configuration in ``simbench/configs/<config>.json``, which names
  its runner (``simbench/runners/<runner>.py``), its plain reference
  (``simbench/reference/<reference>.py``) and the limits of the
  comparison that decides ``correct`` (``check``);
* the traffic mix in ``simbench/traffic/<traffic>.json``;
* each per-layer metric's reader in ``simbench/metrics/<name>.py``.

A runner's ``run(cell)`` returns the end-to-end metrics it took (or, in a
traced run, the :class:`simbench.devtrace.Capture` of its traced window),
the points attempted and failed, the peak of device memory and the
numbers the comparison reads.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List, NamedTuple

from simbench import check

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
#: top-level modules a run may not load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Cell(NamedTuple):
    name: str
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: object          # torch.device
    t0: float               # process start, for set-up time


def forbidden_modules(names) -> List[str]:
    """The loaded modules whose top-level name is one of
    :data:`FORBIDDEN`, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def load_cell(name: str) -> tuple:
    """(workload entry, configuration file, traffic file, benchmark)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    work = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[work["config"]]["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{work['traffic']}.json").read_text())
    return work, config, traffic, bench


def _applies(metric: Dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def reader(name: str):
    """The module of ``simbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"simbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def device_of(arg: str, chips: int):
    """The device a run uses; refuses a machine without the cards the
    cell asks for (``cpu`` only when asked for by name)."""
    import torch
    if arg == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark runs on the card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} cards, the machine has "
                         f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def main(argv=None, t0: float = 0.0) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cpu' skips the look for a card (tests only)")
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit("the program (src/repro_torch) is not in this "
                         "checkout")
    sys.path.insert(0, str(ROOT / "src"))
    work, config, traffic, bench = load_cell(args.workload)
    device = device_of(args.device, work["chips"])
    runner = importlib.import_module(f"simbench.runners.{config['runner']}")
    cell = Cell(args.workload, config, traffic, args.seed, args.seconds,
                bool(args.trace), device, t0)
    out = runner.run(cell)

    found = forbidden_modules(sys.modules)
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    metrics: Dict[str, Dict] = {}
    device_line = device_record(device, work["chips"],
                                out["memory_peak_bytes"])
    if args.trace:
        from simbench import devtrace
        cap = out["capture"]
        for m in bench["per_layer"]:
            value = (reader(m["name"]).read(cap)
                     if _applies(m, args.workload) else None)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        lo, hi = cap.window
        device_line.update(busy_s=devtrace.busy_ns(cap, lo, hi) / 1e9,
                           window_s=(hi - lo) / 1e9)
    else:
        for m in bench["end_to_end"]:
            if _applies(m, args.workload):
                metrics[m["name"]] = {"value": out["metrics"][m["name"]],
                                      "unit": m["unit"]}
    v = check.verdict(out["numbers"], config["check"])
    result = {"correct": v["ok"] and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_line}
    if args.trace:
        result["breakdown"] = devtrace.breakdown(cap)
    result["checks"] = v["checks"]
    print(json.dumps(result))
    for name, c in v["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


def device_record(device, chips: int, peak: int) -> Dict:
    import torch
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": peak}
