"""Run every (arch x shape x mesh) dry-run cell, one subprocess per cell.

The port of the reference's ``scripts/run_dryrun_all.py``: a process
joins one process group, so each cell runs ``python -m
repro_torch.launch.dryrun`` in its own. Cells already recorded in
``results/dryrun_torch/`` as ``ok`` or ``skipped`` are not run again
unless ``--force``; a cell that outlives ``--timeout`` seconds is killed
and recorded as an ``error``. Order: one representative cell per risk
class first (fail fast), then all single-pod, then multi-pod;
``--jobs`` runs that many cells at once, taken in that order.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.run_dryrun_all [--jobs 4]
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from repro_torch.launch.dryrun import RESULTS_DIR

ROOT = pathlib.Path(__file__).resolve().parents[3]

ARCHS = ["rwkv6-3b", "qwen3-0.6b", "qwen1.5-4b", "nemotron-4-15b",
         "stablelm-12b", "granite-moe-3b-a800m", "granite-moe-1b-a400m",
         "recurrentgemma-9b", "whisper-tiny", "chameleon-34b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

PREFLIGHT = [("rwkv6-3b", "long_500k", False),
             ("whisper-tiny", "train_4k", False),
             ("granite-moe-1b-a400m", "train_4k", False),
             ("recurrentgemma-9b", "decode_32k", False),
             ("qwen1.5-4b", "decode_32k", False),
             ("chameleon-34b", "train_4k", True)]


def cells():
    seen = set()
    for c in PREFLIGHT:
        seen.add(c)
        yield c
    for mp in (False, True):
        for a in ARCHS:
            for s in SHAPES:
                c = (a, s, mp)
                if c not in seen:
                    yield c


def tag_of(arch: str, shape: str, mp: bool) -> str:
    return f"{arch}__{shape}__{'mp' if mp else 'sp'}"


def run_cell(arch: str, shape: str, mp: bool, *, results: pathlib.Path,
             timeout: float, force: bool = False) -> str:
    """Run one cell in a subprocess unless its record is ``ok`` or
    ``skipped`` already; returns the line it printed."""
    tag = tag_of(arch, shape, mp)
    out = results / f"{tag}.json"
    if out.exists() and not force:
        st = json.loads(out.read_text()).get("status")
        if st in ("ok", "skipped"):
            return f"[sweep] {tag}: cached ({st})"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", str(out)]
    if mp:
        cmd.append("--multi-pod")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.time()
    try:
        r = subprocess.run(cmd, cwd=ROOT, timeout=timeout, env=env,
                           capture_output=True, text=True)
        tail = (r.stdout or "").strip().splitlines()
        if r.returncode != 0 and not out.exists():
            out.write_text(json.dumps(
                {"arch": arch, "shape": shape, "status": "error",
                 "error": (r.stderr or "")[-3000:]}))
        return (f"[sweep] {tag}: {tail[-1] if tail else r.returncode} "
                f"({time.time() - t0:.0f}s)")
    except subprocess.TimeoutExpired:
        out.write_text(json.dumps(
            {"arch": arch, "shape": shape, "status": "error",
             "error": f"timeout {timeout:.0f}s"}))
        return f"[sweep] {tag}: TIMEOUT"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once (default 1)")
    args = ap.parse_args(argv)
    results = RESULTS_DIR
    results.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        futures = [pool.submit(run_cell, a, s, mp, results=results,
                               timeout=args.timeout, force=args.force)
                   for a, s, mp in cells()]
        for f in futures:
            print(f.result(), flush=True)


if __name__ == "__main__":
    main()
