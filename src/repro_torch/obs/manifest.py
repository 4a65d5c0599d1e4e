"""Run manifests: what produced this report, on what, at what cost.

The port of the reference's ``repro.obs.manifest``. Every report the
port writes (the sensitivity report and the telemetry capture) attaches
a ``manifest`` block so a number can be traced back to the code
revision, the torch and CUDA versions, the card and its power limit,
the kernel builds, the pass accounting and the phase wall-clock that
produced it. The reference's JAX fields (``jax_version``,
``serving_executable_costs``) have no counterpart here; their places
are taken by ``torch_version``, ``cuda_version``, ``device_name``,
``power_limit`` and ``kernel_builds``.

Every probe is guarded the way the reference guards its own — a missing
``git`` or ``nvidia-smi`` gives ``None`` — and only records: none of
them decides which device or kernel runs.

The regression gate (``repro_torch.core.report.compare_reports``)
iterates only the baseline's sections, so adding ``manifest`` to
reports is forward-compatible with committed baselines by construction.
"""
from __future__ import annotations

import contextlib
import os
import platform
import subprocess
import sys
import time
from typing import Dict, Optional


def git_sha(cwd: Optional[str] = None) -> Optional[str]:
    """HEAD commit sha of the repo containing this package, or None."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


class PhaseTimer:
    """Wall-clock accounting per named phase of a benchmark run.

    >>> timer = PhaseTimer()
    >>> with timer.phase("sweep"):
    ...     run_the_sweep()
    >>> timer.phases
    {'sweep': 1.234}

    Re-entering a phase name accumulates into it.
    """

    def __init__(self) -> None:
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) \
                + (time.perf_counter() - t0)


def _compile_counts() -> Dict[str, int]:
    from repro_torch.core import sweep
    return {"sweep": sweep.compile_count()}


def power_limit() -> Optional[str]:
    """``name, power.limit`` of the first card as ``nvidia-smi`` reports
    them, or None where there is no ``nvidia-smi`` (or no card)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    line = out.stdout.strip().splitlines()
    return line[0].strip() if out.returncode == 0 and line else None


def kernel_builds() -> Dict[str, dict]:
    """Per ``csrc/*.cu``: the source hash ``kernels/build.py`` keys its
    library on, the library's path, whether the library exists, and
    whether this process compiled it."""
    from repro_torch.kernels import build
    out: Dict[str, dict] = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        lib = build.library_path(src.stem)
        out[src.stem] = {
            "source_sha256_16": build.source_digest(src.stem),
            "library": str(lib),
            "exists": lib.exists(),
            "built_by_this_process": src.stem in build.BUILT,
        }
    return out


def run_manifest(phases: Optional[Dict[str, float]] = None,
                 extra: Optional[dict] = None) -> dict:
    """The manifest block attached to reports."""
    import torch
    cuda = torch.cuda.is_available()
    manifest: dict = {
        "git_sha": git_sha(),
        "python": platform.python_version(),
        "platform": platform.platform(),
        "argv": list(sys.argv),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "compile_counts": _compile_counts(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "device_name": (torch.cuda.get_device_name(0) if cuda
                        else platform.processor() or platform.machine()),
        "power_limit": power_limit() if cuda else None,
        "kernel_builds": kernel_builds(),
    }
    if phases:
        manifest["phases_wall_s"] = {k: round(v, 6)
                                     for k, v in phases.items()}
    if extra:
        manifest.update(extra)
    return manifest
