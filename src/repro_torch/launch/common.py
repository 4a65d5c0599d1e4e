"""Shared benchmark utilities: CSV emission and timing (the port of the
reference's ``benchmarks/common.py:82-92``).

Every benchmark module prints ``name,us_per_call,derived`` lines through
:func:`emit`. :func:`time_call` times a call on the host clock with the
card synchronized around the timed span, the counterpart of the
reference's ``jax.block_until_ready``: a CUDA launch returns before the
device finishes, so without it the time is the enqueue's.
:func:`kernel_device_ms` reads a kernel's own device time from the
profiler (``launch/roofline.py`` and ``chip_smoke.py`` use it).
"""
from __future__ import annotations

import time

import torch


def emit(name, us, derived):
    print(f"{name},{us:.1f},{derived}")


def _on_card(out) -> bool:
    """Whether any tensor in ``out`` (nested tuples and lists) lies on a
    CUDA device."""
    if torch.is_tensor(out):
        return out.is_cuda
    if isinstance(out, (tuple, list)):
        return any(_on_card(x) for x in out)
    return False


def _ready(out):
    if _on_card(out):
        torch.cuda.synchronize()
    return out


def time_call(fn, *args, reps=3, warmup=1, **kw):
    """(mean microseconds per call over ``reps`` after ``warmup`` calls,
    the last output)."""
    for _ in range(warmup):
        _ready(fn(*args, **kw))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = _ready(fn(*args, **kw))
    return (time.perf_counter() - t0) / reps * 1e6, out


def kernel_device_ms(fn, name: str, n=100):
    """Mean device time per call of ``fn`` spent in the kernels whose
    names hold ``name`` (``torch.profiler`` over ``n`` calls after one
    warm call); None when the profiler shows no device time."""
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
