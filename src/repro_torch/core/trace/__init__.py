"""Workload traces: the calibrated app table and its generators.

  apps.py        the calibrated :class:`AppParams` table (data only)
  generators.py  :func:`make_trace` + kernel-parameter rules + the
                 int32 address guard
"""
from repro_torch.core.trace.apps import (APPS, HIGH_LOCALITY, LOW_LOCALITY,
                                         AppParams)
from repro_torch.core.trace.generators import (app_kernels, kernel_params,
                                               make_trace)

__all__ = [
    "APPS", "HIGH_LOCALITY", "LOW_LOCALITY", "AppParams",
    "app_kernels", "kernel_params", "make_trace",
]
