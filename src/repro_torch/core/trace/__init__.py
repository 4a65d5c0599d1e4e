"""Workload traces: the calibrated app table and its generators.

  apps.py        the calibrated :class:`AppParams` table (data only)
  generators.py  :func:`make_trace` + kernel-parameter rules + the
                 int32 address guard
  mix.py         :class:`WorkloadMix` — multi-tenant composition with
                 per-app attribution (``Trace.core_app``)
  serving.py     :class:`ServingMix` / :class:`RequestStream` — the
                 multi-tenant request streams of the serving engine
                 (``repro_torch.serving.engine``)
"""
from repro_torch.core.trace.apps import (APPS, HIGH_LOCALITY, LOW_LOCALITY,
                                         AppParams)
from repro_torch.core.trace.generators import (app_kernels, kernel_params,
                                               make_trace)
from repro_torch.core.trace.mix import APP_STRIDE, WorkloadMix
from repro_torch.core.trace.serving import (TENANT_STRIDE, TENANTS,
                                            RequestStream, ServingMix,
                                            TenantParams, tenant_stream)

__all__ = [
    "APPS", "HIGH_LOCALITY", "LOW_LOCALITY", "AppParams",
    "app_kernels", "kernel_params", "make_trace",
    "APP_STRIDE", "WorkloadMix",
    "TENANT_STRIDE", "TENANTS", "RequestStream", "ServingMix",
    "TenantParams", "tenant_stream",
]
