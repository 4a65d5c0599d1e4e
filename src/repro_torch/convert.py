"""Carry state across from the reference package.

Each function takes plain values — numpy arrays, or objects with the
reference's field names — and returns the port's structure, so the
parity tests can feed both packages the same mid-run state. Nothing
here imports the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.geometry import GpuGeometry
from repro_torch.core.simulator import Trace
from repro_torch.core.tagarray import TagState


def tag_state(arrays: Mapping[str, np.ndarray], device="cpu") -> TagState:
    """A reference TagState (its dict with every array through
    ``np.asarray``) as the port's, with a leading point axis of 1."""
    return {k: torch.from_numpy(np.array(v)).unsqueeze(0).to(device)
            for k, v in arrays.items()}


def trace(ref_trace) -> Trace:
    """A reference ``Trace`` (or anything with its four fields)."""
    core_app = ref_trace.core_app
    return Trace(addr=np.asarray(ref_trace.addr),
                 is_write=np.asarray(ref_trace.is_write),
                 insn_per_req=ref_trace.insn_per_req,
                 core_app=None if core_app is None else np.asarray(core_app))


def geometry(ref_geom) -> GpuGeometry:
    """A reference ``GpuGeometry`` (or anything with its fields)."""
    return GpuGeometry(**{f.name: getattr(ref_geom, f.name)
                          for f in dataclasses.fields(GpuGeometry)})
