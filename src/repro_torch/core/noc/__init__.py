"""Pluggable interconnect (NoC) models for the cache-hierarchy simulator.

Public API:
  NocModel, NocTraffic, NocTransit, init_noc_state, port_rate — the
      model interface + carried-state convention (base.py)
  register_noc / get_noc / registered_nocs — the model registry
  PAPER_NOCS — the topology comparison set

Three models register on import:

  ideal    : infinite bandwidth, zero latency (the default everywhere)
  crossbar : per-port arbitration with finite injection queues whose
             occupancy carries across rounds (real backpressure)
  ring     : hop-distance latency from cluster positions plus
             per-link flit accounting (hotspots)
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.noc.base import (NocModel, NocState, NocTraffic,
                                       NocTransit, init_noc_state, port_rate)
from repro_torch.core.noc.crossbar import CrossbarNoc
from repro_torch.core.noc.ideal import IdealNoc
from repro_torch.core.noc.ring import RingNoc

#: The topology comparison set (the reference's ``PAPER_NOCS``).
PAPER_NOCS: Tuple[str, ...] = ("ideal", "crossbar", "ring")

_REGISTRY: Dict[str, NocModel] = {}


def register_noc(model: NocModel, *, overwrite: bool = False) -> NocModel:
    """Add a model to the registry under ``model.name``."""
    if not isinstance(model, NocModel):
        raise TypeError(f"expected a NocModel, got {type(model)!r}")
    if model.name in _REGISTRY and not overwrite:
        raise ValueError(f"NoC model {model.name!r} already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[model.name] = model
    return model


def get_noc(name: str) -> NocModel:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown NoC model {name!r}; registered: "
            f"{registered_nocs()}") from None


def registered_nocs() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


register_noc(IdealNoc())
register_noc(CrossbarNoc())
register_noc(RingNoc())

__all__ = [
    "NocModel", "NocState", "NocTraffic", "NocTransit", "init_noc_state",
    "port_rate", "IdealNoc", "CrossbarNoc", "RingNoc", "PAPER_NOCS",
    "register_noc", "get_noc", "registered_nocs",
]
