"""Pluggable architecture policies for the cache-hierarchy simulator.

Public API:
  ArchPolicy, L1Outcome, RequestBatch — the policy interface (base.py)
  register_arch / get_arch / registered_archs — the policy registry
  PAPER_ARCHITECTURES — the four architectures the paper compares

The four paper architectures register on import; external code adds
more with ``register_arch(MyPolicy())``.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.arch.base import (TAG_CHECK, ArchPolicy, L1Outcome,
                                        RequestBatch)
from repro_torch.core.arch.private import PrivatePolicy
from repro_torch.core.arch.remote import RemotePolicy
from repro_torch.core.arch.decoupled import DecoupledPolicy
from repro_torch.core.arch.ata import AtaPolicy

#: The paper's comparison set (Figs. 8–10, Table I).
PAPER_ARCHITECTURES: Tuple[str, ...] = ("private", "remote", "decoupled",
                                        "ata")

_REGISTRY: Dict[str, ArchPolicy] = {}


def register_arch(policy: ArchPolicy, *, overwrite: bool = False) -> ArchPolicy:
    """Add a policy to the registry under ``policy.name``."""
    if not isinstance(policy, ArchPolicy):
        raise TypeError(f"expected an ArchPolicy, got {type(policy)!r}")
    if policy.name in _REGISTRY and not overwrite:
        raise ValueError(f"architecture {policy.name!r} already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[policy.name] = policy
    return policy


def get_arch(name: str) -> ArchPolicy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown architecture {name!r}; registered: "
            f"{registered_archs()}") from None


def registered_archs() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


register_arch(PrivatePolicy())
register_arch(RemotePolicy())
register_arch(DecoupledPolicy())
register_arch(AtaPolicy())

__all__ = [
    "TAG_CHECK", "ArchPolicy", "L1Outcome", "RequestBatch",
    "PrivatePolicy", "RemotePolicy", "DecoupledPolicy", "AtaPolicy",
    "PAPER_ARCHITECTURES", "register_arch", "get_arch",
    "registered_archs",
]
