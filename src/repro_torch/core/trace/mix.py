"""Multi-tenant workload composition: co-scheduled apps on one GPU.

A numpy copy of the reference's ``repro.core.trace.mix`` (the port
imports nothing of ``repro``): the same specs give array-equal composed
and component traces, which the parity tests pin.

The paper evaluates one application at a time, but real GPUs
co-schedule kernels from multiple applications on the same cluster, and
inter-application interference in the shared memory system is exactly
where contention-mitigation policies diverge most (MASK, arXiv
1708.04911; shared-resource survey, arXiv 1803.06958).
:class:`WorkloadMix` composes several calibrated apps into one
:class:`~repro_torch.core.simulator.Trace`:

* **core assignment** — ``partitioned`` (contiguous blocks),
  ``interleaved`` (round-robin dealing), or asymmetric ``shares``
  (explicit cores per app);
* **address-space slicing** — each mix slot's addresses are offset by
  ``slot * APP_STRIDE`` so co-runners never falsely share lines; the
  stride is a multiple of every power-of-two L1 set count, so each
  app's set mapping (and thus its solo cache behavior) is preserved;
* **phase stagger** — optionally each slot's rounds are rotated by
  ``slot * phase_rounds``, modeling kernels that don't launch in
  lock-step;
* **shape coercion** — components are re-generated at a common
  ``(rounds, m)`` (the min rounds / max m over the mix unless pinned),
  since one composed trace has one shape;
* **attribution channel** — the composed trace carries
  ``core_app`` (app id per core) and a per-core ``insn_per_req``
  vector, which the simulator turns into a per-app
  :class:`~repro_torch.core.simulator.AppStats` block.

The *same* sliced, staggered, full-machine component traces double as
the solo baselines (:meth:`WorkloadMix.component_traces`), so the
slowdown each app sees in the mix is interference, not an address-map
artifact. A mix of a single app composes to exactly its solo trace, so
``simulate`` over the two is bit-identical.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.simulator import Trace
from repro_torch.core.trace.apps import APPS, AppParams
from repro_torch.core.trace.generators import _require_int32, make_trace

#: Address-space stride between mix slots (line numbers). A power of
#: two: every app's L1-set mapping is offset-invariant, and the int32
#: guard in ``_require_int32`` caps a mix at 16 slots rather than
#: letting slot 16 wrap into slot 0's region.
APP_STRIDE = 1 << 27

_LAYOUTS = ("partitioned", "interleaved")


def _resolve_app(app: Union[str, AppParams]) -> AppParams:
    if isinstance(app, AppParams):
        return app
    try:
        return APPS[app]
    except KeyError:
        raise ValueError(
            f"unknown app {app!r}; known: {sorted(APPS)}") from None


@dataclasses.dataclass(frozen=True)
class WorkloadMix:
    """A co-scheduling spec: which apps, on which cores, in which phase.

    ``apps`` lists the co-runners (names from the calibrated table, or
    explicit :class:`AppParams`); the same app may appear twice — each
    occurrence is an independent *slot* with its own seed and address
    slice. ``shares`` gives cores per slot (defaults to an equal split
    with the remainder on the earliest slots). ``kernels`` is one
    kernel index for every slot or a per-slot tuple. ``rounds`` pins
    the composed trace length (default: the shortest component).
    """
    apps: Tuple[Union[str, AppParams], ...]
    shares: Optional[Tuple[int, ...]] = None
    layout: str = "partitioned"
    kernels: Union[int, Tuple[int, ...]] = 0
    phase_rounds: int = 0
    rounds: Optional[int] = None
    name: Optional[str] = None

    def __post_init__(self):
        if not self.apps:
            raise ValueError("WorkloadMix needs at least one app")
        if self.layout not in _LAYOUTS:
            raise ValueError(
                f"layout must be one of {_LAYOUTS}, got {self.layout!r}")
        if self.shares is not None and len(self.shares) != len(self.apps):
            raise ValueError(
                f"shares {self.shares} must give one core count per app "
                f"({len(self.apps)} apps)")
        if isinstance(self.kernels, tuple) and \
                len(self.kernels) != len(self.apps):
            raise ValueError(
                f"kernels tuple {self.kernels} must give one kernel per "
                f"app ({len(self.apps)} apps)")
        for app in self.apps:
            _resolve_app(app)

    # ------------------------------------------------------------------
    @property
    def n_apps(self) -> int:
        return len(self.apps)

    @property
    def mix_id(self) -> str:
        """A stable human-readable id (report cells, result keys)."""
        if self.name:
            return self.name
        names = "+".join(_resolve_app(a).name for a in self.apps)
        tags = []
        if self.shares is not None:
            tags.append("@" + ",".join(str(s) for s in self.shares))
        if self.layout != "partitioned":
            tags.append("|" + self.layout)
        if self.phase_rounds:
            tags.append(f"|ph{self.phase_rounds}")
        return names + "".join(tags)

    def slot_kernel(self, slot: int) -> int:
        return self.kernels[slot] if isinstance(self.kernels, tuple) \
            else int(self.kernels)

    # ------------------------------------------------------------------
    def resolve_shares(self, n_cores: int) -> Tuple[int, ...]:
        """Cores per slot; equal split (remainder to early slots) by
        default."""
        A = self.n_apps
        if self.shares is None:
            base, rem = divmod(n_cores, A)
            shares = tuple(base + (1 if i < rem else 0) for i in range(A))
        else:
            shares = tuple(int(s) for s in self.shares)
        if any(s < 1 for s in shares):
            raise ValueError(
                f"every app needs >= 1 core, got shares {shares} over "
                f"{n_cores} cores")
        if sum(shares) != n_cores:
            raise ValueError(
                f"shares {shares} must sum to n_cores={n_cores}")
        return shares

    def core_assignment(self, n_cores: int) -> np.ndarray:
        """(C,) int32 slot id per core under the mix's layout."""
        shares = self.resolve_shares(n_cores)
        if self.layout == "partitioned":
            return np.repeat(np.arange(self.n_apps), shares) \
                     .astype(np.int32)
        # interleaved: deal slots round-robin until every share is spent
        out: List[int] = []
        remaining = list(shares)
        while len(out) < n_cores:
            for slot in range(self.n_apps):
                if remaining[slot]:
                    remaining[slot] -= 1
                    out.append(slot)
        return np.asarray(out, np.int32)

    def component_params(self) -> List[AppParams]:
        """Per-slot params coerced to the common composed (rounds, m)."""
        params = [_resolve_app(a) for a in self.apps]
        T = self.rounds if self.rounds is not None \
            else min(p.rounds for p in params)
        m = max(p.m for p in params)
        return [dataclasses.replace(p, rounds=T, m=m) for p in params]

    def component_traces(self, n_cores: int = 30, *,
                         seed: int = 0) -> List[Trace]:
        """Per-slot *solo* traces on the full machine.

        Each slot's trace already carries its mix-slot address offset
        and phase rotation, so a solo run of a component and the
        composed mix expose every core of that app to byte-identical
        addresses — slowdowns measured against these baselines are pure
        interference. Slot 0 is offset- and rotation-free: a one-app
        mix composes to exactly its solo trace.
        """
        comps = []
        for slot, p in enumerate(self.component_params()):
            tr = make_trace(p, n_cores=n_cores,
                            kernel=self.slot_kernel(slot),
                            seed=seed + slot)
            shift = (slot * self.phase_rounds) % p.rounds \
                if self.phase_rounds else 0
            if slot == 0 and not shift:
                comps.append(tr)      # bit-identical to make_trace
                continue
            addr = tr.addr.astype(np.int64) + slot * APP_STRIDE
            is_write = tr.is_write
            if shift:
                addr = np.roll(addr, shift, axis=0)
                is_write = np.roll(is_write, shift, axis=0)
            comps.append(Trace(addr=_require_int32(addr),
                               is_write=is_write,
                               insn_per_req=tr.insn_per_req))
        return comps

    def compose(self, n_cores: int = 30, *, seed: int = 0) -> Trace:
        """The composed multi-tenant trace (one shape, one ``Trace``)."""
        assign = self.core_assignment(n_cores)
        comps = self.component_traces(n_cores, seed=seed)
        T, _, m = comps[0].addr.shape
        addr = np.empty((T, n_cores, m), np.int32)
        is_write = np.empty((T, n_cores, m), bool)
        insn = np.empty((n_cores,), np.float32)
        for slot, tr in enumerate(comps):
            cols = assign == slot
            addr[:, cols, :] = tr.addr[:, cols, :]
            is_write[:, cols, :] = tr.is_write[:, cols, :]
            insn[cols] = tr.insn_per_req
        return Trace(addr=addr, is_write=is_write, insn_per_req=insn,
                     core_app=assign)
