"""What a traced step does on one device: dot FLOPs, dot bytes,
collective bytes and live memory.

The counterpart of the reference's ``launch/hlo_analysis.py``. PyTorch
has no HLO: the dry run (:mod:`repro_torch.launch.dryrun`) runs the step
eagerly on ``meta`` tensors (shapes only, no allocation) and this module
counts what it dispatches, at the shapes one device holds:

  * a DTensor op is counted at its **local** shards: :class:`StepCounter`
    lets DTensor dispatch first (it returns ``NotImplemented`` for
    DTensor types, as ``CommDebugMode`` does) and sees the plain ops that
    one rank runs, its redistributions' collectives among them (a
    ``FlopCounterMode`` entered around DTensor code sees each op once at
    its global shapes);
  * **dot FLOPs** are ``torch.utils.flop_counter``'s formulas (matmuls,
    convolutions, fused attention), the same numbers ``FlopCounterMode``
    gives on one device; **dot bytes** are each matmul's operands and
    result, as ``hlo_analysis.py`` counts a ``dot``;
  * **collective bytes** per kind, with the reference's ring conventions
    (``hlo_analysis.py``): all-reduce 2x its input, all-gather 1x its
    output, reduce-scatter and all-to-all 1x their input, each at one
    rank's shard, for the functional collectives (``_c10d_functional``,
    what DTensor issues) and the process-group ones (``c10d``, what
    ``torch.distributed`` calls issue);
  * **live bytes**: every storage an op creates is counted from its
    creation until it is freed (a weak reference on the storage), so the
    peak is the step's largest set of simultaneously live temporaries,
    autograd's saved tensors included, above the arguments it was given.
    The arguments' storages are known before the step: a view of one, or
    an in-place op's result, creates nothing.

Python loops (the blocked attention's tiles, the WKV6 steps) run in
full, so nothing is counted once for many trips (the reference's HLO
needed while-trip multipliers for that).
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: matmul-like ops whose operands and result are the "dot bytes"
DOT_OPS = ("mm", "addmm", "bmm", "baddbmm", "_scaled_mm")

#: op name -> (collective kind, which side its bytes are read from, factor)
COLLECTIVES = {
    "all_reduce": ("all-reduce", "in", 2),
    "all_reduce_": ("all-reduce", "in", 2),
    "all_reduce_coalesced": ("all-reduce", "in", 2),
    "allreduce_": ("all-reduce", "in", 2),
    "allreduce_coalesced_": ("all-reduce", "in", 2),
    "all_gather_into_tensor": ("all-gather", "out", 1),
    "all_gather_into_tensor_coalesced": ("all-gather", "out", 1),
    "allgather_": ("all-gather", "out", 1),
    "_allgather_base_": ("all-gather", "out", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", "out", 1),
    "reduce_scatter_tensor": ("reduce-scatter", "in", 1),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "in", 1),
    "reduce_scatter_": ("reduce-scatter", "in", 1),
    "_reduce_scatter_base_": ("reduce-scatter", "in", 1),
    "all_to_all_single": ("all-to-all", "in", 1),
    "alltoall_": ("all-to-all", "in", 1),
    "alltoall_base_": ("all-to-all", "in", 1),
    "broadcast_": ("broadcast", "in", 1),
}


COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def storages(tensors: Iterable[torch.Tensor]) -> Dict[int, int]:
    """{id: bytes} of the distinct storages behind ``tensors`` (a
    DTensor's local shard's); a storage keeps one Python object while it
    lives, so its id names it."""
    out = {}
    for t in tensors:
        st = _local(t).untyped_storage()
        out[id(st)] = st.nbytes()
    return out


def storage_bytes(tensors: Iterable[torch.Tensor]) -> int:
    """The bytes of the distinct storages behind ``tensors``."""
    return sum(storages(tensors).values())


class StepCounter(TorchDispatchMode):
    """Counts dot FLOPs, dot bytes, collective bytes and live bytes of
    the ops dispatched within it, per device (see the module docstring).
    ``by_op`` holds the FLOPs per op name; ``arguments`` are the tensors
    the step is given (their storages are not the step's)."""

    def __init__(self, arguments: Iterable[torch.Tensor] = ()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.dot_flops = 0
        self.dot_bytes = 0
        self.by_op: Dict[str, int] = defaultdict(int)
        self.collective_bytes: Dict[str, int] = defaultdict(int)
        self.collective_calls: Dict[str, int] = defaultdict(int)
        self.live = 0
        self.peak = 0
        self.n_ops = 0
        self._seen = weakref.WeakKeyDictionary()
        for t in arguments:
            self._seen[_local(t).untyped_storage()] = 0

    def _track(self, out) -> None:
        for t in _tensors(out):
            if type(t) not in (torch.Tensor, torch.nn.Parameter):
                continue            # a DTensor's shard is counted, a fake
                                    # tensor of its propagation is not
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live += n
            weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if types:
            from torch.distributed.tensor import DTensor
            if any(issubclass(t, DTensor) for t in types):
                # let DTensor run first (as CommDebugMode does): its local
                # ops and collectives come back here as plain tensors
                return NotImplemented
            # another subclass: DTensor's sharding propagation runs each
            # op once on fake tensors at the global shapes, which is no
            # rank's work
            from torch.utils._python_dispatch import _disable_current_modes
            with _disable_current_modes():
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        self.n_ops += 1
        packet = func._overloadpacket
        name = packet.__name__
        if packet in self._flops:
            f = int(self._flops[packet](*args, **kwargs, out_val=out))
            self.dot_flops += f
            self.by_op[name] += f
            if name in DOT_OPS:
                self.dot_bytes += sum(_nbytes(t) for t in _tensors(
                    (args, kwargs))) + sum(_nbytes(t) for t in _tensors(out))
        coll = COLLECTIVES.get(name)
        if coll is not None and func.namespace in COLLECTIVE_NAMESPACES:
            kind, side, factor = coll
            src = _tensors(out) if side == "out" else _tensors(args[:1])
            self.collective_bytes[kind] += factor * sum(
                _nbytes(t) for t in src)
            self.collective_calls[kind] += 1
        self._track(out)
        return out

    def summary(self) -> dict:
        """The counts as the reference's ``analyze_text`` names them."""
        coll = dict(self.collective_bytes)
        return {"dot_flops": self.dot_flops, "dot_bytes": self.dot_bytes,
                "collective_bytes": coll,
                "collective_total": sum(coll.values()),
                "collective_calls": dict(self.collective_calls),
                "flops_by_op": dict(self.by_op), "n_ops": self.n_ops,
                "peak_live_bytes": self.peak}
