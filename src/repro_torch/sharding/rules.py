"""Logical-axis sharding: one rules table per (arch, mesh).

The port of the reference's ``sharding/rules.py``, onto a
``torch.distributed`` ``DeviceMesh`` and DTensor placements. Model code
annotates activations with *logical* axis names via
``annotate(x, "batch", "seq", "embed")``, and parameters carry logical
axes by name pattern (:func:`param_axes`). :func:`make_rules` maps
logical axes to mesh axes per architecture, with the reference's table:

  head-TP archs (n_heads % model == 0): attention heads over "model";
  replicated-attention archs (qwen1.5 H=20, whisper H=6, granite-3b
      H=24): attention params replicated, the decode KV cache sharded
      over the *cache sequence* axis;
  rwkv6: the V channel ("rvalue") over "model"; rglru: "rnn" over model;
  MoE: the expert axis over "model" when divisible, else per-expert
      d_ff;
  residual stream: batch over ("pod", "data"), boundary activations
      sequence-sharded over "model" (Megatron sequence parallelism).

A rule maps a logical axis to a tuple of mesh axis names (or None: not
sharded). :func:`logical_to_spec` turns a tensor's logical axes into one
DTensor ``Placement`` per mesh dimension: ``Shard(d)`` on each mesh axis
that some tensor dimension ``d`` maps to, ``Replicate()`` elsewhere.

Parameter names are the port's (``embed.table``,
``layers.<i>.attn.wq.kernel``, ``encoder.<i>.mlp.wi.kernel``; see
:mod:`repro_torch.convert`), matched with their dots read as the
reference's ``/``. The port keeps one module per layer, so no leaf has
the reference's stacked leading layer axis: a rank that differs from
the pattern's raises.
"""
from __future__ import annotations

import contextlib
import re
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch

Rules = Dict[str, Optional[Tuple[str, ...]]]
Axes = Tuple[Optional[str], ...]


class _Active:
    """The (mesh, rules) in force. Process-wide, where the reference's is
    per thread: autograd runs a CUDA backward, and with it the recompute
    of every checkpointed (remat) region, on its own device threads,
    which must see the rules the forward ran under."""
    ctx = None


def _current():
    return _Active.ctx


@contextlib.contextmanager
def rules_context(mesh, rules: Optional[Rules]):
    """Activate (mesh, rules) for :func:`annotate` within the context."""
    prev = _current()
    _Active.ctx = (mesh, rules) if mesh is not None else None
    try:
        yield
    finally:
        _Active.ctx = prev


def logical_to_spec(axes: Axes, rules: Rules, mesh) -> tuple:
    """One DTensor placement per mesh dimension for a tensor whose
    dimensions carry the logical ``axes``. A mesh axis that two tensor
    dimensions would claim raises, as a PartitionSpec would."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out: List = [Replicate()] * len(names)
    for dim, ax in enumerate(axes):
        mapped = rules.get(ax) if ax is not None else None
        if mapped is None:
            continue
        if isinstance(mapped, str):
            mapped = (mapped,)
        for m in mapped:
            if m is None or m not in names:
                continue
            i = names.index(m)
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {m!r} claimed twice by {axes}")
            out[i] = Shard(dim)
    return tuple(out)


def _divisible(shape, placements, mesh) -> tuple:
    """``placements`` with every tensor dimension that the product of its
    mesh axes does not divide left replicated (the same values as the
    reference's padded shards, in another layout), and no shard over a
    mesh axis of size 1 (DTensor's views refuse to fold a dimension
    "sharded" one way, as a group axis of size 1)."""
    from torch.distributed.tensor import Replicate, Shard
    ways: Dict[int, int] = {}
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            ways[p.dim] = ways.get(p.dim, 1) * mesh.mesh.shape[i]
    return tuple(Replicate() if isinstance(p, Shard) and (
        shape[p.dim] % ways[p.dim] or mesh.mesh.shape[i] == 1) else p
        for i, p in enumerate(placements))


def annotate(x, *axes: Optional[str]):
    """Redistribute a DTensor to the placements its logical ``axes`` get
    under the active rules (the reference's ``with_sharding_constraint``).
    A dimension that its mesh axes do not divide stays replicated (XLA
    pads it instead). Outside :func:`rules_context`, and for a plain
    tensor, ``x`` is returned as it is."""
    ctx = _current()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    want = _divisible(x.shape, logical_to_spec(axes, rules, mesh), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def grad_as_placed(x):
    """``x`` itself, with its gradient made to arrive in ``x``'s own
    placements. DTensor leaves a gradient in whatever placements the
    later ops give it, and a view's backward cannot always take those
    (the unflatten of channels sharded 16 ways that do not hold whole
    heads). A plain tensor is returned as it is."""
    if not hasattr(x, "to_local"):
        return x
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def place_new(t: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """A tensor made inside the model (a decode cache's zeros), the same
    on every rank, as a DTensor placed by its logical ``axes`` under the
    active rules (the reference's ``annotate`` of a fresh array); outside
    :func:`rules_context`, ``t`` as it is."""
    ctx = _current()
    if ctx is None:
        return t
    mesh, rules = ctx
    return place(t, mesh, _divisible(
        t.shape, logical_to_spec(axes, rules, mesh), mesh))


def place_params(params: torch.nn.Module, mesh, placements: Mapping[str, tuple]
                 ) -> torch.nn.Module:
    """A copy of ``params`` (the same on every rank) whose parameters are
    DTensors of ``placements`` ({name: placements}, e.g.
    :func:`param_placements`), each rank keeping its own shards."""
    import copy
    params = copy.deepcopy(params)
    for name, p in list(params.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        setattr(params.get_submodule(mod_name), leaf, torch.nn.Parameter(
            place(p.detach(), mesh, placements[name]),
            requires_grad=p.requires_grad))
    return params


# ---------------------------------------------------------------------------
# the global batch seen from one slice
# ---------------------------------------------------------------------------
class BatchSlices(NamedTuple):
    """How the global batch is split where the code runs: ``n`` slices
    along its first axis over the mesh dimensions that ``placements``
    shard, in mesh order (:func:`repro_torch.train.step.batch_shard`'s
    order), this rank holding slice ``index``."""
    mesh: Any
    placements: tuple
    n: int
    index: int

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """(n, *t.shape): every slice's ``t``, in slice order (no
        gradient)."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        pl = tuple(Shard(0) if p != Replicate() else Replicate()
                   for p in self.placements)
        return DTensor.from_local(t.detach()[None], self.mesh, pl,
                                  run_check=False).full_tensor()

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the slices of each slice's ``t`` (a replicated
        DTensor; its gradient reaches every slice's ``t`` whole)."""
        from torch.distributed.tensor import DTensor, Partial, Replicate
        pl = tuple(Partial() if p != Replicate() else Replicate()
                   for p in self.placements)
        return DTensor.from_local(t, self.mesh, pl, run_check=False
                                  ).redistribute(
            self.mesh, (Replicate(),) * self.mesh.ndim)


def slices_of(mesh, placements) -> BatchSlices:
    """The :class:`BatchSlices` of a batch placed by ``placements`` (one
    per mesh dimension, a shard of the batch axis where it is split; none
    given: replicated, one slice)."""
    from torch.distributed.tensor import Replicate
    placements = tuple(placements) or (Replicate(),) * mesh.ndim
    n, i = 1, 0
    for d, p in enumerate(placements):
        if p != Replicate():
            size = mesh.mesh.shape[d]
            n, i = n * size, i * size + mesh.get_local_rank(d)
    return BatchSlices(mesh, tuple(placements), n, i)


class _Slices:
    """The batch slices in force for plain tensors (the "dp" step's):
    process-wide, as :class:`_Active`."""
    ctx: Optional[BatchSlices] = None


@contextlib.contextmanager
def slices_context(slices: Optional[BatchSlices]):
    """Within the context, plain tensors are this rank's slice of the
    global batch ("dp"): code whose result depends on the whole batch
    (MoE's groups, capacities and aux loss) reads it from
    :func:`batch_slices`."""
    prev = _Slices.ctx
    _Slices.ctx = slices
    try:
        yield
    finally:
        _Slices.ctx = prev


def batch_slices(x: torch.Tensor) -> Optional[BatchSlices]:
    """The slices of the global batch that ``x`` (batch axis first) is
    one of: a DTensor's from its placements on its first axis, a plain
    tensor's from :func:`slices_context`; None for the whole batch on one
    device."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(x, DTensor):
        pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                   for p in x.placements)
        s = slices_of(x.device_mesh, pl)
        return s if s.n > 1 else None
    s = _Slices.ctx
    return s if s is not None and s.n > 1 else None


def place(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """A full tensor, the same on every rank, as a DTensor of
    ``placements``: each rank keeps its own chunk, with no
    communication."""
    from torch.distributed.tensor import DTensor, Replicate
    full = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)
    return full.redistribute(mesh, tuple(placements))


# ---------------------------------------------------------------------------
# parameter logical axes by name pattern
# ---------------------------------------------------------------------------
#: pattern -> logical axes, matched against the name with ``.`` as ``/``
_PARAM_PATTERNS: Tuple[Tuple[str, Axes], ...] = (
    (r"(?:^|.*/)embed/table$", ("vocab", "embed")),
    (r"(?:^|.*/)lm_head/kernel$", ("embed", "vocab")),
    (r"(?:^|.*/).*(attn|xattn)/w[qQ]/kernel$", ("embed", "heads", "head_dim")),
    (r"(?:^|.*/).*(attn|xattn)/w[kv]/kernel$", ("embed", "kv_heads", "head_dim")),
    (r"(?:^|.*/).*(attn|xattn)/wo/kernel$", ("heads", "head_dim", "embed")),
    (r"(?:^|.*/).*(attn|xattn)/w[qQ]/bias$", ("heads", "head_dim")),
    (r"(?:^|.*/).*(attn|xattn)/w[kv]/bias$", ("kv_heads", "head_dim")),
    (r"(?:^|.*/).*(attn|xattn)/wo/bias$", ("embed",)),
    (r"(?:^|.*/)(q|k)_norm/scale$", ("head_dim",)),
    (r"(?:^|.*/)mlp/wi/kernel$", ("embed", "mlp")),
    (r"(?:^|.*/)mlp/wg/kernel$", ("embed", "mlp")),
    (r"(?:^|.*/)mlp/wo/kernel$", ("mlp", "embed")),
    (r"(?:^|.*/)moe/router/kernel$", ("embed", "experts")),
    (r"(?:^|.*/)moe/wi/kernel$", ("experts", "embed", "mlp")),
    (r"(?:^|.*/)moe/wg/kernel$", ("experts", "embed", "mlp")),
    (r"(?:^|.*/)moe/wo/kernel$", ("experts", "mlp", "embed")),
    (r"(?:^|.*/)rwkv/w_(r|k|w)/kernel$", ("embed", "embed2")),
    (r"(?:^|.*/)rwkv/w_(v|g)/kernel$", ("embed", "rvalue_flat")),
    (r"(?:^|.*/)rwkv/w_out/kernel$", ("rvalue_flat", "embed")),
    (r"(?:^|.*/)rwkv/mix_.*$", ("embed",)),
    (r"(?:^|.*/)rwkv/lora_(a)$", ("embed", "lora")),
    (r"(?:^|.*/)rwkv/lora_(b)$", ("lora", "embed")),
    (r"(?:^|.*/)rwkv/u$", ("rheads", "rkey")),
    (r"(?:^|.*/)rwkv/w_base$", ("embed",)),
    (r"(?:^|.*/)rwkv/ln_(scale|bias)$", ("rvalue_flat",)),
    (r"(?:^|.*/)rglru/w_(x|gate)/kernel$", ("embed", "rnn")),
    (r"(?:^|.*/)rglru/w_out/kernel$", ("rnn", "embed")),
    (r"(?:^|.*/)rglru/conv_w$", ("conv", "rnn")),
    (r"(?:^|.*/)rglru/conv_b$", ("rnn",)),
    (r"(?:^|.*/)rglru/(wi|wr)/kernel$", ("embed", "rnn")),
    (r"(?:^|.*/)rglru/(wi|wr)/bias$", ("rnn",)),
    (r"(?:^|.*/)rglru/lam$", ("rnn",)),
    (r".*norm.*/(scale|bias)$", ("embed",)),
    (r"(?:^|.*/)bias$", ("mlp",)),           # mlp wi bias (rare)
)


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def axes_of(name: str, ndim: int) -> Axes:
    """The logical axes of the parameter ``name`` of rank ``ndim``."""
    spath = name.replace(".", "/")
    for pat, axes in _PARAM_PATTERNS:
        if re.match(pat, spath):
            if len(axes) != ndim:
                raise ValueError(f"{name}: rank {ndim} vs axes {axes}")
            return axes
    raise ValueError(f"no axis rule for param {name}")


def param_axes(params) -> Dict[str, Axes]:
    """{name: logical axes} of a model's parameters (a module, or a
    mapping of names to tensors, ``meta`` ones included)."""
    return {k: axes_of(k, t.dim()) for k, t in _named(params).items()}


def param_placements(params, mesh, rules: Rules) -> Dict[str, tuple]:
    """{name: DTensor placements} of a model's parameters on ``mesh``."""
    return {k: logical_to_spec(a, rules, mesh)
            for k, a in param_axes(params).items()}


# ---------------------------------------------------------------------------
# per-arch rule construction
# ---------------------------------------------------------------------------
def _mesh_shape(mesh) -> Mapping[str, int]:
    """{axis name: size} of a DeviceMesh, or of a mapping given as one
    (a mesh's shape without its process group, as the tests use)."""
    if isinstance(mesh, Mapping):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def make_rules(cfg, mesh, *, batch_size: Optional[int] = None,
               seq_shard_boundary: bool = True,
               profile: str = "tp") -> Rules:
    """Logical->mesh mapping for a ModelConfig on a mesh (a DeviceMesh,
    or a mapping of axis names to sizes).

    profile:
      "tp" — the model axis carries vocab/mlp/heads tensor parallelism
             (+ sequence-parallel boundaries);
      "dp" — pure data parallelism: the model axis joins the batch axes
             and parameters replicate (ZeRO-1 still shards the optimizer
             state over the data axes).
    """
    shape = _mesh_shape(mesh)
    names = tuple(shape)
    model_ax = "model" if "model" in names else None
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    msize = shape["model"] if model_ax else 1
    dsize = 1
    for a in data_axes:
        dsize *= shape[a]

    if profile == "dp" and model_ax:
        batch_axes: Optional[Tuple[str, ...]] = data_axes + (model_ax,)
        total = dsize * msize
        if batch_size is not None and batch_size % total:
            batch_axes = (data_axes if batch_size % max(dsize, 1) == 0
                          else None)
        none_rules: Rules = {k: None for k in (
            "seq", "seq_boundary", "embed", "embed2", "vocab", "mlp",
            "heads", "kv_heads", "kv_heads_act", "head_dim",
            "cache_kv_heads", "cache_seq", "experts", "expert_mlp",
            "capacity", "rheads", "rkey", "rvalue", "rvalue_flat",
            "lora", "rnn", "conv", "frames")}
        none_rules["batch"] = batch_axes
        return none_rules

    head_tp = (cfg.n_heads % msize == 0) if msize > 1 else False
    moe_ep = cfg.is_moe and cfg.n_experts % msize == 0

    batch = data_axes if data_axes else None
    if batch_size is not None and batch_size % max(dsize, 1):
        batch = None    # batch-1 decode shapes: leave data idle

    rules: Rules = {
        "batch": batch,
        "seq": None,
        # Megatron-style sequence parallelism on residual boundaries
        "seq_boundary": (model_ax,) if seq_shard_boundary else None,
        "embed": None,
        "embed2": None,
        "vocab": (model_ax,),
        "mlp": (model_ax,),
        "heads": (model_ax,) if head_tp else None,
        # params keep the raw KV head count (may not divide the mesh);
        # activations are annotated post-expansion with kv_heads_act
        "kv_heads": ((model_ax,) if head_tp
                     and cfg.n_kv_heads % msize == 0 else None),
        "kv_heads_act": (model_ax,) if head_tp else None,
        "head_dim": None,
        # decode KV cache: heads when head-TP, else cache-sequence
        "cache_kv_heads": (model_ax,) if head_tp else None,
        "cache_seq": None if head_tp else (model_ax,),
        "experts": (model_ax,) if moe_ep else None,
        "expert_mlp": None if moe_ep else (model_ax,),
        "capacity": None,
        # rwkv: shard the V channel of the state everywhere it appears
        "rheads": None,
        "rkey": None,
        "rvalue": (model_ax,),
        "rvalue_flat": (model_ax,),
        "lora": None,
        "rnn": (model_ax,),
        "conv": None,
        # frames for the audio encoder stub
        "frames": None,
    }
    if moe_ep:
        # experts carry the model axis; per-expert d_ff stays local
        rules["mlp"] = None
    return rules
