"""Carry state across from the reference package.

Each function takes plain values — numpy arrays, or objects with the
reference's field names — and returns the port's structure, so the
parity tests can feed both packages the same mid-run state. Nothing
here imports the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core.geometry import GpuGeometry
from repro_torch.core.simulator import Trace
from repro_torch.core.tagarray import TagState
from repro_torch.core.trace.serving import RequestStream
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import ServingConfig


def tag_state(arrays: Mapping[str, np.ndarray], *, device) -> TagState:
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


def request_stream(ref_stream) -> RequestStream:
    """A reference ``RequestStream`` (or anything with its fields) as the
    port's, so both packages replay the same stream. The directory starts
    empty in both; the stream is all the state there is."""
    return RequestStream(valid=np.asarray(ref_stream.valid),
                         hashes=np.asarray(ref_stream.hashes),
                         n_blocks=np.asarray(ref_stream.n_blocks),
                         tenant=np.asarray(ref_stream.tenant),
                         tenants=tuple(ref_stream.tenants),
                         slots=int(ref_stream.slots))


def serving_config(ref_cfg) -> ServingConfig:
    """A reference ``ServingConfig`` as the port's. The two packages'
    probe backends differ, so the port's stays its device default."""
    return ServingConfig(**{
        f.name: getattr(ref_cfg, f.name)
        for f in dataclasses.fields(ServingConfig)
        if f.name != "probe_backend"})


def model_config(ref_cfg) -> ModelConfig:
    """A reference ``ModelConfig`` as the port's. The reference's kernel
    routes ("pallas", "interpret") become the port's "kernel"."""
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ModelConfig)}
    impl = kw["attention_impl"]
    kw["attention_impl"] = "kernel" if impl in ("pallas", "interpret") \
        else impl
    return ModelConfig(**kw)


def _tensor(a, device, dtype=None) -> torch.Tensor:
    """A reference leaf (through ``np.asarray``) as a tensor; bfloat16
    goes through float32, which holds it exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=dtype or torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _leaves(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _layer_index(cfg: ModelConfig):
    return {(stack, name, g): i for i, (stack, name, g)
            in enumerate(transformer.layer_keys(cfg))}


def _port_leaves(ref_tree, cfg: ModelConfig
                 ) -> Iterator[Tuple[str, np.ndarray]]:
    """(port parameter name, array) for every leaf of a tree shaped as the
    reference's parameters (the parameters themselves, or the optimizer's
    moments): each stacked leaf of ``layers`` is split along its leading
    period axis onto the layers that run in that period, in the
    reference's ``sorted(name)`` order; each of ``encoder`` along its
    layer axis onto ``encoder.<i>``."""
    index = _layer_index(cfg)
    for path, leaf in _leaves(ref_tree):
        stack = path[0]
        if stack == "layers":
            a = np.asarray(leaf)
            for g in range(a.shape[0]):
                i = index[(stack, path[1], g)]
                yield ".".join((stack, str(i)) + path[2:]), a[g]
        elif stack == "encoder":          # stacked {"p0_attn": block}
            a = np.asarray(leaf)
            for g in range(a.shape[0]):
                yield ".".join((stack, str(g)) + path[2:]), a[g]
        elif stack == "layers_rem":
            i = index[(stack, path[1], None)]
            yield ".".join(("layers", str(i)) + path[2:]), leaf
        else:
            yield ".".join(path), leaf


def _fill(port: Mapping[str, torch.Tensor], ref_tree, cfg: ModelConfig,
          device, what: str) -> None:
    """Copy every leaf of ``ref_tree`` into its port tensor. Every
    reference leaf must land on exactly one port tensor, and every port
    tensor must be filled: a leftover, repeated or missing leaf raises."""
    filled = set()
    for name, a in _port_leaves(ref_tree, cfg):
        if name not in port:
            raise KeyError(f"{what}: reference leaf {name} has no port "
                           "tensor")
        if name in filled:
            raise KeyError(f"{what}: reference leaf {name} given twice")
        t = port[name]
        src = _tensor(a, device, t.dtype)
        if src.shape != t.shape:
            raise ValueError(f"{name}: reference shape {tuple(src.shape)}, "
                             f"port {tuple(t.shape)}")
        t.data.copy_(src)
        filled.add(name)
    missing = set(port) - filled
    if missing:
        raise KeyError(f"{what}: port tensors with no reference leaf: "
                       f"{sorted(missing)}")


def params(ref_params, cfg: ModelConfig, *, device
           ) -> transformer.Transformer:
    """The reference's parameter pytree as the port's module (see
    :func:`_port_leaves` for the map)."""
    model = transformer.Transformer(cfg, device=device)
    _fill(dict(model.named_parameters()), ref_params, cfg, device,
          "parameters")
    return model


def train_state(ref_state, cfg: ModelConfig, *, device) -> Dict[str, object]:
    """The reference's train state ``{"params", "opt": {"m", "v",
    "step"}}`` as the port's (``repro_torch.train``): the parameters made
    trainable, ``m`` and ``v`` f32 tensors keyed by the parameters' names
    (they have the parameters' tree, so the same map), ``step`` int32."""
    model = params(ref_state["params"], cfg, device=device)
    model.requires_grad_(True)
    opt = {}
    for key in ("m", "v"):
        opt[key] = {name: torch.empty(p.shape, dtype=torch.float32,
                                      device=device)
                    for name, p in model.named_parameters()}
        _fill(opt[key], ref_state["opt"][key], cfg, device, f"opt {key}")
    opt["step"] = torch.tensor(int(np.asarray(ref_state["opt"]["step"])),
                               dtype=torch.int32, device=device)
    return {"params": model, "opt": opt}


def cache(ref_cache, cfg: ModelConfig, *, device) -> transformer.Cache:
    """The reference's decode cache (stacked by period) as the port's
    list of per-layer dicts, so decode parity can start mid-run. An
    encoder-decoder's ``cache["cross"][name]`` (k, v stacked by period)
    becomes each stacked layer's ``cross_k``/``cross_v``."""
    cross = ref_cache.get("cross", {})
    out = []
    for stack, name, g in transformer.layer_keys(cfg):
        src = dict(ref_cache[stack][name])
        if stack == "layers" and name in cross:
            src.update(zip(transformer.CROSS_KEYS,
                           (cross[name]["k"], cross[name]["v"])))
        out.append({k: _tensor(np.asarray(a)[g] if g is not None else a,
                               device) for k, a in src.items()})
    return out
