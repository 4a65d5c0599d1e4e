"""Abstract inputs and their placements for every (arch x shape) cell.

The port of the reference's ``launch/specs.py``. Its ``ShapeDtypeStruct``
stand-ins become ``meta`` tensors (shapes and dtypes, no allocation),
and its shardings become DTensor placements on a ``DeviceMesh``
(:mod:`repro_torch.sharding.rules`): :func:`input_specs` builds a cell's
data inputs (a decode cache from ``T.init_cache(..., device="meta")``),
:func:`batch_placements`, :func:`cache_placements` and
:func:`train_state_placements` place them and the train state.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import Rules, _mesh_shape, logical_to_spec

META = torch.device("meta")


def tune_for_mesh(cfg: ModelConfig, mesh) -> ModelConfig:
    """Set kv_repeat so expanded KV heads divide the model axis (``mesh``
    a DeviceMesh or a mapping of axis names to sizes)."""
    msize = _mesh_shape(mesh).get("model", 1)
    if msize > 1 and cfg.n_heads % msize == 0:
        r = math.lcm(cfg.n_kv_heads, msize) // cfg.n_kv_heads
        if r * cfg.n_kv_heads <= cfg.n_heads:
            return dataclasses.replace(cfg, kv_repeat=r)
    return cfg


def split_lens(cfg: ModelConfig, seq_len: int) -> Tuple[int, int]:
    """(encoder_len, decoder_len): enc-dec archs split the token budget."""
    if cfg.is_enc_dec:
        return seq_len // 2, seq_len // 2
    return 0, seq_len


def _frames(cfg: ModelConfig, B: int, enc_len: int) -> torch.Tensor:
    return torch.empty((B, enc_len, cfg.d_model),
                       dtype=layers.dtype_of(cfg.dtype), device=META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                abstract_params: Optional[T.Transformer] = None
                ) -> Dict[str, Any]:
    """``meta`` stand-ins for the step function's data inputs: tokens and
    labels (int32; ``enc_frames`` for an encoder-decoder) for train,
    tokens for prefill, one token per sequence and the cache of
    ``seq_len - 1`` tokens for decode (an encoder-decoder's cross keys
    and values computed on ``meta`` from ``abstract_params``)."""
    B = shape.global_batch
    enc_len, dec_len = split_lens(cfg, shape.seq_len)
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        out = {"tokens": torch.empty((B, dec_len), dtype=i32, device=META)}
        if shape.kind == "train":
            out["labels"] = torch.empty((B, dec_len), dtype=i32, device=META)
        if cfg.is_enc_dec:
            out["enc_frames"] = _frames(cfg, B, enc_len)
        return out
    if shape.kind == "decode":
        with torch.no_grad():
            cache = T.init_cache(
                cfg, B, dec_len, start_len=dec_len - 1, device=META,
                params=abstract_params,
                enc_frames=_frames(cfg, B, enc_len) if cfg.is_enc_dec
                else None)
        return {"tokens": torch.empty((B, 1), dtype=i32, device=META),
                "cache": cache}
    raise ValueError(shape.kind)


#: cache-leaf path ("<layer>/<leaf>") -> logical axes; the reference's
#: patterns, its cross-attention keys and values named as the port's
_CACHE_PATTERNS = (
    (r".*/(k|v|k_scale|v_scale|cross_k|cross_v)$",
     ("batch", "cache_kv_heads", "cache_seq", "head_dim")),
    (r".*/len$", ("batch",)),
    (r".*/wkv$", ("batch", "rheads", "rkey", "rvalue")),
    (r".*/shift$", ("batch", "embed")),
    (r".*/conv$", ("batch", None, "rnn")),
    (r".*/h$", ("batch", "rnn")),
)


def cache_axes(path: str, ndim: int) -> tuple:
    """The logical axes of the cache leaf at ``path``."""
    for pat, axes in _CACHE_PATTERNS:
        if re.match(pat, path):
            if len(axes) != ndim:
                raise ValueError(f"{path}: rank {ndim} vs {axes}")
            return axes
    raise ValueError(f"no cache axis rule for {path}")


def cache_placements(cache: T.Cache, mesh, rules: Rules
                     ) -> List[Dict[str, tuple]]:
    """The placements of each cache leaf, leaf by leaf, as the
    reference's ``cache_shardings``."""
    return [{k: logical_to_spec(cache_axes(f"{i}/{k}", t.dim()), rules,
                                mesh)
             for k, t in c.items()} for i, c in enumerate(cache)]


def batch_placements(batch: Dict[str, torch.Tensor], mesh, rules: Rules
                     ) -> Dict[str, tuple]:
    """Every batch leaf split along its first axis over the rules'
    ``batch`` axes."""
    spec = logical_to_spec(("batch",), rules, mesh)
    return {k: spec for k in batch}


def abstract_params(cfg: ModelConfig) -> T.Transformer:
    """The model's parameters on ``meta``."""
    return T.Transformer(cfg, device=META)


def abstract_train_state(cfg: ModelConfig) -> Dict[str, Any]:
    """A train state ({"params", "opt": {"m", "v", "step"}}) on ``meta``."""
    from repro_torch.optim.adamw import init_opt_state
    params = abstract_params(cfg)
    params.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(params)}


def train_state_placements(params, cfg: ModelConfig, mesh, rules: Rules):
    """{"params": {name: placements}, "opt": {"m", "v", "step"}} of a
    train state (:func:`repro_torch.train.step.train_state_shardings`)."""
    from repro_torch.train.step import train_state_shardings
    return train_state_shardings(params, cfg, mesh, rules)
