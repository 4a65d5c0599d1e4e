"""Primitive layers: norms, dense, RoPE, activations.

The port of the reference's ``models/layers.py``. Parameters live in
small ``nn.Module``s whose attribute names are the reference's leaf names
(``Dense.kernel``/``bias``, ``RMSNorm.scale``); the computations are plain
functions on tensors, as in the reference. Parameters are made without
gradients (serving needs none); training turns them on for the model it
owns (``repro_torch.train.init_train_state``).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def truncated_normal(shape, stddev: float, *, generator, device,
                     dtype=torch.float32) -> torch.Tensor:
    """``stddev`` times a standard normal truncated to [-2, 2], drawn in
    f32 from ``generator`` (which must live on ``device``); empty when
    ``generator`` is None (the tensor is filled later, e.g. by
    :func:`repro_torch.convert.params`)."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if generator is not None:
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        t.mul_(stddev)
    return t.to(dtype)


def param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Dense(nn.Module):
    """Kernel (in_dim, *out_shape) with fan-in init, optional zero bias."""

    #: leaves that every use casts to the activations' dtype (``dense``;
    #: the attention output projection); see
    #: ``transformer.cast_for_compute``
    compute_cast = ("kernel", "bias")

    def __init__(self, in_dim: int, out_shape: Union[int, Sequence[int]], *,
                 bias: bool = False, dtype=torch.float32,
                 stddev: Optional[float] = None, generator=None, device=None):
        super().__init__()
        out_shape = ((out_shape,) if isinstance(out_shape, int)
                     else tuple(out_shape))
        stddev = stddev if stddev is not None else in_dim ** -0.5
        self.kernel = param(truncated_normal(
            (in_dim,) + out_shape, stddev, generator=generator,
            device=device, dtype=dtype))
        self.bias = (param(torch.zeros(out_shape, dtype=dtype, device=device))
                     if bias else None)


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """x (..., in) @ kernel (in, *out) -> (..., *out), the kernel cast to
    x's dtype (as the reference's ``dot_general`` operand)."""
    w = p.kernel
    out_shape = w.shape[1:]
    y = x @ w.reshape(w.shape[0], -1).to(x.dtype)
    y = y.reshape(x.shape[:-1] + out_shape)
    if p.bias is not None:
        y = y + p.bias.to(x.dtype)
    return y


class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = param(torch.ones((dim,), dtype=dtype, device=device))


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p.scale.float()).to(x.dtype)


def groupnorm(scale, bias, x: torch.Tensor, n_groups: int,
              eps: float = 1e-5) -> torch.Tensor:
    """x (..., n_groups*gdim) normalized per group (RWKV6 head-wise LN)."""
    shape = x.shape
    x32 = x.reshape(shape[:-1] + (n_groups, shape[-1] // n_groups)).float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    y = ((x32 - mu) * torch.rsqrt(var + eps)).reshape(shape)
    return (y * scale + bias).to(x.dtype)


def activation(name: str, x: torch.Tensor, gate=None) -> torch.Tensor:
    if name == "silu_glu":
        return F.silu(gate) * x
    if name == "gelu_glu":
        return F.gelu(gate, approximate="tanh") * x
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "sq_relu":
        return F.relu(x).square()
    raise ValueError(name)


@functools.lru_cache(maxsize=None)
def _rope_freq(half: int, theta: float, device: torch.device):
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def rope_angles(positions: torch.Tensor, half: int, theta: float,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the f32 angles for positions (B, T) or (T,), shaped
    (B, T, 1, half) to broadcast over heads."""
    if positions.dim() == 1:
        positions = positions[None, :]
    freq = _rope_freq(half, theta, torch.device(device))  # made once
    ang = positions[..., None].float() * freq                 # (B,T,half)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate x (B, T, H, D) by angles from :func:`rope_angles`."""
    half = x.shape[-1] // 2
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x (B, T, H, D), positions (B, T) or (T,) -> rotated x, with the
    angles in f32."""
    return apply_rope(x, *rope_angles(positions, x.shape[-1] // 2, theta,
                                      x.device))
