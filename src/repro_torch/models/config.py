"""Model configuration of the LM substrate.

A copy of the reference package's ``models/config.py`` with every field
and property, kept here because the port imports nothing of the
reference. One field differs: ``attention_impl`` takes the port's routes
(see :data:`ATTENTION_IMPLS`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: ``attention_impl`` routes. ``"kernel"`` (the default, the counterpart
#: of the reference's ``"pallas"``/``"interpret"``) launches the Hopper
#: kernels on CUDA tensors and runs their plain versions on CPU tensors;
#: ``"ref"`` (plain einsum attention, plain WKV6 loop) and ``"blocked"``
#: (online-softmax tiles in plain PyTorch) never launch a kernel.
ATTENTION_IMPLS = ("ref", "blocked", "kernel")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab_size: int
    n_kv_heads: Optional[int] = None
    head_dim: Optional[int] = None

    # block composition; cycled over layers. Entries:
    #   attn | local_attn | rwkv6 | rglru
    block_pattern: Tuple[str, ...] = ("attn",)
    window: Optional[int] = None   # local attention window

    # dense-MLP variant
    activation: str = "silu_glu"   # silu_glu | gelu | sq_relu
    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    # encoder-decoder (whisper): n_layers == decoder layers
    encoder_layers: int = 0
    # rwkv
    rwkv_head_dim: int = 64
    rwkv_lora_rank: int = 64
    # rglru
    conv_width: int = 4
    lru_c: float = 8.0

    # numerics / implementation
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    kv_repeat: int = 1                # virtual KV-head expansion
    kv_cache_dtype: str = "bfloat16"  # bfloat16 | int8 (scale-quantized)
    attention_impl: str = "kernel"    # see ATTENTION_IMPLS
    attn_chunk: int = 512             # q/kv chunk for blocked attention
    wkv_chunk: int = 64
    norm_eps: float = 1e-6
    remat: str = "layer"              # none | layer (checkpoint per period)
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.n_kv_heads is None:
            object.__setattr__(self, "n_kv_heads", self.n_heads)
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads={self.n_heads} is not a multiple of "
                             f"n_kv_heads={self.n_kv_heads}")
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of "
                             f"{ATTENTION_IMPLS}, got {self.attention_impl!r}")

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def blocks(self) -> Tuple[str, ...]:
        """Per-layer block kinds, pattern cycled to n_layers."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    @property
    def attention_free(self) -> bool:
        return all(b in ("rwkv6", "rglru") for b in self.blocks)

    @property
    def sub_quadratic(self) -> bool:
        """True if no block needs a full-length dense KV cache."""
        return all(b != "attn" for b in self.blocks)

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline cross-checks)."""
        d, f, V = self.d_model, self.d_ff, self.vocab_size
        hd, H, KV = self.head_dim, self.n_heads, self.n_kv_heads
        total = V * d                                   # embed
        if not self.tie_embeddings:
            total += V * d                              # lm head
        for kind in self.blocks:
            if kind in ("attn", "local_attn"):
                total += d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d
            elif kind == "rwkv6":
                K = self.rwkv_head_dim
                nh = d // K
                total += 5 * d * d + d                  # r,k,v,g,out + shift
                total += 2 * d * self.rwkv_lora_rank    # w lora
                total += nh * K                         # u
            elif kind == "rglru":
                total += 2 * d * d + d * self.conv_width + 3 * d
            if self.is_moe:
                total += d * self.n_experts             # router
                total += self.n_experts * 3 * d * f     # gated experts
            else:
                n_mats = 3 if self.activation.endswith("_glu") else 2
                total += n_mats * d * f
            total += 2 * d                              # norms
        if self.is_enc_dec:
            # encoder layers + decoder cross-attention
            enc = self.encoder_layers * (
                d * (H * hd) * 2 + 2 * d * (KV * hd)
                + 2 * d * f + 2 * d)
            xattn = self.n_layers * (
                d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d + d)
            total += enc + xattn
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE top-k) for 6·N_active·D."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        inactive = (self.n_experts - self.moe_top_k) * 3 * d * f
        return self.param_count() - self.n_layers * inactive
