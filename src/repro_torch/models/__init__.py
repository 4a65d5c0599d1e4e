"""The LM substrate's inference path: configs, blocks, prefill forward,
decode step (a port of the reference's ``models/`` for the ``attn``,
``local_attn`` and ``rwkv6`` blocks with the dense MLP)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models import transformer

__all__ = ["ModelConfig", "transformer"]
