"""Optimizer: AdamW (``adamw``) and int8 error-feedback gradient
compression (``compression``)."""
from repro_torch.optim import compression
from repro_torch.optim.adamw import (AdamWConfig, apply_updates, global_norm,
                                     init_opt_state, schedule)

__all__ = ["AdamWConfig", "apply_updates", "compression", "global_norm",
           "init_opt_state", "schedule"]
