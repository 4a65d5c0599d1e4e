"""Optimizer: AdamW with ZeRO-1 (``adamw``) and int8 error-feedback
gradient compression (``compression``)."""
from repro_torch.optim import compression
from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                     apply_updates_sharded, global_norm,
                                     init_opt_state, schedule,
                                     zero1_placements)

__all__ = ["AdamWConfig", "apply_updates", "apply_updates_sharded",
           "compression", "global_norm", "init_opt_state", "schedule",
           "zero1_placements"]
