"""Checkpointing: one ``.npy`` a leaf beside a manifest, atomic rename,
async save (``store``)."""
from repro_torch.checkpoint.store import CheckpointStore

__all__ = ["CheckpointStore"]
