"""The training data pipeline (``pipeline``) and the reference fixtures
(``reference_*.json``, found by path) that the card checks read."""
from repro_torch.data.pipeline import DataConfig, iterate, make_batch

__all__ = ["DataConfig", "iterate", "make_batch"]
