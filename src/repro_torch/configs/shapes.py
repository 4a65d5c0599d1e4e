"""The assigned input-shape set (the same four cells for every LM arch),
a copy of the reference's ``configs/shapes.py``.

train_* is a training step; prefill_* a full-sequence forward;
decode_*/long_* a serving step (one new token against a KV cache of
seq_len). long_500k needs sub-quadratic attention and runs only for the
SSM and hybrid archs.
"""
import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable(cfg, shape: ShapeSpec) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the skip reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention arch: 0.5M-token dense KV cache is the "
                "quadratic cost this shape excludes (DESIGN.md)")
    return None
