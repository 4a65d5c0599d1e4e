"""nemotron-4-15b [dense] — 32L d=6144 48H (GQA kv=8) d_ff=24576
vocab=256000; squared-ReLU MLP [arXiv:2402.16819; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense", n_layers=32, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=24576, vocab_size=256000,
    activation="sq_relu")


def smoke():
    return ModelConfig(
        name="nemotron-smoke", family="dense", n_layers=2, d_model=96,
        n_heads=6, n_kv_heads=2, head_dim=16, d_ff=384, vocab_size=512,
        activation="sq_relu", dtype="float32", remat="none", attn_chunk=32)
