"""qwen3-0.6b [dense] — 28L d=1024 16H (GQA kv=8) d_ff=3072
vocab=151936; qk_norm [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense", n_layers=28, d_model=1024,
    n_heads=16, n_kv_heads=8, head_dim=128, d_ff=3072, vocab_size=151936,
    qk_norm=True, activation="silu_glu", rope_theta=1e6)


def smoke():
    return ModelConfig(
        name="qwen3-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        qk_norm=True, dtype="float32", remat="none", attn_chunk=32)
