"""qwen1.5-4b [dense] — 40L d=2560 20H (kv=20, MHA) d_ff=6912
vocab=151936; QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense", n_layers=40, d_model=2560,
    n_heads=20, n_kv_heads=20, head_dim=128, d_ff=6912, vocab_size=151936,
    qkv_bias=True, activation="silu_glu")


def smoke():
    return ModelConfig(
        name="qwen1.5-smoke", family="dense", n_layers=2, d_model=80,
        n_heads=5, n_kv_heads=5, head_dim=16, d_ff=160, vocab_size=512,
        qkv_bias=True, dtype="float32", remat="none", attn_chunk=32)
