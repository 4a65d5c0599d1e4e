"""granite-moe-3b-a800m [moe] — 32L d=1536 24H (GQA kv=8) per-expert
d_ff=512, vocab=49155, 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, head_dim=64, d_ff=512, vocab_size=49155,
    n_experts=40, moe_top_k=8, activation="silu_glu")


def smoke():
    return ModelConfig(
        name="granite3b-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32, vocab_size=512,
        n_experts=5, moe_top_k=2, dtype="float32", remat="none",
        attn_chunk=32)
