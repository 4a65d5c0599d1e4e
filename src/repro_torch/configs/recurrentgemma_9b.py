"""recurrentgemma-9b [hybrid] — 38L d=4096 16H (MQA kv=1) head_dim 256
d_ff=12288 vocab=256000; RG-LRU + local attention 1:2 pattern, window
2048 [arXiv:2402.19427; unverified]. 38 = 12 x (rglru, rglru,
local_attn) + 2."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, head_dim=256, d_ff=12288, vocab_size=256000,
    block_pattern=("rglru", "rglru", "local_attn"), window=2048,
    activation="gelu_glu")


def smoke():
    return ModelConfig(
        name="rg-smoke", family="hybrid", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128, vocab_size=512,
        block_pattern=("rglru", "rglru", "local_attn"), window=16,
        activation="gelu_glu", dtype="float32", remat="none", attn_chunk=16)
