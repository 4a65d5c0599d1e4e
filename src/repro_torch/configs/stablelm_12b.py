"""stablelm-12b [dense] — 40L d=5120 32H (GQA kv=8) head_dim 160
d_ff=13824 vocab=100352 [hf:stabilityai/stablelm-2-1_6b; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, head_dim=160, d_ff=13824, vocab_size=100352,
    activation="silu_glu")


def smoke():
    return ModelConfig(
        name="stablelm-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=192, vocab_size=512,
        dtype="float32", remat="none", attn_chunk=32)
