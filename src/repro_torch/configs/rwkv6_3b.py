"""rwkv6-3b [ssm] — RWKV-6 "Finch": 32L, d=2560, attn-free,
data-dependent decay [arXiv:2404.05892; hf]. 40 WKV heads of 64.
Channel-mix approximated by a squared-ReLU FFN, as in the reference.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm", n_layers=32, d_model=2560,
    n_heads=40, n_kv_heads=40, head_dim=64, d_ff=8960, vocab_size=65536,
    block_pattern=("rwkv6",), activation="sq_relu", rwkv_head_dim=64)


def smoke():
    return ModelConfig(
        name="rwkv6-smoke", family="ssm", n_layers=2, d_model=128,
        n_heads=2, head_dim=64, d_ff=256, vocab_size=512,
        block_pattern=("rwkv6",), activation="sq_relu", rwkv_head_dim=64,
        dtype="float32", remat="none")
