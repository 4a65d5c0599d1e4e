"""chameleon-34b [vlm] — 48L d=8192 64H (GQA kv=8) d_ff=22016
vocab=65536; early fusion: VQ image tokens share the text vocabulary
[arXiv:2405.09818; unverified]. The VQ tokenizer is a stub, as in the
reference: inputs are mixed text/image token ids. qk_norm per the
paper's training-stability recipe."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm", n_layers=48, d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=22016, vocab_size=65536,
    qk_norm=True, activation="silu_glu")


def smoke():
    return ModelConfig(
        name="chameleon-smoke", family="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        qk_norm=True, dtype="float32", remat="none", attn_chunk=32)
