"""whisper-tiny [audio] — enc-dec 4L+4L d=384 6H d_ff=1536 vocab=51865
[arXiv:2212.04356; unverified]. The conv frontend is a stub, as in the
reference: the encoder takes precomputed frame embeddings (B, seq//2,
d). RoPE replaces the original learned/sinusoidal positions, as in the
reference. It runs through ``forward``/``decode_step``; ``ModelServer``
takes decoder-only models."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio", n_layers=4, d_model=384,
    n_heads=6, n_kv_heads=6, head_dim=64, d_ff=1536, vocab_size=51865,
    encoder_layers=4, activation="gelu")


def smoke():
    return ModelConfig(
        name="whisper-smoke", family="audio", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        encoder_layers=2, activation="gelu", dtype="float32", remat="none",
        attn_chunk=16)
