"""Whisper-tiny [arXiv:2212.04356] — enc-dec; mel+conv frontend stubbed.

``batch["frames"]`` carries precomputed audio frame embeddings (1500, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=4,              # decoder layers
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    is_encoder_decoder=True,
    enc_seq=1500,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny/smoke", family="audio",
        n_layers=2, n_enc_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
        d_ff=256, vocab=512, is_encoder_decoder=True, enc_seq=64,
    )
