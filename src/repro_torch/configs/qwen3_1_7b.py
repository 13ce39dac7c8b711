"""Qwen3-1.7B [hf:Qwen/Qwen3-8B family] — GQA + qk-norm."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab=151936,
    qk_norm=True,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b/smoke", family="dense",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
        qk_norm=True, tie_embeddings=True,
    )
