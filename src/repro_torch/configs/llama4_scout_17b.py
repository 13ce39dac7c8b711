"""Llama-4 Scout 17B-A 16E [hf:meta-llama/Llama-4-Scout-17B-16E] — MoE top-1."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    n_experts=16,
    moe_top_k=1,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e/smoke", family="moe",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
        n_experts=4, moe_top_k=1,
    )
