"""Phi-3.5-MoE 42B (6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    n_experts=16,
    moe_top_k=2,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b/smoke", family="moe",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
        vocab=512, n_experts=4, moe_top_k=2,
    )
