"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B] — fine-grained MoE 64e top-6."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    source="hf:moonshotai/Moonlight-16B-A3B",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,               # per-expert ffn (DeepSeek-V3-style fine-grained experts)
    vocab=163840,
    n_experts=64,
    moe_top_k=6,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b/smoke", family="moe",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
        n_experts=4, moe_top_k=2,
    )
