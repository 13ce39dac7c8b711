"""Granite-34B-Code [arXiv:2405.04324] — deep llama-arch, MQA (kv=1)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    source="arXiv:2405.04324",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,            # multi-query attention
    d_ff=24576,
    vocab=49152,
    gated_mlp=False,        # GPT-BigCode-style 2-matrix GELU MLP (-> 34B)
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-34b/smoke", family="dense",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=1, d_ff=512, vocab=512,
        gated_mlp=False,
    )
