"""Mamba2-370M [arXiv:2405.21060] — attention-free SSD (state-space duality)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=48,
    d_model=1024,
    n_heads=16,              # unused (attention-free) but kept for head_dim math
    n_kv_heads=16,
    d_ff=0,                  # no MLP: mamba blocks only
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m/smoke", family="ssm",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=0, vocab=512,
        ssm_state=32, ssm_head_dim=64, ssm_expand=2, ssm_chunk=64,
        tie_embeddings=True,
    )
