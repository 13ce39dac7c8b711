"""Jamba v0.1 52B [arXiv:2403.19887]: Mamba+attention 1:7 interleave, MoE 16e top-2.

Real Jamba: blocks of 8 layers with one attention layer (ratio 1:7) and MoE FFN
every other layer (e=16, top-2).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    source="arXiv:2403.19887",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    n_experts=16,
    moe_top_k=2,
    moe_every=2,
    attn_every=8,                # 1 attention layer per 8 (1:7 mamba:attn)
    ssm_state=16,                # Jamba-1 uses Mamba-1 d_state=16; SSD path with N=16
    ssm_head_dim=64,
    ssm_expand=2,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b/smoke", family="hybrid",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
        n_experts=4, moe_top_k=2, moe_every=2,
        attn_every=2, ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_chunk=64,
    )
