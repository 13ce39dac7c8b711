"""InternVL2-2B [arXiv:2404.16821] — InternViT frontend (stubbed) + InternLM2 LM.

The vision encoder is a stub: ``batch["patches"]`` carries precomputed
patch embeddings (n_patches, d_model); this config is the LM backbone
that consumes them.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    source="arXiv:2404.16821",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    n_patches=256,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b/smoke", family="vlm",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
        n_patches=16,
    )
