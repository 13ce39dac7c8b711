"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    source="hf:HuggingFaceTB/SmolLM-135M",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab=49152,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m/smoke", family="dense",
        n_layers=2, d_model=144, n_heads=3, n_kv_heads=1, d_ff=384, vocab=512,
        tie_embeddings=True,
    )
