"""The paper's own model: 2-conv CNN for Fashion-MNIST (TEASQ-Fed §5.1).

Not part of the assigned transformer pool; this is the federated-learning
workhorse used by the protocol simulator and the paper-table benchmarks.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="fmnist-cnn",
    family="cnn",
    source="TEASQ-Fed §5.1 (Fashion-MNIST CNN)",
    n_layers=2,              # two conv layers
    d_model=32,              # conv channels
    n_heads=1, n_kv_heads=1,
    d_ff=128,                # fully-connected width
    vocab=10,                # classes
)


def smoke() -> ModelConfig:
    return CONFIG  # already tiny
