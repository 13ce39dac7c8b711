"""Plain PyTorch references of the benchmark's configurations and of the
federated round.  They import nothing of the port; each model module
gives ``init_params(cfg, generator, device)`` (the benchmark's weights,
in the port's parameter layout) and ``lm_loss(params, tokens, cfg)``."""
import importlib


def model(name: str):
    """The reference module ``reference/<name>.py`` a configuration
    names."""
    return importlib.import_module(f"perfbench.reference.{name}")
