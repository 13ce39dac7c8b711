"""One-hidden-layer MLP on 28x28 grayscale images (``fmnist_mlp``), in
PyTorch.

The smallest non-CNN family of the FL task registry: ``w1`` (784, 64),
``b1``, ``w2`` (64, 10), ``b2``, in the JAX package's layouts, so that
weights carry across unchanged.  As for the CNN, the serial
``mlp_forward``/``mlp_loss``/``mlp_accuracy``/``mlp_features`` and the
cohort form ``mlp_cohort_loss``, in which every leaf carries a leading
device axis C (batched GEMMs) and the loss is the mean over all (C, B)
examples.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.utils.tree import resolve_device

Params = Dict[str, torch.Tensor]

MLP_HIDDEN = 64


def init_mlp(generator: torch.Generator, n_classes: int = 10,
             hidden: int = MLP_HIDDEN, device=None) -> Params:
    """Uniform fan-in init with the JAX package's bounds and shapes, drawn
    from ``generator`` (a ``torch.Generator`` on the CPU), on ``device``
    (the card unless the caller names another).  The draws differ from
    ``jax.random``'s; a test that needs JAX's own weights carries them over
    with ``repro_torch.utils.tree.from_numpy``."""
    d_in = 28 * 28

    def uniform(shape, fan_in):
        s = 1.0 / math.sqrt(fan_in)
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (u * 2.0 - 1.0) * s

    params = {"w1": uniform((d_in, hidden), d_in),
              "b1": torch.zeros(hidden),
              "w2": uniform((hidden, n_classes), hidden),
              "b2": torch.zeros(n_classes)}
    device = resolve_device(device)
    return {k: v.to(device) for k, v in params.items()}


def mlp_features(params: Params, images: torch.Tensor) -> torch.Tensor:
    """Penultimate representation (MOON's contrastive term), (B, hidden)."""
    x = images.reshape(images.shape[0], -1)
    return F.relu(x @ params["w1"] + params["b1"])


def mlp_forward(params: Params, images: torch.Tensor) -> torch.Tensor:
    """images: (B, 28, 28, 1) -> logits (B, n_classes)."""
    return mlp_features(params, images) @ params["w2"] + params["b2"]


def mlp_loss(params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean cross-entropy of the batch ``{"images", "labels"}``."""
    logp = F.log_softmax(mlp_forward(params, batch["images"]), dim=-1)
    return -torch.gather(logp, 1, batch["labels"].long()[:, None]).mean()


def mlp_accuracy(params: Params, images: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    hits = (mlp_forward(params, images).argmax(-1) == labels).sum()
    return hits.to(torch.float32) / labels.numel()


def mlp_cohort_loss(params: Params, images: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Per-device weights: leaves (C, ...), images (C, B, 28, 28, 1).  The
    mean cross-entropy over all (C, B) examples of the cohort."""
    x = images.reshape(images.shape[0], images.shape[1], -1)
    h = F.relu(torch.bmm(x, params["w1"]) + params["b1"][:, None, :])
    logits = torch.bmm(h, params["w2"]) + params["b2"][:, None, :]
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None]).mean()
