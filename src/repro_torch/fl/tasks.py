"""Per-model FL task registry: the seam that keeps the protocol stack
model-agnostic.

An :class:`FLTask` is everything the engine and the protocol strategies
need to train one model family under any protocol:

* ``init_params(generator, device)`` -- model init (Alg. 1 line 1's w^0);
* ``loss(params, batch)`` -- the device objective f_k (Eq. 5's loss term),
  with ``batch = {"images": inputs, "labels": targets}``;
* ``eval_metric(params, x, y)`` -- scalar in [0, 1], logged per round;
* ``cohort_loss(stacked_params, images, labels)`` -- the vectorized
  multi-device loss the cohort trainer differentiates (leaves with a
  leading device axis C; inputs (C, B, ...)); ``None`` when the family has
  no cohort form;
* ``make_data(n_train, n_test, seed)`` -- the synthetic numpy dataset;
* ``forward`` / ``features`` -- logits and penultimate representation.

The port registers the paper's ``fmnist_cnn`` and the MLP ``fmnist_mlp``;
the LM tasks arrive with ROADMAP.md Queue A item 2 and raise until then.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.data.synthetic import make_fmnist_like
from repro_torch.models import mlp
from repro_torch.models.cnn import (cnn_accuracy, cnn_cohort_loss,
                                    cnn_features, cnn_forward, cnn_loss,
                                    init_cnn)

__all__ = ["FLTask", "TASKS", "get_task", "register_task"]

# where the not-yet-ported tasks arrive
_LATER = {name: "ROADMAP.md Queue A item 2 (lm_loss and the LM tasks)"
          for name in ("transformer_lm", "moe_lm", "ssm_lm")}


@dataclasses.dataclass(frozen=True)
class FLTask:
    """One model family's FL bundle (see the module docstring)."""

    name: str
    init_params: Callable[..., Dict[str, Any]]
    loss: Callable[..., Any]
    eval_metric: Callable[..., Any]
    make_data: Callable[[int, int, int], Dict[str, np.ndarray]]
    cohort_loss: Optional[Callable[..., Any]] = None
    forward: Optional[Callable[..., Any]] = None
    features: Optional[Callable[..., Any]] = None


TASKS: Dict[str, FLTask] = {}


def register_task(task: FLTask) -> FLTask:
    if task.name in TASKS:
        raise ValueError(f"task {task.name!r} already registered")
    TASKS[task.name] = task
    return task


def get_task(name: str) -> FLTask:
    if name in _LATER:
        raise NotImplementedError(
            f"task {name!r} is not ported yet: it arrives with "
            f"{_LATER[name]}")
    try:
        return TASKS[name]
    except KeyError:
        raise ValueError(f"unknown task {name!r}; "
                         f"expected one of {sorted(TASKS)}") from None


register_task(FLTask(
    name="fmnist_cnn",
    init_params=lambda generator, device=None: init_cnn(generator,
                                                         device=device),
    loss=cnn_loss,
    eval_metric=cnn_accuracy,
    make_data=lambda n_train, n_test, seed: make_fmnist_like(
        n_train, n_test, seed=seed),
    cohort_loss=cnn_cohort_loss,
    forward=cnn_forward,
    features=cnn_features,
))


# the smallest non-CNN family, on the same synthetic FMNIST images
register_task(FLTask(
    name="fmnist_mlp",
    init_params=lambda generator, device=None: mlp.init_mlp(generator,
                                                            device=device),
    loss=mlp.mlp_loss,
    eval_metric=mlp.mlp_accuracy,
    make_data=lambda n_train, n_test, seed: make_fmnist_like(
        n_train, n_test, seed=seed),
    cohort_loss=mlp.mlp_cohort_loss,
    forward=mlp.mlp_forward,
    features=mlp.mlp_features,
))
