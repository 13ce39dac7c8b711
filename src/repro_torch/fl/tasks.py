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
* ``forward`` / ``features`` -- logits and penultimate representation;
* ``model_cfg`` -- the transformer ``ModelConfig`` behind an LM task (the
  FL -> serve bridge rebuilds and serves its weights), else ``None``.

The port registers the paper's ``fmnist_cnn``, the MLP ``fmnist_mlp`` and
the three LM families of the transformer stack (``transformer_lm``,
``moe_lm``, ``ssm_lm``) on a synthetic copy-structured token stream.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import make_fmnist_like
from repro_torch.models import mlp
from repro_torch.models import transformer as tfm
from repro_torch.models.cnn import (cnn_accuracy, cnn_cohort_loss,
                                    cnn_features, cnn_forward, cnn_loss,
                                    init_cnn)

__all__ = ["FLTask", "TASKS", "get_task", "register_task"]


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
    model_cfg: Optional[ModelConfig] = None


TASKS: Dict[str, FLTask] = {}


def register_task(task: FLTask) -> FLTask:
    if task.name in TASKS:
        raise ValueError(f"task {task.name!r} already registered")
    TASKS[task.name] = task
    return task


def get_task(name: str) -> FLTask:
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


# ----------------------------------------------------------------------
# The LM families of the transformer stack: next-token cross entropy on
# a copy-structured token stream (``batch["images"]`` carries the (B, S)
# tokens), next-token top-1 as the round metric.  ``ssm_chunk`` divides
# LM_SEQ_LEN, so ssm_lm's local steps run kernel C, forward and gradient.
# ----------------------------------------------------------------------
LM_SEQ_LEN = 16

_LM_CFG = ModelConfig(
    name="fl-transformer-lm", family="dense",
    n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64, vocab=64,
    tie_embeddings=True)

_MOE_LM_CFG = ModelConfig(
    name="fl-moe-lm", family="moe",
    n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64, vocab=64,
    tie_embeddings=True, n_experts=4, moe_top_k=2)

_SSM_LM_CFG = ModelConfig(
    name="fl-ssm-lm", family="ssm",
    n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64, vocab=64,
    tie_embeddings=True, ssm_state=8, ssm_head_dim=16, ssm_expand=2,
    ssm_conv_width=4, ssm_chunk=8)   # chunk 8 divides LM_SEQ_LEN=16

assert _MOE_LM_CFG.is_moe and _SSM_LM_CFG.is_ssm_only
assert LM_SEQ_LEN % _SSM_LM_CFG.ssm_chunk == 0


def make_lm_data(n_train: int, n_test: int, seed: int = 0,
                 seq: int = LM_SEQ_LEN) -> Dict[str, np.ndarray]:
    """Copy-structured token stream (second half = first half shifted by
    1) so next-token loss genuinely decreases.  ``y_*`` are 10-way
    pseudo-labels bucketed from the leading token: the LM objective
    ignores them, but the label-skew partitioners need classes.  Host
    numpy, bit-equal to the JAX package's."""
    vocab = _LM_CFG.vocab

    def gen(n, rs):
        toks = rs.randint(0, vocab, size=(n, seq)).astype(np.int32)
        half = seq // 2
        toks[:, half:half * 2] = (toks[:, :half] + 1) % vocab
        return toks, (toks[:, 0] * 10 // vocab).astype(np.int32)

    xtr, ytr = gen(n_train, np.random.RandomState(seed))
    xte, yte = gen(n_test, np.random.RandomState(seed + 1))
    return {"x_train": xtr, "y_train": ytr, "x_test": xte, "y_test": yte}


def _lm_family_fns(cfg: ModelConfig):
    """The LM task functions closed over ``cfg``: (init_params, loss,
    eval_metric, cohort_loss, forward)."""

    def init_params(generator, device=None):
        return tfm.init_model(cfg, generator, device)

    def forward(params, tokens):
        logits, _ = tfm.forward(params, {"tokens": tokens}, cfg)
        return logits

    def loss(params, batch):
        return tfm.lm_loss(params, {"tokens": batch["images"]}, cfg)[0]

    def eval_metric(params, tokens, labels):
        del labels
        logits = forward(params, tokens)
        return (logits[:, :-1].argmax(-1) == tokens[:, 1:]).to(
            torch.float32).mean()

    def cohort_loss(params, tokens, labels):
        """Per-device weights (leaves (C, ...)) on (C, B, S) tokens: the
        mean over the cohort of each device's loss, ``torch.func.vmap``
        of the serial loss (kernel C's vmap rule folds the cohort into
        its cells: one launch per layer for the whole cohort)."""
        del labels
        per_device = torch.func.vmap(
            lambda p, t: tfm.lm_loss(p, {"tokens": t}, cfg)[0])(params,
                                                               tokens)
        return per_device.mean()

    return init_params, loss, eval_metric, cohort_loss, forward


# the dense LM task's functions by name, as the JAX package exports them
init_lm, lm_task_loss, lm_accuracy, lm_cohort_loss, lm_forward = \
    _lm_family_fns(_LM_CFG)

for _name, _cfg in (("transformer_lm", _LM_CFG), ("moe_lm", _MOE_LM_CFG),
                    ("ssm_lm", _SSM_LM_CFG)):
    _init, _loss, _metric, _cohort, _fwd = _lm_family_fns(_cfg)
    register_task(FLTask(
        name=_name,
        init_params=_init,
        loss=_loss,
        eval_metric=_metric,
        make_data=make_lm_data,
        cohort_loss=_cohort,
        forward=_fwd,
        features=None,            # no contrastive head: MOON is CNN/MLP-only
        model_cfg=_cfg,
    ))
