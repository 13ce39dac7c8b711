"""Functional optimizers over parameter trees, in PyTorch.

The JAX package's ``optim/optimizers.py``: an :class:`Optimizer` is a pair
of plain functions, ``init(params) -> state`` and ``update(grads, state,
params) -> (updates, state)``, over nested dicts of tensors, and
:func:`apply_updates` adds the updates.  ``torch.optim`` is not used: its
AdamW places ``eps`` and the bias corrections differently.  The state keeps
the JAX package's keys (``m``, ``v``, ``mu``, ``step``; ``mu`` is None for
plain SGD), so it crosses ``checkpoint/io.py`` in the JAX layout.  The step
counter is an int32 scalar on the parameters' device, and the bias
corrections ``1 - b ** step`` are computed in f32.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.utils.tree import leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        mu = tree_map(torch.zeros_like, params) if momentum else None
        return {"mu": mu, "step": _step0(params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            return (tree_map(lambda m: -lr_t * m, mu),
                    {"mu": mu, "step": step})
        return tree_map(lambda g: -lr_t * g, grads), {"mu": None,
                                                       "step": step}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params),
                "step": _step0(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"],
                     grads)
        sf = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=sf.device), sf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=sf.device), sf)

        def upd(m_, v_, p):
            u = -lr_t * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u - lr_t * weight_decay * p
            return u

        return tree_map(upd, m, v, params), {"m": m, "v": v, "step": step}

    return Optimizer(init, update)


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so that their global norm is at most ``max_norm``:
    -> (clipped grads, the norm before clipping).  The squares are summed
    leaf by leaf in leaf order, in f32."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gn


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak``, then a cosine decay to ``floor * peak``
    at ``total``: a function of the step (a tensor or a number) returning
    an f32 tensor."""
    def fn(step):
        step = step.to(torch.float32) if isinstance(step, torch.Tensor) \
            else float(step)
        device = step.device if isinstance(step, torch.Tensor) else None
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp(torch.as_tensor(
            (step - warmup) / max(total - warmup, 1), dtype=torch.float32,
            device=device), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return torch.where(torch.as_tensor(step < warmup, device=device),
                           torch.as_tensor(warm, dtype=torch.float32,
                                           device=device), cos)
    return fn


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
