"""Primitive layers: norms, embeddings and the LM head, in PyTorch.

The JAX package's ``models/layers.py`` with its layouts: dense weights are
``(d_in, d_out)`` and applied as ``x @ w``, embedding tables ``(vocab, d)``,
a norm is ``{"scale": (d,)}``.  Initializers draw from a ``torch.Generator``
with the JAX package's distributions (not its draws: a test that needs the
JAX package's own weights carries them over with
``repro_torch.utils.tree.from_numpy``).  ``rotary`` and ``mlp`` arrive
with the attention slice.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch


def uniform_init(generator: torch.Generator, shape, scale: float,
                 dtype=torch.float32) -> torch.Tensor:
    """Uniform on [-scale, scale), drawn on ``generator``'s device."""
    u = torch.empty(shape, dtype=dtype, device=generator.device)
    return u.uniform_(-scale, scale, generator=generator)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> torch.Tensor:
    return uniform_init(generator, (d_in, d_out), 1.0 / math.sqrt(d_in),
                        dtype)


# -- norms --------------------------------------------------------------
def rmsnorm_init(d: int, dtype=torch.float32, device=None
                 ) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: Dict[str, torch.Tensor], x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMS norm over the last axis, in f32, back in ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


# -- embeddings ----------------------------------------------------------
def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    return uniform_init(generator, (vocab, d), 1.0 / math.sqrt(d), dtype)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def lm_head(x: torch.Tensor, table: Optional[torch.Tensor],
            head: Optional[torch.Tensor]) -> torch.Tensor:
    """Project to vocab logits (tied table or separate head). f32 logits."""
    logits = x @ head if head is not None else x @ table.T
    return logits.to(torch.float32)
