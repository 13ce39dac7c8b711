"""Mixture-of-Experts FFN, in PyTorch: the JAX package's ``models/moe.py``
on its no-mesh route.

``moe_apply`` runs ``_moe_dense_ref``: every expert on every token and a
masked combine, exact (no capacity drops).  Top-k routing is a softmax
over the top-k router logits (the Mixtral convention), with the router in
f32 whatever the model's dtype; the aux output is the Switch-style
load-balance loss.

Ties among router logits go to the lower expert index, as
``jax.lax.top_k`` breaks them (``torch.topk`` promises no order), so the
top k come from a stable descending sort.

The expert-parallel path (capacity-bounded dispatch over a mesh) waits
for ROADMAP.md Queue A item 1 (the mesh slice).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, uniform_init

Params = Dict[str, torch.Tensor]


def moe_init(generator: torch.Generator, cfg, dtype=torch.float32,
             lead=()) -> Params:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    lead = tuple(lead)
    scale = 1.0 / math.sqrt(d)
    return {
        "router": dense_init(generator, d, E, torch.float32, lead),
        "e_gate": uniform_init(generator, lead + (E, d, f), scale, dtype),
        "e_up": uniform_init(generator, lead + (E, d, f), scale, dtype),
        "e_down": uniform_init(generator, lead + (E, f, d),
                               1.0 / math.sqrt(f), dtype),
    }


def _top_k(logits: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index (the
    order of ``jax.lax.top_k``)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router: torch.Tensor, x: torch.Tensor, k: int):
    """x: (T, D) -> (weights (T,k) f32, experts (T,k) int64, probs (T,E)
    f32)."""
    logits = x.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_logits, top_e = _top_k(logits, k)
    top_w = torch.softmax(top_logits, dim=-1)
    return top_w, top_e, probs


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``F.one_hot(idx, n)`` in ``dtype``, as a comparison: it also runs
    under ``torch.func.vmap`` of ``torch.func.grad`` (the federated
    round's group vmap), where ``F.one_hot``'s range check cannot."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _load_balance_loss(probs: torch.Tensor, top_e: torch.Tensor,
                       n_experts: int) -> torch.Tensor:
    """Switch-transformer aux loss: E * sum_e f_e * p_e."""
    onehot = _one_hot(top_e, n_experts, torch.float32)       # (T,k,E)
    frac = onehot.sum(dim=(0, 1)) / (top_e.shape[0] * top_e.shape[1])
    mean_p = probs.mean(dim=0)
    return n_experts * torch.sum(frac * mean_p)


def _expert_ffn(gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
                xb: torch.Tensor) -> torch.Tensor:
    """xb: (E, C, D) with per-expert weights (E, D, F) / (E, F, D); a
    shared (C, D) input broadcasts over the experts."""
    h = F.silu(torch.matmul(xb, gate)) * torch.matmul(xb, up)   # (E,C,F)
    return torch.matmul(h, down)                                # (E,C,D)


def _moe_dense_ref(params: Params, x: torch.Tensor, cfg
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D) -> (y (T, D), load-balance loss)."""
    E, k = cfg.n_experts, cfg.moe_top_k
    w, e, probs = _route(params["router"], x, k)
    # every expert on every token (the reference route)
    y_e = _expert_ffn(params["e_gate"], params["e_up"], params["e_down"],
                      x)                                        # (E,T,D)
    onehot = _one_hot(e, E, y_e.dtype)                          # (T,k,E)
    comb = torch.einsum("tke,tk->et", onehot, w.to(y_e.dtype))
    y = torch.einsum("etd,et->td", y_e, comb)
    return y, _load_balance_loss(probs, e, E)


def moe_apply(params: Params, x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D), load-balance loss scalar)."""
    B, S, D = x.shape
    y, aux = _moe_dense_ref(params, x.reshape(B * S, D), cfg)
    return y.reshape(B, S, D), aux
