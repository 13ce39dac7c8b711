"""Mixture-of-Experts FFN with expert parallelism, in PyTorch: the JAX
package's ``models/moe.py``.

Two routes with the same routing:

* ``_moe_dense_ref`` -- every expert on every token and a masked combine,
  exact (no capacity drops); the route without sharding rules, and the
  oracle;
* ``_moe_ep_local`` -- expert parallelism over the ``model`` axis of the
  active rules' mesh (``moe_apply``'s mesh route): each model rank owns
  ``E / model`` experts, takes up to ``capacity`` tokens per expert from
  its tokens (model-replicated, as they enter the block) by a sort-free
  cumsum-rank dispatch, runs its experts, adds the weighted outputs back
  and sums over the model axis.  That sum is the only collective, with
  the gradient of the single-program math (``sharding.rules.psum`` and
  ``copy_to``, the Megatron pair).  Where the rules map ``batch`` to mesh
  axes, ``x`` holds this rank's block of the batch and the aux loss is
  averaged over them.

Top-k routing is a softmax over the top-k router logits (the Mixtral
convention), with the router in f32 whatever the model's dtype; the aux
output is the Switch-style load-balance loss.

Ties among router logits go to the lower expert index, as
``jax.lax.top_k`` breaks them (``torch.topk`` promises no order), so the
top k come from a stable descending sort.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, uniform_init
from repro_torch.sharding.rules import (active_rules, as_axes, axis_group,
                                        copy_to, mesh_size, pmean, psum)

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


def _dispatch_ranks(top_e: torch.Tensor, E: int):
    """Sort-free rank-within-expert for each (token, slot) -> ((S,) rank,
    (S,) flat expert id), S = T * k, in (token, slot) order."""
    fe = top_e.reshape(-1)                                   # (S,)
    onehot = _one_hot(fe, E, torch.int64)                    # (S, E)
    ranks = torch.cumsum(onehot, dim=0) - 1
    rank = torch.gather(ranks, 1, fe[:, None])[:, 0]
    return rank, fe


def _moe_ep_local(params: Params, x: torch.Tensor, cfg, capacity: int,
                  e_loc: int, r: int, group) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """One model rank's share: ``x`` (T, D) model-replicated; the experts
    ``[r * e_loc, (r + 1) * e_loc)`` of the whole ``params``.  -> (y
    summed over ``group``, this rank's aux loss)."""
    T, D = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    w, e, probs = _route(params["router"], x, k)
    rank, fe = _dispatch_ranks(e, E)
    # the expert half takes the replicated inputs through copy_to: the
    # ranks' partial cotangents are summed there
    fw = copy_to(w, group).reshape(-1)
    xs = copy_to(x, group)
    tok = torch.arange(T * k, device=x.device) // k

    le = fe - r * e_loc
    owned = (le >= 0) & (le < e_loc) & (rank < capacity)
    nbuf = e_loc * capacity
    dest = torch.where(owned, le * capacity + rank,
                       torch.full_like(le, nbuf))           # OOB slot
    buf = torch.zeros((nbuf + 1, D), dtype=x.dtype, device=x.device
                      ).index_put((dest,), xs[tok])
    tok_idx = torch.full((nbuf + 1,), T, dtype=torch.int64,
                         device=x.device).index_put((dest,), tok)
    w_buf = torch.zeros(nbuf + 1, dtype=torch.float32, device=x.device
                        ).index_put((dest,), fw)
    sl = slice(r * e_loc, (r + 1) * e_loc)
    xb = buf[:nbuf].reshape(e_loc, capacity, D)
    yb = _expert_ffn(params["e_gate"][sl], params["e_up"][sl],
                     params["e_down"][sl], xb).reshape(nbuf, D)
    contrib = yb * w_buf[:nbuf, None].to(yb.dtype)
    # empty slots point at the extra row T, dropped after the add
    y = torch.zeros((T + 1, D), dtype=x.dtype, device=x.device).index_add(
        0, tok_idx[:nbuf], contrib.to(x.dtype))[:T]
    return psum(y, group), _load_balance_loss(probs, e, E)


DP_MOE_FAULT = ("ROADMAP.md Queue C: the expert-parallel MoE under the "
                "federated round's dp rules (the reference shards the "
                "tokens over the experts' own axis and sums different "
                "token slices)")


def moe_apply(params: Params, x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D), load-balance loss scalar).  With
    active rules whose mesh has a ``model`` axis dividing the experts,
    the expert-parallel route; otherwise the dense reference."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    rules = active_rules()
    mesh = rules.mesh if rules is not None else None
    if mesh is None or "model" not in mesh.mesh_dim_names \
            or cfg.n_experts % mesh_size(mesh, "model") != 0:
        y, aux = _moe_dense_ref(params, xt, cfg)
        return y.reshape(B, S, D), aux
    batch_axes = as_axes(rules.mapping.get("batch"))
    if "model" in batch_axes:
        raise ValueError(f"the expert-parallel MoE cannot take tokens "
                         f"sharded over its experts' axis: {DP_MOE_FAULT}")
    group, r, n_model = axis_group(mesh, "model")
    # tokens sharded over the batch axes: x is this rank's block of them
    bgroup, _, n_batch = axis_group(mesh, batch_axes)
    T_loc = B * S
    capacity = max(8, int(math.ceil(T_loc * cfg.moe_top_k / cfg.n_experts
                                    * cfg.capacity_factor)))
    y, aux = _moe_ep_local(params, xt, cfg, capacity,
                           cfg.n_experts // n_model, r, group)
    # aux differs per batch shard: average to a replicated scalar
    return y.reshape(B, S, D), pmean(aux, bgroup, n_batch)
