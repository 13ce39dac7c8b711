"""TEASQ-Fed as one federated training round of a model, on one card.

The JAX package's ``core/fed_step.py`` on its unsharded branch (the one it
takes without sharding rules, as ``launch/train.py`` always runs it).  One
round:

  1. every one of G groups runs E prox-SGD local steps (Eq. 5) from the
     broadcast global params on its own microbatches: ``torch.func.vmap``
     over the groups of ``torch.func.grad_and_value`` of the loss, the
     JAX ``jax.vmap`` of ``jax.value_and_grad`` (kernel C's vmap rule
     folds the groups into its cells);
  2. each group's delta is compressed with the paper's threshold Top-K +
     QSGD operator;
  3. the deltas are combined with the staleness weights of Eqs. 6-10.

Step 3 has three schedules:

  * ``gather_q``: every group's delta through ``compress_delta`` and
    ``decompress_delta``.  That round trip over the G rows of a leaf is
    kernel B's channel form, so it runs as one
    ``ops.threshold_channel_leaves`` call over the list of ``(G, n)``
    delta rows: the kernel on the card, its plain version on the CPU;
  * ``gather_f32`` and ``psum``: without a mesh both are the dense
    weighted combine of the f32 deltas.

The mesh branch of the reference (the explicit all-gather over the fed
axes, tp/dp group parallelism, the int4 wire of ``p_q <= 4``) needs
sharding rules over a device mesh, which the port does not have yet: it
arrives with ROADMAP.md Queue A item 1 (the mesh slice).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.compression import approx_topk_threshold, recip32
from repro_torch.core.staleness import (mixing_alpha,
                                        stacked_staleness_weights)
from repro_torch.kernels import ops
from repro_torch.utils.tree import leaves, paths, tree_map, unflatten

__all__ = ["FedConfig", "approx_topk_threshold", "compress_delta",
           "decompress_delta", "fed_wire_bytes", "make_fed_train_step"]


@dataclasses.dataclass(frozen=True)
class FedConfig:
    n_groups: int = 8             # G
    local_steps: int = 1          # E
    lr: float = 1e-3
    mu: float = 0.01              # prox weight (Eq. 5)
    alpha: float = 0.6            # mixing (Eq. 9)
    a: float = 0.5                # staleness exponent (Eq. 6)
    p_s: float = 0.25             # sparsification keep-ratio
    p_q: int = 8                  # quantization bits
    schedule: str = "gather_q"    # gather_q | gather_f32 | psum
    threshold_iters: int = 12
    # within-group parallelism over a mesh ("tp" or "dp"); ignored without
    # one, as in the JAX package
    group_parallelism: str = "tp"


def compress_delta(x: torch.Tensor, fed: FedConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 levels, zero below the threshold; f32 scale).  The JAX
    package gives ``p_q <= 4`` an int4 wire dtype; here the levels stay
    int8 at every ``p_q``: the same values, whose packed int4 form matters
    only to the mesh all-gather."""
    absx = torch.abs(x.to(torch.float32))
    thr = approx_topk_threshold(absx, fed.p_s, fed.threshold_iters)
    mask = absx >= thr
    kept = torch.where(mask, x.to(torch.float32),
                       torch.zeros((), dtype=torch.float32, device=x.device))
    L = 2 ** (fed.p_q - 1) - 1
    scale = torch.clamp(torch.max(torch.abs(kept)), min=1e-12)
    levels = torch.clamp(torch.round(kept / scale * L), -L, L)
    return levels.to(torch.int8), scale


def decompress_delta(levels: torch.Tensor, scale: torch.Tensor,
                     fed: FedConfig, dtype) -> torch.Tensor:
    """``levels * scale / L`` in the form XLA compiles it to under
    ``jax.jit``: ``(levels * scale) * f32(1/L)``."""
    L = 2 ** (fed.p_q - 1) - 1
    return (levels.to(torch.float32) * scale * recip32(L)).to(dtype)


def fed_wire_bytes(params: Any, fed: FedConfig, n_groups: int
                   ) -> Dict[str, float]:
    """Analytic wire accounting (per round, whole system)."""
    n = sum(x.numel() for x in leaves(params))
    dense_f32 = 4.0 * n * n_groups
    idx_bits = math.ceil(math.log2(max(n, 2)))
    packed = n_groups * (fed.p_s * n * (fed.p_q + idx_bits)) / 8.0
    dense_q = n_groups * n * fed.p_q / 8.0
    return {"dense_f32": dense_f32, "dense_quant": dense_q,
            "packed_sparse_quant": packed,
            "compression_x": dense_f32 / packed}


def _group_local_train(w0: Any, batches: Any, loss_fn: Callable,
                       fed: FedConfig) -> Tuple[Any, torch.Tensor]:
    """E prox-SGD steps for ONE group from ``w0`` (Eq. 5; the prox term
    anchors at ``w0``, the broadcast global).  batches: leaves (E, mb,
    ...).  -> (the group's params, its mean loss over the E steps)."""
    grad_and_value = torch.func.grad_and_value(loss_fn)
    w, losses = w0, []
    for e in range(fed.local_steps):
        grads, loss = grad_and_value(w, tree_map(lambda x: x[e], batches))
        w = tree_map(
            lambda p, g, a0: (p - fed.lr * (g + fed.mu * (p - a0))).to(
                p.dtype), w, grads, w0)
        losses.append(loss)
    return w, torch.stack(losses).mean()


def _tree_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))


def make_fed_train_step(loss_fn: Callable, fed: FedConfig) -> Callable:
    """Build ``fed_round(params, batch, staleness) -> (params', metrics)``.

    ``loss_fn(params, batch) -> scalar``.  ``batch`` leaves are (B, ...)
    with B divisible by ``n_groups * local_steps``; ``staleness`` is (G,)
    int32."""
    if fed.schedule not in ("gather_q", "gather_f32", "psum"):
        raise ValueError(f"unknown schedule {fed.schedule!r}; expected "
                         f"gather_q, gather_f32 or psum")
    G, E = fed.n_groups, fed.local_steps
    local = torch.func.vmap(
        lambda w, b: _group_local_train(w, b, loss_fn, fed),
        in_dims=(None, 0))

    def fed_round(params, batch, staleness):
        def split(x):  # (B, ...) -> (G, E, B/(G*E), ...), group-major
            return x.reshape((G, E, x.shape[0] // (G * E)) + x.shape[1:])

        w_local, losses = local(params, tree_map(split, batch))

        delta = tree_map(lambda wl, w0: wl - w0[None], w_local, params)
        device = leaves(params)[0].device
        stale = torch.as_tensor(staleness, device=device).to(torch.float32)
        # Eqs. 6-7 over equal-sized groups (n_c == 1)
        wts = stacked_staleness_weights(stale, torch.ones_like(stale),
                                        fed.a)
        a_t = mixing_alpha(stale, fed.alpha, fed.a)

        names = paths(params)
        w0s, ds = leaves(params), leaves(delta)
        if fed.schedule == "gather_q":
            rows = [d.reshape(G, -1) for d in ds]
            if fed.p_s < 1.0:
                dqs = ops.threshold_channel_leaves(
                    rows, fed.p_s, fed.p_q, fed.threshold_iters)
            else:   # keep-all: the round trip itself (the channel's
                #     p_s >= 1 form keeps even values below 2^-iters max)
                dqs = [torch.stack([decompress_delta(
                    *compress_delta(r, fed), fed, torch.float32)
                    for r in rs]) for rs in rows]
            new = [(w0 + a_t * torch.einsum("gn,g->n", dq, wts).reshape(
                w0.shape)).to(w0.dtype) for dq, w0 in zip(dqs, w0s)]
        else:   # psum / gather_f32 without a mesh: dense weighted reduce
            new = [(w0 + a_t * torch.einsum(
                "g...,g->...", d.to(torch.float32), wts)).to(w0.dtype)
                for d, w0 in zip(ds, w0s)]
        metrics = {"local_loss": losses.mean(), "alpha_t": a_t,
                   "delta_norm": _tree_norm(delta)}
        return unflatten(names, new), metrics

    return fed_round
