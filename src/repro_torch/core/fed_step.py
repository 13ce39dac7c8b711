"""TEASQ-Fed as one federated training round of a model.

The JAX package's ``core/fed_step.py``.  One round:

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
    ``ops.threshold_channel_leaves`` call over the list of delta rows:
    the kernel on the card, its plain version on the CPU;
  * ``gather_f32``: the f32 deltas;
  * ``psum``: the dense weighted reduce.

Without sharding rules (one card) the round is the JAX package's
unsharded branch, and ``gather_f32`` and ``psum`` are the same dense
combine.  Under ``use_rules(Rules(mesh))`` it is the mesh branch, over
the ranks of a ``torch.distributed`` world, each running the same call
on its blocks of the params (``sharding.rules.param_blocks``: the twin of
global arrays placed by ``param_shardings``) and of the batch (its rows
over the fed axes, as ``batch`` maps to them):

  * the fed axes (``data`` [+ ``pod``]) split the G groups; each rank
    trains its ``G / |fed axes|`` of them (its batch rows, group-major),
    under the group-local rules of ``group_parallelism``: ``"tp"`` trains
    on the blocks (Megatron tensor parallelism over ``model``, the MoE's
    experts expert-parallel); ``"dp"`` replicates the weights over
    ``model``, as the reference does, so the blocks are first gathered
    whole;
  * each rank's deltas are its blocks' (under ``"dp"`` cut from the whole
    deltas as the outer rules shard the parameter), so a threshold and a
    scale belong to a (group, model block) as in the reference's
    ``shard_map``;
  * ``gather_q`` compresses the blocks with kernel B's channel form with
    its wire (int8 levels and f32 scales; two levels a byte at
    ``p_q <= 4``) and all-gathers the wire over the fed axes;
    ``gather_f32`` all-gathers the f32 blocks; ``psum`` all-reduces each
    rank's weighted partial sum;
  * each rank returns its blocks of the new params.  ``local_loss`` and
    ``delta_norm`` are the whole round's on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.compression import approx_topk_threshold, recip32
from repro_torch.core.staleness import (mixing_alpha,
                                        stacked_staleness_weights)
from repro_torch.kernels import ops
from repro_torch.sharding.rules import (Rules, active_rules,
                                        all_gather_dim, axes_size,
                                        axis_group, block_specs,
                                        gather_params, local_block,
                                        use_rules)
from repro_torch.utils.spans import span
from repro_torch.utils.tree import leaves, paths, tree_map, unflatten

__all__ = ["FedConfig", "approx_topk_threshold", "compress_delta",
           "decompress_delta", "fed_wire_bytes", "make_fed_train_step",
           "pack_int4", "unpack_int4"]


@dataclasses.dataclass(frozen=True)
class FedConfig:
    n_groups: int = 8             # G (a multiple of the fed axes' size)
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


def _fed_axes(rules: Optional[Rules]) -> Tuple[str, ...]:
    if rules is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in rules.mesh.mesh_dim_names)


def compress_delta(x: torch.Tensor, fed: FedConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 levels, zero below the threshold; f32 scale).  The JAX
    package gives ``p_q <= 4`` an int4 wire dtype; here the levels stay
    int8 at every ``p_q`` (the same values), and the mesh branch packs
    them two a byte for its all-gather (``pack_int4``)."""
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


def pack_int4(levels: torch.Tensor) -> torch.Tensor:
    """int8 levels (R, n) in [-8, 7] -> uint8 (R, ceil(n / 2)): two's
    complement nibbles, the even index in the low one (the int4 wire)."""
    u = (levels.to(torch.int16) & 0xF).to(torch.uint8)
    if u.shape[1] % 2:
        u = torch.cat([u, u.new_zeros((u.shape[0], 1))], dim=1)
    return u[:, 0::2] | (u[:, 1::2] << 4)


def unpack_int4(packed: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse of :func:`pack_int4`: uint8 (R, m) -> int8 (R, n)."""
    u = torch.stack([packed & 0xF, packed >> 4], dim=-1).reshape(
        packed.shape[0], -1)[:, :n].to(torch.int8)
    return torch.where(u > 7, u - 16, u)


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
        with span("fed.grad"):
            grads, loss = grad_and_value(w, tree_map(lambda x: x[e],
                                                     batches))
        with span("fed.prox"):
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
    int32.  Under active rules ``params`` and ``params'`` are the rank's
    blocks (``param_blocks``) and ``batch`` its rows: B over the fed axes'
    ranks, divisible by its ``n_groups / |fed axes|`` groups times
    ``local_steps``."""
    if fed.schedule not in ("gather_q", "gather_f32", "psum"):
        raise ValueError(f"unknown schedule {fed.schedule!r}; expected "
                         f"gather_q, gather_f32 or psum")
    if fed.group_parallelism not in ("tp", "dp"):
        raise ValueError(f"unknown group_parallelism "
                         f"{fed.group_parallelism!r}; expected tp or dp")
    G, E = fed.n_groups, fed.local_steps
    local = torch.func.vmap(
        lambda w, b: _group_local_train(w, b, loss_fn, fed),
        in_dims=(None, 0))

    def fed_round(params, batch, staleness):
        with span("fed.round", params):
            return _round(params, batch, staleness)

    def _round(params, batch, staleness):
        def split(x, g=G):  # (B, ...) -> (g, E, B/(g*E), ...), group-major
            return x.reshape((g, E, x.shape[0] // (g * E)) + x.shape[1:])

        rules = active_rules()
        if rules is not None:
            return _mesh_round(local, params, batch, split, staleness, fed,
                               rules)
        w_local, losses = local(params, tree_map(split, batch))
        with span("fed.combine"):
            new, metrics = _combine(w_local, params, staleness, fed)
        return new, {"local_loss": losses.mean(), **metrics}

    return fed_round


def _combine(w_local, params, staleness, fed: FedConfig):
    """The unsharded branch's combine: each group's delta, the staleness
    weights (Eqs. 6-10), ``gather_q``'s channel or the dense reduce ->
    (the new params, the round's ``alpha_t`` and ``delta_norm``)."""
    G = fed.n_groups
    delta = tree_map(lambda wl, w0: wl - w0[None], w_local, params)
    device = leaves(params)[0].device
    stale = torch.as_tensor(staleness, device=device).to(torch.float32)
    # Eqs. 6-7 over equal-sized groups (n_c == 1)
    wts = stacked_staleness_weights(stale, torch.ones_like(stale), fed.a)
    a_t = mixing_alpha(stale, fed.alpha, fed.a)

    names = paths(params)
    w0s, ds = leaves(params), leaves(delta)
    if fed.schedule == "gather_q":
        # f32 rows, so the channel dequantizes to f32 whatever the
        # params' dtype (the JAX package's compress_delta casts)
        rows = [d.reshape(G, -1).to(torch.float32) for d in ds]
        with span("fed.compress"):
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
    return unflatten(names, new), {"alpha_t": a_t,
                                   "delta_norm": _tree_norm(delta)}


# ----------------------------------------------------------------------
# the mesh branch
# ----------------------------------------------------------------------
def _local_rules(rules: Rules, fed: FedConfig) -> Rules:
    """The rules inside the group-local region: ``batch``/``seq`` must
    not claim the fed axes (they hold the groups); under ``dp`` the
    weights are replicated over ``model`` and a group's batch is split
    over it."""
    if fed.group_parallelism == "dp":
        return rules.with_overrides(
            batch="model", seq=None, heads=None, kv_heads=None, ffn=None,
            vocab=None, experts=None, ssm_heads=None)
    return rules.with_overrides(batch=None, seq=None)


def _mesh_round(local, params, batch, split, staleness, fed: FedConfig,
                rules: Rules):
    """One round on a mesh (the module docstring's mesh branch); ``params``
    the rank's blocks, ``batch`` its rows (its groups')."""
    mesh = rules.mesh
    G = fed.n_groups
    fgroup, f_idx, n_fed = axis_group(mesh, _fed_axes(rules))
    if G % n_fed:
        raise ValueError(f"{G} groups do not split over the fed axes "
                         f"{_fed_axes(rules)} of size {n_fed}")
    g_loc = G // n_fed
    mine = slice(f_idx * g_loc, (f_idx + 1) * g_loc)
    gb = tree_map(lambda x: split(x, g_loc), batch)
    names, w0s = paths(params), leaves(params)
    specs = block_specs(rules, params)
    if fed.group_parallelism == "dp":
        whole = gather_params(params, rules)
        with use_rules(_local_rules(rules, fed)):
            w_local, losses = local(whole, gb)
    else:
        with use_rules(_local_rules(rules, fed)):
            w_local, losses = local(params, gb)

    with span("fed.combine"):
        if fed.group_parallelism == "dp":
            # this rank's block of each delta, as the outer rules shard it
            blocks = [local_block(wl - w0[None], (None,) + sp, mesh)
                      for wl, w0, sp in zip(leaves(w_local), leaves(whole),
                                            specs)]
        else:
            blocks = [wl - w0[None] for wl, w0 in zip(leaves(w_local), w0s)]

        device = w0s[0].device
        stale = torch.as_tensor(staleness, device=device).to(torch.float32)
        wts = stacked_staleness_weights(stale, torch.ones_like(stale), fed.a)
        a_t = mixing_alpha(stale, fed.alpha, fed.a)
        rows = [d.reshape(g_loc, -1).to(torch.float32) for d in blocks]
        metrics = {"alpha_t": a_t}

        if fed.schedule == "psum":
            # this rank's weighted partial sums, one flat vector
            flat = torch.cat([torch.einsum("gn,g->n", r, wts[mine])
                              for r in rows])
            if fgroup is not None:
                dist.all_reduce(flat, group=fgroup)
            us = list(torch.split(flat, [r.shape[1] for r in rows]))
        else:
            if fed.schedule == "gather_q":
                dq, metrics["wire_bytes"] = _gather_q(rows, fed, fgroup,
                                                      n_fed)
            else:
                flat = torch.cat(rows, dim=1)
                dq = all_gather_dim(flat, 0, fgroup, n_fed)
                metrics["wire_bytes"] = flat.numel() * 4
                dq = list(torch.split(dq, [r.shape[1] for r in rows], dim=1))
            us = [torch.einsum("gn,g->n", d, wts) for d in dq]
        new = [(w + a_t * u.reshape(w.shape)).to(w.dtype)
               for w, u in zip(w0s, us)]

        # the whole round's metrics on every rank: a leaf replicated over
        # the non-fed axes counts once, its share of each rank's sum
        whole, _, n_all = axis_group(mesh, mesh.mesh_dim_names)
        rest = n_all // n_fed
        ss = sum(torch.sum(torch.square(d.to(torch.float32)))
                 * (axes_size(mesh, sp) / rest)
                 for d, sp in zip(blocks, specs))
        sums = torch.stack([losses.sum().to(torch.float32) / rest,
                            ss.to(torch.float32)])
        if whole is not None:
            dist.all_reduce(sums, group=whole)
        metrics["local_loss"] = sums[0] / G
        metrics["delta_norm"] = torch.sqrt(sums[1])
    return unflatten(names, new), metrics


def _gather_q(rows: List[torch.Tensor], fed: FedConfig, group, n_fed: int):
    """``gather_q``'s wire: each local group's row of each block through
    ``compress_delta`` (kernel B's channel form with its wire), the levels
    (two a byte at ``p_q <= 4``) and scales all-gathered over the fed
    axes, dequantized.  -> (per leaf (G, n) f32, bytes this rank sent)."""
    with span("fed.compress"):
        if fed.p_s < 1.0:
            _, lvls, scales = ops.threshold_channel_leaves(
                rows, fed.p_s, fed.p_q, fed.threshold_iters, wire=True)
        else:   # keep-all: compress_delta itself (see make_fed_train_step)
            pairs = [[compress_delta(r, fed) for r in rs] for rs in rows]
            lvls = [torch.stack([p[0] for p in ps]) for ps in pairs]
            scales = [torch.stack([p[1] for p in ps]) for ps in pairs]
    lens = [r.shape[1] for r in rows]
    flat = torch.cat(lvls, dim=1)
    wire = pack_int4(flat) if fed.p_q <= 4 else flat
    sc = torch.stack(scales, dim=1)                     # (g_loc, leaves)
    sent = wire.numel() * wire.element_size() + sc.numel() * 4
    wire = all_gather_dim(wire, 0, group, n_fed)
    sc = all_gather_dim(sc, 0, group, n_fed)            # (G, leaves)
    if fed.p_q <= 4:
        wire = unpack_int4(wire, flat.shape[1])
    out = []
    for i, lv in enumerate(torch.split(wire, lens, dim=1)):
        out.append(decompress_delta(lv, sc[:, i:i + 1], fed, torch.float32))
    return out, sent
