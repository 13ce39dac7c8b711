"""Staleness-weighted cached aggregation (paper Eqs. 6-10), in PyTorch.

Everything is f32 on the parameters' device.  ``aggregate_cache`` keeps
the JAX package's tuple form: the weighted sum runs over the cached
updates in cache order, one multiply-add per update, which is the
reduction order of the JAX kernel (``sum(w * l for ...)``).
``aggregate_cache_stacked`` is the wave mode's form: the weights and the
K cached updates flattened to f32 rows on the device, stacked, and
reduced as XLA's CPU backend compiles the JAX package's stacked form (a
chain of fused multiply-adds).  The sharded form (``make_sharded_aggregator``)
splits the flattened weights into column blocks over a mesh.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from repro_torch.utils.tree import Params, leaves, paths, tree_map, unflatten


def staleness_weight(staleness, a: float = 0.5) -> torch.Tensor:
    """Eq. 6: S(t - h_c) = (t - h_c + 1)^(-a).  The exponent is an f32
    tensor: with a Python number torch takes ``rsqrt`` at a = 0.5, one ulp
    off the ``pow`` that XLA computes."""
    x = torch.as_tensor(staleness, dtype=torch.float32) + 1.0
    return torch.pow(x, torch.tensor(-a, dtype=torch.float32,
                                     device=x.device))


def stacked_staleness_weights(staleness, n_samples,
                              a: float = 0.5) -> torch.Tensor:
    """Eqs. 6-7 weights, normalized: S(t-h_c) n_c / sum_c S(t-h_c) n_c."""
    s = staleness_weight(staleness, a)
    wts = s * torch.as_tensor(n_samples, dtype=torch.float32,
                              device=s.device)
    return wts / torch.sum(wts)


def weighted_average(updates: Sequence[Params], staleness: Sequence[float],
                     n_samples: Sequence[float], a: float = 0.5) -> Params:
    """Eq. 7: u = sum_c S(t-h_c) n_c w_c / sum_c S(t-h_c) n_c, one
    multiply-add per update in update order."""
    device = leaves(updates[0])[0].device
    wts = stacked_staleness_weights(
        torch.as_tensor(staleness, dtype=torch.float32, device=device),
        n_samples, a)

    def avg(*ls):
        return sum(w * l for w, l in zip(wts, ls))

    return tree_map(avg, *updates)


def mixing_alpha(staleness, alpha: float, a: float = 0.5) -> torch.Tensor:
    """Eqs. 8-9: alpha^t = alpha * S(mean staleness)."""
    delta = torch.mean(torch.as_tensor(staleness).to(torch.float32))
    return alpha * staleness_weight(delta, a)


def merge_global(w_global: Params, u: Params, alpha_t) -> Params:
    """Eq. 10: w^{t+1} = alpha^t u + (1 - alpha^t) w^t."""
    return tree_map(lambda wu, wg: alpha_t * wu + (1.0 - alpha_t) * wg,
                    u, w_global)


def _cache_weights(w_global: Params, cache: List[Tuple[Params, int, int]],
                   t: int, alpha: float, a: float):
    """The Eqs. 6-7 weights of the cached entries and alpha^t (Eqs. 8-9),
    on the parameters' device."""
    device = leaves(w_global)[0].device
    staleness = torch.tensor([t - c[1] for c in cache], dtype=torch.float32,
                             device=device)
    n_samples = torch.tensor([c[2] for c in cache], dtype=torch.float32,
                             device=device)
    wts = stacked_staleness_weights(staleness, n_samples, a)
    return wts, alpha * staleness_weight(torch.mean(staleness), a)


def aggregate_cache(w_global: Params, cache: List[Tuple[Params, int, int]],
                    t: int, alpha: float, a: float = 0.5) -> Params:
    """Full server aggregation step over cached (update, h_c, n_c) entries:
    u = sum_c wts_c w_c (Eq. 7), alpha^t = alpha S(mean staleness)
    (Eqs. 8-9), w^{t+1} = alpha^t u + (1 - alpha^t) w^t (Eq. 10)."""
    wts, a_t = _cache_weights(w_global, cache, t, alpha, a)

    def merge(w, *cached):
        u = sum(wts[i] * c for i, c in enumerate(cached))
        return a_t * u + (1.0 - a_t) * w

    return tree_map(merge, w_global, *(c[0] for c in cache))


def _stacked_merge(w: torch.Tensor, stacked: torch.Tensor,
                   wts: torch.Tensor, a_t: torch.Tensor) -> torch.Tensor:
    """Eqs. 7 and 10 on flat f32 rows, as XLA's CPU backend compiles the
    JAX package's stacked form: the K-term ``tensordot`` a chain of fused
    multiply-adds in cache order, and the merge ``a_t * u + (1 - a_t) *
    w`` one more, ``fma(a_t, u, (1 - a_t) * w)``; at K = 1 the dot is a
    product fused into the merge, ``fma(1 - a_t, w, a_t * u)``.
    ``addcmul`` is that fused multiply-add."""
    u = wts[0] * stacked[0]
    if stacked.shape[0] == 1:
        return torch.addcmul(a_t * u, 1.0 - a_t, w)
    for k in range(1, stacked.shape[0]):
        u = torch.addcmul(u, wts[k], stacked[k])
    return torch.addcmul((1.0 - a_t) * w, a_t, u)


def aggregate_cache_stacked(w_global: Params,
                            cache: List[Tuple[Params, int, int]], t: int,
                            alpha: float, a: float = 0.5) -> Params:
    """Eqs. 6-10 with the weights and the K cached updates flattened to
    f32 rows on the parameters' device (no host round trip), stacked, and
    reduced by :func:`_stacked_merge`.  It is ``aggregate_cache`` up to
    the order and the rounding of the K-term sums."""
    wts, a_t = _cache_weights(w_global, cache, t, alpha, a)
    wg, spec = _flatten_f32(w_global)
    stk = torch.stack([_flatten_f32(c[0])[0] for c in cache])
    return _unflatten_f32(_stacked_merge(wg, stk, wts, a_t), spec)


# ----------------------------------------------------------------------
# Sharded (mesh) variant: the stacked Eqs. 6-10 reduction partitioned over
# a 1-D device mesh.  The weights are flattened to ONE f32 vector on their
# device and split into equal column blocks, one per rank of the mesh;
# each rank runs the per-element program of the stacked form on its block
# (the K-term tensordot and the Eq. 10 merge touch each element once, in
# the same operand order) and the blocks are all-gathered, so the result
# is the stacked form's within 1 ulp (the tensordot of a block may group
# its multiply-adds otherwise than the whole leaf's).
# ----------------------------------------------------------------------
def _flatten_f32(tree: Params) -> Tuple[torch.Tensor, Tuple[list, list]]:
    """(flat f32 vector on the leaves' device, (leaf paths, shapes))."""
    ls = leaves(tree)
    vec = torch.cat([x.to(torch.float32).reshape(-1) for x in ls]) if ls \
        else torch.zeros(0, dtype=torch.float32)
    return vec, (paths(tree), [tuple(x.shape) for x in ls])


def _unflatten_f32(vec: torch.Tensor, spec) -> Params:
    names, shapes = spec
    out, o = [], 0
    for sh in shapes:
        n = math.prod(sh)
        out.append(vec[o:o + n].reshape(sh))
        o += n
    return unflatten(names, out)


def _sharded_agg_body(wg_loc: torch.Tensor, stacked_loc: torch.Tensor,
                      staleness: torch.Tensor, n_samples: torch.Tensor,
                      alpha: float, a: float) -> torch.Tensor:
    """Per-shard flat Eqs. 6-10: ``wg_loc`` / ``stacked_loc`` carry one
    column block of the flattened weights, the scalar inputs are whole.
    The ops of ``aggregate_cache_stacked``, so a block's values match the
    single-device form's."""
    wts = stacked_staleness_weights(staleness, n_samples, a)
    a_t = alpha * staleness_weight(torch.mean(staleness), a)
    return _stacked_merge(wg_loc, stacked_loc, wts, a_t)


def _flat_cache(w_global: Params, cache: List[Tuple[Params, int, int]],
                t: int, n_shards: int):
    """Shared by the mesh and reference sharded paths: flatten and
    zero-pad the weights and the stacked cache to a multiple of
    ``n_shards``, on the weights' device."""
    wg, spec = _flatten_f32(w_global)
    stk = torch.stack([_flatten_f32(c[0])[0] for c in cache])
    size = wg.numel()
    pad = (-size) % n_shards
    if pad:
        wg = torch.cat([wg, wg.new_zeros(pad)])
        stk = torch.cat([stk, stk.new_zeros((len(cache), pad))], dim=1)
    staleness = torch.tensor([t - c[1] for c in cache], dtype=torch.float32,
                             device=wg.device)
    n_samples = torch.tensor([c[2] for c in cache], dtype=torch.float32,
                             device=wg.device)
    return wg, stk, staleness, n_samples, size, spec


def make_sharded_aggregator(mesh):
    """The aggregation sharded over the last axis of ``mesh``.

    Returns ``agg(w_global, cache, t, alpha, a) -> new w_global``: every
    rank of the axis reduces its column block of the flat vector (the K
    staleness weights computed whole on each) and the blocks are
    all-gathered over the axis, so every rank ends with the same weights.
    On a 2-D mesh each group along the axis reduces the whole vector."""
    from repro_torch.sharding.rules import all_gather_dim, axis_group
    group, index, m = axis_group(mesh, mesh.mesh_dim_names[-1])

    def agg(w_global, cache, t, alpha, a=0.5):
        wg, stk, staleness, n_samples, size, spec = _flat_cache(
            w_global, cache, t, m)
        block = wg.numel() // m
        sl = slice(index * block, (index + 1) * block)
        out = all_gather_dim(_sharded_agg_body(
            wg[sl], stk[:, sl], staleness, n_samples, alpha, a), 0, group, m)
        return _unflatten_f32(out[:size], spec)

    return agg


def aggregate_cache_sharded_ref(w_global: Params,
                                cache: List[Tuple[Params, int, int]],
                                t: int, alpha: float, a: float = 0.5,
                                n_shards: int = 2) -> Params:
    """Mesh-free replay of the sharded reduction: the same flat split into
    ``n_shards`` column blocks, each reduced by the same per-shard body on
    the weights' device."""
    wg, stk, staleness, n_samples, size, spec = _flat_cache(
        w_global, cache, t, n_shards)
    block = wg.numel() // n_shards
    outs = [_sharded_agg_body(wg[s * block:(s + 1) * block],
                              stk[:, s * block:(s + 1) * block], staleness,
                              n_samples, alpha, a)
            for s in range(n_shards)]
    return _unflatten_f32(torch.cat(outs)[:size], spec)
