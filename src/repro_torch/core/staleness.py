"""Staleness-weighted cached aggregation (paper Eqs. 6-10), in PyTorch.

Everything is f32 on the parameters' device.  ``aggregate_cache`` keeps
the JAX package's tuple form: the weighted sum runs over the cached
updates in cache order, one multiply-add per update, which is the
reduction order of the JAX kernel (``sum(w * l for ...)``).
``aggregate_cache_stacked`` is the wave mode's form: the K cached leaves
stacked on a leading axis (on the device) and reduced with one
``tensordot`` per leaf.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.utils.tree import Params, leaves, tree_map


def staleness_weight(staleness, a: float = 0.5) -> torch.Tensor:
    """Eq. 6: S(t - h_c) = (t - h_c + 1)^(-a)."""
    return (torch.as_tensor(staleness, dtype=torch.float32) + 1.0) ** (-a)


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
    return wts, alpha * (torch.mean(staleness) + 1.0) ** (-a)


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


def aggregate_cache_stacked(w_global: Params,
                            cache: List[Tuple[Params, int, int]], t: int,
                            alpha: float, a: float = 0.5) -> Params:
    """Eqs. 6-10 with the K cached leaves stacked on a leading axis on the
    parameters' device (no host round trip) and reduced by one f32
    ``tensordot`` per leaf, then the Eq. 10 merge.  It is
    ``aggregate_cache`` up to the order of the K-term sums."""
    wts, a_t = _cache_weights(w_global, cache, t, alpha, a)

    def merge(w, *cached):
        u = torch.tensordot(wts, torch.stack(cached).float(), dims=1)
        return a_t * u + (1.0 - a_t) * w

    return tree_map(merge, w_global, *(c[0] for c in cache))
