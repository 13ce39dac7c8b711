"""The TEASQ-Fed datacenter round, plain PyTorch, one group at a time.

One round from the global weights ``w0`` (a nested dict of f32 tensors):

1. each of G groups runs E prox-SGD steps (Eq. 5) on its own rows of the
   batch, ``w <- w - lr (grad + mu (w - w0))``; the batch's rows are
   group-major, group g's step e taking rows ``(g E + e) mb`` onwards,
   ``mb = B / (G E)``;
2. each group's delta ``w - w0``, leaf by leaf as one row, is compressed
   (``gather_q``): a threshold found by ``iters`` bisection steps on
   ``f32(count) * f32(1/n) > p_s`` from (0, max + 1e-12) keeps about p_s
   of the row, the kept values are quantized to ``p_q`` bits against the
   row's largest kept magnitude (round half to even) and dequantized as
   ``(level * scale) * f32(1/L)``; ``psum`` and ``gather_f32`` combine
   the f32 deltas;
3. the deltas are combined with the staleness weights of Eqs. 6-9, one
   sample a group: ``w0 + alpha_t sum_g S_g / sum S * delta_g`` with
   ``S = (staleness + 1)^-a`` and ``alpha_t = alpha S(mean staleness)``.

Only one group's gradients are held at a time, and of those only one
row's activations (the rows' gradients summed, each weighted by its
share), so the reference fits on the card once the port's state is
freed.  It also records the norm
of each leaf's gradient at the first group's first step, for the rule
that leaves out leaves whose gradient is nought to rounding.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch


def flatten(tree: Dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(dotted path, leaf) pairs in sorted key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += flatten(v, prefix + k + ".")
        else:
            out.append((prefix + k, v))
    return out


def unflatten(pairs) -> Dict:
    out: Dict = {}
    for path, v in pairs:
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def recip32(n: int) -> float:
    return float(np.float32(1.0) / np.float32(n))


def staleness_weights(staleness: torch.Tensor, a: float, alpha: float):
    """Eqs. 6-9 with one sample a group -> (normalized weights (G,),
    alpha_t)."""
    ex = torch.tensor(-a, dtype=torch.float32, device=staleness.device)
    s = torch.pow(staleness + 1.0, ex)
    a_t = alpha * torch.pow(torch.mean(staleness) + 1.0, ex)
    return s / torch.sum(s), a_t


def compress_row(x: torch.Tensor, p_s: float, p_q: int, iters: int
                 ) -> torch.Tensor:
    """The threshold Top-K and quantization round trip of one flat f32
    row (the module docstring's step 2)."""
    ax = x.abs()
    n = ax.numel()
    ps = torch.tensor(p_s, dtype=torch.float32, device=x.device)
    lo = torch.zeros((), dtype=torch.float32, device=x.device)
    hi = ax.max() + 1e-12
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        keep = (ax >= mid).sum().to(torch.float32) * recip32(n) > ps
        lo, hi = torch.where(keep, mid, lo), torch.where(keep, hi, mid)
    mask = ax >= 0.5 * (lo + hi)
    kept = torch.where(mask, x, torch.zeros((), device=x.device))
    L = 2 ** (p_q - 1) - 1
    scale = torch.clamp(kept.abs().max(), min=1e-12)
    levels = torch.clamp(torch.round(kept / scale * L), -L, L)
    return torch.where(mask, levels * scale * recip32(L),
                       torch.zeros((), device=x.device))


def _loss_and_grads(loss_fn, names, w, rows):
    """The mean loss over ``rows`` and its gradient, a row at a time:
    each row's loss weighted by its share of the rows, so the sum is the
    mean over all of them."""
    ws = [v.detach().requires_grad_(True) for v in w]
    total, grads = 0.0, None
    share = 1.0 / rows.shape[0]
    for a in range(rows.shape[0]):
        loss = loss_fn(unflatten(zip(names, ws)), rows[a:a + 1]) * share
        gs = torch.autograd.grad(loss, ws)
        grads = list(gs) if grads is None else [
            x + y for x, y in zip(grads, gs)]
        total += float(loss.detach())
        del loss, gs
    return total, grads


def fed_round(loss_fn: Callable, w0: Dict, tokens: torch.Tensor,
              staleness, fed: Dict) -> Tuple[Dict, float, List[float]]:
    """One round (the module docstring).  ``loss_fn(params, tokens)``;
    ``staleness`` (G,) ints; ``fed`` the cell's round settings.  -> (new
    weights, mean local loss, each leaf's gradient norm at group 0's
    first step, in ``flatten`` order)."""
    G, E = fed["groups"], fed["local_steps"]
    lr, mu = fed["lr"], fed["mu"]
    B = tokens.shape[0]
    if B % (G * E):
        raise ValueError(f"batch {B} does not split into {G} groups of "
                         f"{E} steps")
    mb = B // (G * E)
    pairs = flatten(w0)
    names = [p for p, _ in pairs]
    base = [v.detach() for _, v in pairs]
    dev = base[0].device
    wts, a_t = staleness_weights(
        torch.as_tensor(staleness, device=dev).to(torch.float32),
        fed.get("a", 0.5), fed.get("alpha", 0.6))
    acc = [torch.zeros_like(v) for v in base]
    losses, grad_norms = [], []
    for g in range(G):
        w = base
        for e in range(E):
            rows = tokens[(g * E + e) * mb:(g * E + e + 1) * mb]
            loss, grads = _loss_and_grads(loss_fn, names, w, rows)
            if g == 0 and e == 0:
                grad_norms = [float(torch.linalg.vector_norm(gr))
                              for gr in grads]
            with torch.no_grad():
                w = [v - lr * (gr + mu * (v - v0))
                     for v, gr, v0 in zip(w, grads, base)]
            losses.append(loss)
            del grads
        with torch.no_grad():
            for i, (v, v0) in enumerate(zip(w, base)):
                d = (v - v0).reshape(-1)
                if fed["schedule"] == "gather_q":
                    d = compress_row(d, fed["p_s"], fed["p_q"],
                                     fed.get("threshold_iters", 12))
                acc[i] += wts[g] * d.reshape(v.shape)
        del w
    with torch.no_grad():
        new = [v0 + a_t * u for v0, u in zip(base, acc)]
    return unflatten(zip(names, new)), float(np.mean(losses)), grad_norms
