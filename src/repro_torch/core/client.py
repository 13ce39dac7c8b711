"""Device-side local update (paper Alg. 1 device process, Eq. 5).

E local epochs of minibatch SGD on
    f_k(w; x) + (mu/2) ||w - w^t||^2
where w^t is the (decompressed) global model pulled from the server.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import leaves, paths, unflatten

Params = Dict[str, torch.Tensor]


def local_update(w_global: Params, data_x: torch.Tensor,
                 data_y: torch.Tensor, loss_fn: Callable, *, epochs: int,
                 batch_size: int, lr: float, mu: float,
                 rng: np.random.RandomState) -> Tuple[Params, float, int]:
    """Run E epochs of prox-SGD from ``w_global``.  Returns (w_local,
    last_loss, n_steps).  ``loss_fn(params, batch)`` is the task loss.

    The minibatch order comes from the same ``rng.permutation`` draws as
    the JAX package's, one per epoch.  Data and parameters stay on their
    device; the only host sync is the one ``.item()`` on the last loss.
    """
    names = paths(w_global)
    anchor = [v.detach() for v in leaves(w_global)]
    params = [a.clone() for a in anchor]
    n = len(data_y)
    steps = 0
    loss = None
    for _ in range(epochs):
        order = torch.from_numpy(rng.permutation(n)).to(data_x.device)
        for s in range(0, n - batch_size + 1, batch_size):
            sel = order[s:s + batch_size]
            batch = {"images": data_x[sel], "labels": data_y[sel]}
            for p in params:
                p.requires_grad_(True)
            loss = loss_fn(unflatten(names, params), batch)
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                params = [p - lr * (g + mu * (p - a))
                          for p, g, a in zip(params, grads, anchor)]
            steps += 1
    last = float("nan") if loss is None else loss.item()
    return unflatten(names, params), last, steps
