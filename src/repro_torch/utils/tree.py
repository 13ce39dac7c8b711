"""Parameter dicts as pytrees, and the device rule of the port's entry points.

The JAX package carries model parameters as pytrees of arrays; the port
carries them as plain ``dict[str, Tensor]``.  ``jax.tree.leaves`` orders a
dict's leaves by sorted key, and both the packed stream layout and the
stochastic-rounding draw order depend on that order, so every walk over a
parameter dict in the port goes through :func:`leaves` / :func:`unflatten`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


def leaves(tree: Any) -> List[Any]:
    """The leaves of a dict in sorted-key order; a list or tuple passes
    through as the leaf list it already is."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return list(tree)


def unflatten(names: Sequence[str], values: Sequence[Any]) -> Dict[str, Any]:
    """Inverse of :func:`leaves` for the key list ``names``."""
    return dict(zip(names, values))


def tree_map(fn: Callable, tree: Dict[str, Any]) -> Dict[str, Any]:
    """``fn`` applied to every leaf of a nested dict, same structure."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def tree_stack(trees: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Nested dicts of one structure -> one dict of their leaves stacked on
    a new leading axis (the layer-stacked layout of the JAX package)."""
    first = trees[0]
    return {k: tree_stack([t[k] for t in trees])
            if isinstance(first[k], dict)
            else torch.stack([t[k] for t in trees]) for k in first}


def from_numpy(params: Dict[str, Any], device) -> Dict[str, Any]:
    """The JAX package's parameters (a dict, nested or flat, of any
    array-likes) as the port's: f32 tensors on ``device``, same keys, same
    layouts."""
    return {k: from_numpy(v, device) if isinstance(v, dict) else
            torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in params.items()}


def to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameters (a dict, nested or flat) as host numpy arrays
    (the JAX package's inputs), same keys, same layouts."""
    return {k: to_numpy(v) if isinstance(v, dict) else
            v.detach().cpu().numpy() for k, v in params.items()}


def resolve_device(device: Optional[Any] = None) -> torch.device:
    """The device an entry point runs on: ``device`` when the caller names
    one, else the card.  With no card and no device named this raises:
    the port never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return torch.device("cuda")
