"""Parameter dicts as pytrees, and the device rule of the port's entry points.

The JAX package carries model parameters as pytrees of arrays; the port
carries them as plain dicts of tensors, nested for the LM families
(``{"embed", "final_norm": {"scale"}, "layers": {"attn": {...}, ...}}``)
and flat for the CNN and the MLP.  ``jax.tree.leaves`` orders a dict's
leaves by sorted key at every level, and the packed stream layout, the
stochastic-rounding draw order and a checkpoint's leaf list all follow
that order, so every walk over a parameter dict in the port goes through
:func:`leaves`, :func:`paths` / :func:`unflatten` or :func:`tree_map`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
Path = Tuple[str, ...]              # a leaf's keys, outermost first


def _is_node(v: Any, is_leaf: Optional[Callable]) -> bool:
    return isinstance(v, dict) and not (is_leaf is not None and is_leaf(v))


def paths(tree: Dict[str, Any], is_leaf: Optional[Callable] = None
          ) -> List[Path]:
    """The key paths of a nested dict's leaves in ``jax.tree.leaves``
    order: sorted keys at every level, depth first.  A flat dict's paths
    are its sorted keys, each a 1-tuple.  A dict for which ``is_leaf``
    is true counts as a leaf."""
    out: List[Path] = []
    for k in sorted(tree):
        v = tree[k]
        if _is_node(v, is_leaf):
            out.extend((k,) + p for p in paths(v, is_leaf))
        else:
            out.append((k,))
    return out


def leaves(tree: Any, is_leaf: Optional[Callable] = None) -> List[Any]:
    """The leaves of a (nested) dict in ``jax.tree.leaves`` order (sorted
    keys at every level; a dict for which ``is_leaf`` is true is a leaf);
    a list or tuple passes through as the leaf list it already is."""
    if isinstance(tree, dict):
        out: List[Any] = []
        for k in sorted(tree):
            v = tree[k]
            out.extend(leaves(v, is_leaf) if _is_node(v, is_leaf)
                       else (v,))
        return out
    return list(tree)


def unflatten(names: Sequence[Path], values: Sequence[Any]
              ) -> Dict[str, Any]:
    """Inverse of :func:`leaves` for the key paths ``names`` (as
    :func:`paths` gives them): the nested dict with ``values`` at those
    paths."""
    out: Dict[str, Any] = {}
    for path, v in zip(names, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def tree_map(fn: Callable, tree: Dict[str, Any], *rest: Dict[str, Any]
             ) -> Dict[str, Any]:
    """``fn`` applied leaf by leaf to a nested dict and to ``rest`` (dicts
    of the same structure), the result in ``tree``'s structure."""
    return {k: tree_map(fn, v, *(r[k] for r in rest))
            if isinstance(v, dict) else fn(v, *(r[k] for r in rest))
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
