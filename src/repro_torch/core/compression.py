"""TEASQ-Fed wire compression on the host: Top-K sparsification + QSGD.

Paper Algorithms 3 (compress) and 4 (decompress):
  1. keep the top ``p_s`` fraction of each tensor by magnitude, zero the rest;
  2. quantize the kept values to ``p_q`` bits (QSGD-style uniform levels);
  3. pack (values, indices) -- zeros are not transmitted.

This is the numpy half of the JAX package's module, kept bit for bit:
``compress_tensor`` (with the smallest-index tie rule), its inverse, and
the shape-only size model.  Stochastic rounding draws from a numpy
``RandomState`` in the same order as the JAX package, so event timelines
stay comparable between the two.  Pytrees are parameter dicts, walked in
sorted-key order (``repro_torch.utils.tree.leaves``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.utils.tree import leaves

FLOAT_BITS = 32


def _host(x: Any) -> np.ndarray:
    """A leaf as a host f32 array (a tensor comes off its device)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _numel(x: Any) -> int:
    return int(np.prod(tuple(x.shape), dtype=np.int64))


def topk_count(n: int, p_s: float) -> int:
    """Number of kept values for an ``n``-element tensor at rate ``p_s``."""
    return max(1, int(round(p_s * n))) if p_s < 1.0 else n


def index_bits(n: int) -> int:
    """Bits per transmitted index for an ``n``-element tensor -- shared by
    the size model and the packed serializer, which must agree exactly."""
    return max(1, math.ceil(math.log2(max(n, 2))))


def _wire_bits(n: int, k: int, p_q: int) -> int:
    """Packed size of ``k`` kept values out of ``n``: p_q bits/value, index
    bits/value when sparse, one f32 scale."""
    vbits = min(p_q, FLOAT_BITS)
    return k * (vbits + (index_bits(n) if k < n else 0)) + FLOAT_BITS


def compress_tensor(x: Any, p_s: float, p_q: int,
                    rng: Optional[np.random.RandomState] = None
                    ) -> Dict[str, Any]:
    x = _host(x)
    flat = x.reshape(-1)
    n = flat.size
    k = topk_count(n, p_s)
    if k < n:
        ax = np.abs(flat)
        idx = np.argpartition(ax, n - k)[n - k:]
        # argpartition's choice among magnitudes tied at the k-th place is
        # arbitrary; the wire format pins "boundary ties keep the smallest
        # flat indices".  Only the ambiguous slots are rewritten, so when
        # every tied magnitude is already selected, idx -- and hence the
        # stochastic-rounding draw order -- is untouched.
        kth_sel = ax[idx] == ax[idx].min()
        canon = np.flatnonzero(ax == ax[idx].min())
        if canon.size > int(np.count_nonzero(kth_sel)):
            idx = idx.copy()
            idx[kth_sel] = canon[:int(np.count_nonzero(kth_sel))]
    else:
        idx = np.arange(n)
    values = flat[idx]
    if p_q < FLOAT_BITS:
        L = 2 ** (p_q - 1) - 1
        scale = max(float(np.max(np.abs(values))), 1e-12)
        y = values / scale * L
        if rng is not None:
            y = np.floor(y) + (rng.random_sample(y.shape) < (y - np.floor(y)))
        else:
            y = np.round(y)
        values = np.clip(y, -L, L).astype(np.int32)
    else:
        scale = 1.0
    return {"values": values, "indices": idx.astype(np.int64),
            "scale": scale, "shape": x.shape, "p_q": p_q, "n": n}


def decompress_tensor(c: Dict[str, Any]) -> np.ndarray:
    flat = np.zeros(c["n"], np.float32)
    vals = c["values"]
    if c["p_q"] < FLOAT_BITS:
        L = 2 ** (c["p_q"] - 1) - 1
        vals = vals.astype(np.float32) * c["scale"] / L
    flat[c["indices"]] = vals
    return flat.reshape(c["shape"])


def tensor_wire_bits(c: Dict[str, Any]) -> int:
    """Transmitted size: p_q bits/value + index bits/value + one f32 scale."""
    return _wire_bits(c["n"], len(c["values"]), c["p_q"])


def compress_pytree(tree: Dict[str, Any], p_s: float, p_q: int,
                    rng: Optional[np.random.RandomState] = None
                    ) -> Dict[str, Dict[str, Any]]:
    """``compress_tensor`` per leaf, in sorted-key order (the order in
    which stochastic rounding draws from ``rng``)."""
    return {k: compress_tensor(tree[k], p_s, p_q, rng) for k in sorted(tree)}


def decompress_pytree(ctree: Dict[str, Dict[str, Any]]
                      ) -> Dict[str, np.ndarray]:
    return {k: decompress_tensor(ctree[k]) for k in sorted(ctree)}


def pytree_wire_bytes(ctree: Dict[str, Dict[str, Any]]) -> int:
    """Transmitted size of a compressed pytree: one bit-level concatenated
    stream across tensors, rounded up to whole bytes -- exactly what
    ``PackedBitstreamCodec`` emits."""
    return (sum(tensor_wire_bits(c) for c in leaves(ctree)) + 7) // 8


def pytree_dense_bytes(tree: Any) -> int:
    return sum(_numel(x) * 4 for x in leaves(tree))


def expected_tensor_wire_bits(n: int, p_s: float, p_q: int) -> int:
    """Wire size of an ``n``-element tensor under (p_s, p_q), from its
    shape alone (the packed format's size is value-independent)."""
    return _wire_bits(n, topk_count(n, p_s), p_q)


def expected_pytree_wire_bytes(tree: Any, p_s: float, p_q: int) -> int:
    """Shape-only ``pytree_wire_bytes`` (the dense size when nothing is
    compressed)."""
    if p_s >= 1.0 and p_q >= FLOAT_BITS:
        return pytree_dense_bytes(tree)
    return (sum(expected_tensor_wire_bits(_numel(x), p_s, p_q)
                for x in leaves(tree)) + 7) // 8

