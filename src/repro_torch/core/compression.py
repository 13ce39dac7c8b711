"""TEASQ-Fed wire compression on the host: Top-K sparsification + QSGD.

Paper Algorithms 3 (compress) and 4 (decompress):
  1. keep the top ``p_s`` fraction of each tensor by magnitude, zero the rest;
  2. quantize the kept values to ``p_q`` bits (QSGD-style uniform levels);
  3. pack (values, indices) -- zeros are not transmitted.

Two families of entry points, as in the JAX package's module:

* the in-graph primitives (``topk_mask`` ... ``sparsify_quantize_threshold``)
  on tensors, on their device, bit for bit with the JAX functions under
  ``jax.jit``.  XLA turns a division by a constant into a product with its
  f32 reciprocal, so the kept fraction is ``count * f32(1/n)`` and the
  dequantized value ``(level * scale) * f32(1/L)``; the ``_rows`` forms
  take one tensor per row of a 2-D input (the cohort trainer's stacked
  devices, as ``jax.vmap`` gives them);
* the host half, kept bit for bit: ``compress_tensor`` (with the
  smallest-index tie rule), its inverse, and the shape-only size model.
  Stochastic rounding draws from a numpy ``RandomState`` in the same order
  as the JAX package, so event timelines stay comparable between the two.
  Pytrees are parameter dicts, walked in sorted-key order
  (``repro_torch.utils.tree.leaves``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import leaves, paths, unflatten

FLOAT_BITS = 32


def _host(x: Any) -> np.ndarray:
    """A leaf as a host f32 array (a tensor comes off its device)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _numel(x: Any) -> int:
    return int(np.prod(tuple(x.shape), dtype=np.int64))


def recip32(n: int) -> float:
    """``f32(1) / f32(n)``: the constant XLA multiplies by where the JAX
    code divides by ``n``."""
    return float(np.float32(1.0) / np.float32(n))


# ----------------------------------------------------------------------
# in-graph primitives (tensors on their device)
# ----------------------------------------------------------------------
def topk_mask(x: torch.Tensor, p_s: float) -> torch.Tensor:
    """Boolean mask of the top ``p_s`` fraction of |x| (global per
    tensor); magnitudes tied with the k-th largest are all kept."""
    if p_s >= 1.0:
        return torch.ones_like(x, dtype=torch.bool)
    k = max(1, int(round(p_s * x.numel())))
    ax = x.abs()
    thresh = torch.topk(ax.reshape(-1), k).values[-1]
    return ax >= thresh


def quantize_levels(x: torch.Tensor, bits: int,
                    key: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """QSGD-style symmetric quantization to ``bits`` bits: (f32 levels in
    [-L, L], f32 scale).  Without ``key`` the rounding is to nearest (half
    to even); with ``key`` (a ``torch.Generator`` on ``x``'s device) it is
    stochastic and unbiased, as in QSGD: ``floor(y) + (u < y - floor(y))``
    with ``u`` uniform in [0, 1).  The JAX package draws ``u`` from
    ``jax.random``, whose bits the port does not reproduce, so this path
    agrees with it in distribution, not bit for bit."""
    if bits >= FLOAT_BITS:
        return x, torch.tensor(1.0, dtype=torch.float32, device=x.device)
    L = 2 ** (bits - 1) - 1
    # the max in x's own dtype, as the JAX function takes it
    scale = torch.clamp(x.abs().max(), min=1e-12).to(torch.float32)
    y = x.to(torch.float32) / scale * L
    if key is not None:
        low = torch.floor(y)
        u = torch.rand(y.shape, generator=key, dtype=torch.float32,
                       device=y.device)
        y = low + (u < y - low).to(torch.float32)
    else:
        y = torch.round(y)
    return torch.clamp(y, -L, L), scale


def dequantize_levels(levels: torch.Tensor, scale: torch.Tensor,
                      bits: int) -> torch.Tensor:
    if bits >= FLOAT_BITS:
        return levels
    L = 2 ** (bits - 1) - 1
    return levels.to(torch.float32) * scale * recip32(L)


def sparsify_quantize_dense(x: torch.Tensor, p_s: float, p_q: int,
                            key: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
    """Dense compress -> decompress round trip with exact Top-K; with
    ``key`` the quantizer rounds stochastically (:func:`quantize_levels`)."""
    mask = topk_mask(x, p_s)
    kept = torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))
    levels, scale = quantize_levels(kept, p_q, key)
    return dequantize_levels(levels, scale, p_q).to(x.dtype) * mask


def approx_topk_threshold_rows(ax: torch.Tensor, p_s: float,
                               iters: int = 12) -> torch.Tensor:
    """Per row of ``ax`` (R, n) = |x|, the magnitude threshold keeping
    about ``p_s`` of the row: ``iters`` bisection steps on ``mean(ax >=
    mid) > p_s`` from (0, max + 1e-12) -> (R,) f32."""
    n = ax.shape[1]
    ps = torch.tensor(p_s, dtype=torch.float32, device=ax.device)
    lo = torch.zeros(ax.shape[0], dtype=torch.float32, device=ax.device)
    hi = ax.max(dim=1).values + 1e-12
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        # the count is exact; XLA multiplies it by f32(1/n)
        frac = (ax >= mid[:, None]).sum(dim=1).to(torch.float32) * \
            recip32(n)
        keep = frac > ps
        lo, hi = torch.where(keep, mid, lo), torch.where(keep, hi, mid)
    return 0.5 * (lo + hi)


def approx_topk_threshold(ax: torch.Tensor, p_s: float,
                          iters: int = 12) -> torch.Tensor:
    """The threshold of the whole tensor ``ax`` = |x| (a 0-d f32 tensor):
    the fixed-iteration bisection kernel B runs."""
    return approx_topk_threshold_rows(ax.reshape(1, -1), p_s, iters)[0]


def sparsify_quantize_threshold_rows(x: torch.Tensor, p_s: float, p_q: int,
                                     iters: int = 12, wire: bool = False):
    """:func:`sparsify_quantize_threshold` of each row of ``x`` (R, n),
    in ``x``'s dtype.  With ``wire`` (``p_q`` <= 8) -> (values, int8
    levels (R, n), f32 scales (R,)): the levels and scales are the federated
    round's ``compress_delta`` of each row."""
    if wire and p_q > 8:
        raise ValueError(f"the int8 wire takes p_q <= 8, got {p_q}")
    if p_s >= 1.0 and p_q >= FLOAT_BITS:
        return x
    xf = x.to(torch.float32)
    mask = None
    kept = xf
    if p_s < 1.0:
        ax = xf.abs()
        mask = ax >= approx_topk_threshold_rows(ax, p_s, iters)[:, None]
        kept = torch.where(mask, xf, torch.zeros((), device=x.device))
    if p_q < FLOAT_BITS:
        L = 2 ** (p_q - 1) - 1
        scale = torch.clamp(kept.abs().max(dim=1, keepdim=True).values,
                            min=1e-12)
        levels = torch.clamp(torch.round(kept / scale * L), -L, L)
        kept = levels * scale * recip32(L)
        if mask is not None:
            kept = torch.where(mask, kept, torch.zeros((), device=x.device))
        if wire:
            return kept.to(x.dtype), levels.to(torch.int8), scale[:, 0]
    return kept.to(x.dtype)


def sparsify_quantize_threshold(x: torch.Tensor, p_s: float, p_q: int,
                                iters: int = 12) -> torch.Tensor:
    """Approximate in-graph channel: bisection-threshold sparsification
    (not exact Top-K) + deterministic uniform quantization, over the whole
    tensor; the kept fraction is within ~2^-iters (+ magnitude ties) of
    ``p_s``.  The cohort trainer's channel; kernel B's channel form
    (``kernels.ops.threshold_channel_leaves``) computes it on the card."""
    if p_s >= 1.0 and p_q >= FLOAT_BITS:
        return x
    return sparsify_quantize_threshold_rows(
        x.reshape(1, -1), p_s, p_q, iters).reshape(x.shape)


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


def _is_compressed(node: Dict[str, Any]) -> bool:
    """A ``compress_tensor`` record (a leaf of a compressed tree)."""
    return "indices" in node and "p_q" in node


def compress_pytree(tree: Dict[str, Any], p_s: float, p_q: int,
                    rng: Optional[np.random.RandomState] = None
                    ) -> Dict[str, Dict[str, Any]]:
    """``compress_tensor`` per leaf, in ``jax.tree.leaves`` order (the
    order in which stochastic rounding draws from ``rng``)."""
    names = paths(tree)
    return unflatten(names, [compress_tensor(x, p_s, p_q, rng)
                             for x in leaves(tree)])


def decompress_pytree(ctree: Dict[str, Dict[str, Any]]
                      ) -> Dict[str, np.ndarray]:
    return unflatten(paths(ctree, _is_compressed),
                     [decompress_tensor(c)
                      for c in leaves(ctree, _is_compressed)])


def pytree_wire_bytes(ctree: Dict[str, Dict[str, Any]]) -> int:
    """Transmitted size of a compressed pytree: one bit-level concatenated
    stream across tensors, rounded up to whole bytes -- exactly what
    ``PackedBitstreamCodec`` emits."""
    return (sum(tensor_wire_bits(c)
                for c in leaves(ctree, _is_compressed)) + 7) // 8


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


def roundtrip_pytree(tree: Dict[str, Any], p_s: float, p_q: int,
                     rng: Optional[np.random.RandomState] = None
                     ) -> Tuple[Dict[str, np.ndarray], int]:
    """compress -> wire bytes -> decompress (the lossy channel)."""
    c = compress_pytree(tree, p_s, p_q, rng)
    return decompress_pytree(c), pytree_wire_bytes(c)
