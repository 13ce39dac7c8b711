"""Public entry points of the port's kernels.

Which version runs follows the tensors' device: the hand-written CUDA
kernel for CUDA tensors, the plain PyTorch version for CPU tensors.  There
is no fallback between them: on a CUDA tensor a kernel that fails to build
or launch raises.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

from repro_torch.kernels.fused_pack import pack_leaves
from repro_torch.kernels.ssd_scan import ssd_chunked_kernel
from repro_torch.core.compression import FLOAT_BITS
from repro_torch.kernels.topk_quant import (  # noqa: F401  (re-exported)
    DEFAULT_BLOCK, check_channel, dequant, threshold_channel_cuda,
    threshold_channel_plain, topk_quant, topk_quant_rows)
from repro_torch.utils.tree import leaves as tree_leaves


def fused_wire_encode(tree: Any, p_s: float, p_q: int) -> bytes:
    """One-pass packed wire encode of a parameter dict (or a leaf list, in
    stream order): Alg. 3 serialization, bit-identical to
    ``PackedBitstreamCodec``'s host pipeline with deterministic rounding;
    ``len(result) == expected_pytree_wire_bytes``."""
    return pack_leaves(tree_leaves(tree), p_s, p_q)


def compress_roundtrip(x: torch.Tensor, p_s: float = 0.25, bits: int = 8,
                       block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Kernel-backed lossy compress -> decompress of a tensor."""
    return compress_roundtrip_leaves([x], p_s, bits, block)[0]


def compress_roundtrip_leaves(leaves: Sequence[torch.Tensor],
                              p_s: float = 0.25, bits: int = 8,
                              block: int = DEFAULT_BLOCK
                              ) -> List[torch.Tensor]:
    """``[compress_roundtrip(x, ...) for x in leaves]`` (the JAX
    ``compress_roundtrip`` mapped over a dict's leaves): on CUDA tensors one
    kernel launch for the list, and the rows of all leaves dequantized in
    one elementwise chain; each result has its leaf's shape and dtype."""
    levels, scales, firsts = topk_quant_rows(leaves, p_s, bits, 16, block)
    L = 2 ** (bits - 1) - 1
    vals = (levels.to(torch.float32) * scales / L).view(-1)
    return [vals.narrow(0, r * block, x.numel()).view(x.shape).to(x.dtype)
            for r, x in zip(firsts, leaves)]


def threshold_channel_leaves(leaves: Sequence[torch.Tensor], p_s: float,
                             p_q: int, iters: int = 12, wire: bool = False):
    """The cohort trainer's threshold channel: each leaf ``(C, ...)`` row
    by row (one row per device) through ``sparsify_quantize_threshold``,
    the JAX ``jax.vmap(ThresholdGraphCodec(p_s, p_q, iters).apply_tree)``.
    On CUDA tensors kernel B's channel form, one entry of its plan per
    cluster size (2 for the CNN) and one per group of rows of ``WIDE_MIN``
    values or more (its wide route), each entry one count of its
    ``LAUNCHES``; on CPU tensors its plain version.  At ``p_s >= 1``
    and ``p_q >= 32`` the leaves come back as they are, with no launch.
    With ``wire`` (``p_q`` <= 8) it returns (values, int8 levels, f32
    scales per row): the federated round's ``compress_delta`` of each row,
    as its mesh branch puts it on the all-gather."""
    if p_s >= 1.0 and p_q >= FLOAT_BITS and not wire:
        return list(leaves)
    if check_channel(leaves, p_q, iters).type == "cuda":
        return threshold_channel_cuda(leaves, p_s, p_q, iters, wire)
    return threshold_channel_plain(leaves, p_s, p_q, iters, wire)


def ssd(xh: torch.Tensor, b: torch.Tensor, c: torch.Tensor, dt: torch.Tensor,
        la: torch.Tensor, chunk: int, init_state: Optional[torch.Tensor] = None):
    """Mamba2 SSD with the intra-chunk step on kernel C: xh (B, S, H, P), b
    and c (B, S, N), dt and la (B, S, H) -> y (B, S, H, P), final state
    (B, H, P, N)."""
    return ssd_chunked_kernel(xh, b, c, dt, la, chunk, init_state)
