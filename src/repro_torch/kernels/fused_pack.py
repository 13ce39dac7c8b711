"""Kernel A: sparsify + quantize + bit-pack a parameter dict in one pass.

The whole of Algorithm 3 in one kernel launch: for each leaf, the exact
Top-K by magnitude (boundary ties keep the smallest flat indices), QSGD
levels with the f32 max-abs scale of the survivors (offset-binary, or raw
f32 patterns at ``p_q >= 32``), delta-coded survivor indices, and every
field written into the big-endian uint32 words of ONE packed stream (the
JAX package's ``docs/WIRE_FORMAT.md``).  Each leaf's starting bit in the
stream depends on shapes only (:func:`stream_layout`), so leaves encode
independently.

Two versions of the same function, bit-identical to each other and to the
JAX package's ``fused_pack_leaf`` / ``pack_leaves_host``:

* :func:`fused_pack_plain` -- plain PyTorch, on any device;
* the CUDA kernel ``csrc/fused_pack.cu``: one launch for the dict; a leaf
  of more than ``BIG_LEAF`` elements is cut into ``CLUSTER`` slices, one
  per CTA of a thread-block cluster, which select by 8-bit radix passes
  over summed histograms and rank survivors by a cluster-wide exclusive
  prefix; smaller leaves take one CTA each (:func:`launch_rows`).

:func:`fused_pack` picks by device: the kernel for CUDA tensors (a build or
launch failure raises), the plain version for CPU tensors.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.compression import (FLOAT_BITS,
                                          expected_tensor_wire_bits,
                                          index_bits, topk_count)
from repro_torch.kernels.bitpack import words_to_bytes

# launches of the CUDA kernel in this process (one per fused_pack call on
# CUDA tensors); set to 0 to count a window
LAUNCHES = 0

# the kernel's cluster size (kCluster in csrc/fused_pack.cu), and the
# largest leaf that takes one CTA alone
CLUSTER = 8
BIG_LEAF = 16384


def stream_layout(sizes: Sequence[int], p_s: float,
                  p_q: int) -> Tuple[List[int], int]:
    """(starting bit of each leaf, total bits) of the packed stream of
    leaves with ``sizes`` elements -- shape-only."""
    offs, pos = [], 0
    for n in sizes:
        offs.append(pos)
        pos += expected_tensor_wire_bits(int(n), p_s, p_q)
    return offs, pos


def launch_rows(sizes: Sequence[int], p_s: float,
                p_q: int) -> List[List[int]]:
    """The kernel's CTAs, one row each -- shape-only: [leaf index, n, k,
    stream bit offset, index bits, slice start, slice length, CTAs of the
    leaf].  A leaf of more than ``BIG_LEAF`` elements takes a whole cluster
    (``CLUSTER`` contiguous slices, the last one shorter where n is ragged),
    listed first; the others take one CTA each, and idle rows (leaf index
    and n = -1) pad the last cluster."""
    offs, _ = stream_layout(sizes, p_s, p_q)
    big, small = [], []
    for i, (n, off) in enumerate(zip(sizes, offs)):
        head = [i, n, topk_count(n, p_s), off, index_bits(n)]
        if n > BIG_LEAF:
            part = -(-n // CLUSTER)
            big += [head + [min(n, r * part), max(0, min(part, n - r * part)),
                            CLUSTER] for r in range(CLUSTER)]
        else:
            small.append(head + [0, n, 1])
    small += [[-1, -1, 0, 0, 0, 0, 0, 1]] * (-len(small) % CLUSTER)
    return big + small


def _check_leaves(leaves: Sequence[torch.Tensor]) -> torch.device:
    if not leaves:
        raise ValueError("fused_pack needs at least one leaf")
    device = leaves[0].device
    for x in leaves:
        if x.device != device:
            raise ValueError("fused_pack leaves must share one device")
        if x.dtype != torch.float32:
            raise TypeError(f"fused_pack takes float32 leaves, got {x.dtype}")
        if x.numel() >= 2 ** 31:
            raise ValueError("fused_pack leaves must have < 2^31 elements")
    return device


def _leaf_fields(x: torch.Tensor, base: int, p_s: float,
                 p_q: int) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """(values, bit offsets, widths) of every field of one leaf, int64."""
    flat = x.reshape(-1)
    n = flat.numel()
    k = topk_count(n, p_s)
    dev = flat.device
    pat = flat.view(torch.int32).to(torch.int64) & 0x7FFFFFFF
    if k < n:
        thr = torch.sort(pat, descending=True).values[k - 1]
        above = pat > thr
        tie = pat == thr
        tie_rank = torch.cumsum(tie.to(torch.int64), 0) - tie.to(torch.int64)
        need = k - above.sum()
        mask = above | (tie & (tie_rank < need))
        sel = torch.nonzero(mask).reshape(-1)            # index-sorted
    else:
        sel = torch.arange(n, device=dev)
    vals = flat[sel]
    vbits = min(p_q, FLOAT_BITS)
    if p_q < FLOAT_BITS:
        L = 2 ** (p_q - 1) - 1
        scale = torch.clamp(vals.abs().max(), min=1e-12)
        levels = torch.clamp(torch.round((vals / scale) * L), -L, L)
        fields = levels.to(torch.int64) + L
    else:
        scale = torch.ones((), dtype=torch.float32, device=dev)
        fields = vals.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    scale_word = scale.reshape(1).view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    ar = torch.arange(k, device=dev, dtype=torch.int64)
    parts_v = [scale_word, fields]
    parts_o = [torch.full((1,), base, dtype=torch.int64, device=dev),
               base + FLOAT_BITS + ar * vbits]
    parts_w = [torch.full((1,), FLOAT_BITS, dtype=torch.int64, device=dev),
               torch.full((k,), vbits, dtype=torch.int64, device=dev)]
    if k < n:
        ib = index_bits(n)
        deltas = torch.diff(sel, prepend=sel.new_zeros(1))
        parts_v.append(deltas)
        parts_o.append(base + FLOAT_BITS + k * vbits + ar * ib)
        parts_w.append(torch.full((k,), ib, dtype=torch.int64, device=dev))
    return torch.cat(parts_v), torch.cat(parts_o), torch.cat(parts_w)


def fused_pack_plain(leaves: Sequence[torch.Tensor], p_s: float,
                     p_q: int) -> torch.Tensor:
    """Plain PyTorch version of kernel A: the packed stream of ``leaves``
    as int32 words (read them as big-endian uint32), on their device."""
    device = _check_leaves(leaves)
    offs, total = stream_layout([x.numel() for x in leaves], p_s, p_q)
    parts = [_leaf_fields(x, base, p_s, p_q) for x, base in zip(leaves, offs)]
    vals = torch.cat([p[0] for p in parts])
    offsets = torch.cat([p[1] for p in parts])
    widths = torch.cat([p[2] for p in parts])
    nw = (total + 31) // 32
    # each field is one 64-bit window contribution to the word it starts
    # in; fields are bit-disjoint, so the (wrapping) integer sum is the OR
    acc = torch.zeros(nw + 1, dtype=torch.int64, device=device)
    acc.index_add_(0, offsets >> 5,
                   vals << (64 - (offsets & 31) - widths))
    words = (acc >> 32) & 0xFFFFFFFF
    words[1:] |= acc[:-1] & 0xFFFFFFFF
    return words[:nw].to(torch.int32)


def launch_meta(leaves: Sequence[torch.Tensor], p_s: float,
                p_q: int) -> torch.Tensor:
    """:func:`launch_rows` with each leaf index replaced by the leaf's
    data pointer (the leaves must be contiguous), as an int64 tensor on the
    leaves' device."""
    rows = launch_rows([x.numel() for x in leaves], p_s, p_q)
    return torch.tensor([[leaves[r[0]].data_ptr() if r[0] >= 0 else 0]
                         + r[1:] for r in rows],
                        dtype=torch.int64).to(leaves[0].device)


def _fused_pack_cuda(leaves: Sequence[torch.Tensor], p_s: float,
                     p_q: int) -> torch.Tensor:
    from repro_torch.kernels.build import check, library
    global LAUNCHES
    device = leaves[0].device
    leaves = [x.contiguous() for x in leaves]
    meta = launch_meta(leaves, p_s, p_q)
    _, total = stream_layout([x.numel() for x in leaves], p_s, p_q)
    words = torch.zeros((total + 31) // 32 + 1, dtype=torch.int32,
                        device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = library().fused_pack_launch(meta.data_ptr(), meta.shape[0],
                                      words.data_ptr(), int(p_q), stream)
    check(err, "fused_pack kernel")
    LAUNCHES += 1
    return words[:(total + 31) // 32]


def fused_pack(leaves: Sequence[torch.Tensor], p_s: float,
               p_q: int) -> torch.Tensor:
    """The packed stream of ``leaves`` as int32 words on their device: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    device = _check_leaves(leaves)
    if int(p_q) < 2:
        raise ValueError(f"p_q must be >= 2, got {p_q}")
    if device.type == "cuda":
        return _fused_pack_cuda(leaves, p_s, p_q)
    if device.type == "cpu":
        return fused_pack_plain(leaves, p_s, p_q)
    raise ValueError(f"fused_pack runs on cuda or cpu, not {device}")


def words_to_stream(words: torch.Tensor, total_bits: int) -> bytes:
    """Stream words (any device) -> the ``ceil(total_bits/8)`` wire bytes:
    one device-to-host copy, one big-endian conversion."""
    return words_to_bytes(words.cpu().numpy().view(np.uint32), total_bits)


def pack_leaves(leaves: Sequence[torch.Tensor], p_s: float,
                p_q: int) -> bytes:
    """Whole-dict fused encode -> wire bytes."""
    _, total = stream_layout([x.numel() for x in leaves], p_s, p_q)
    return words_to_stream(fused_pack(leaves, p_s, p_q), total)


def fused_pack_leaf(x: torch.Tensor, p_s: float,
                    p_q: int) -> Tuple[bytes, int]:
    """Encode ONE tensor -> (its packed wire segment, its bit length); the
    segment is zero-padded to a whole byte, and ``concat_bitstreams``
    re-joins segments at bit granularity."""
    nbits = expected_tensor_wire_bits(x.numel(), p_s, p_q)
    return pack_leaves([x], p_s, p_q), nbits


def concat_bitstreams(parts: Sequence[Tuple[bytes, int]]) -> bytes:
    """Join per-tensor (payload, nbits) slices into one bit-level stream.

    Each payload's bits past its ``nbits`` must be zero.  A slice lands at
    an arbitrary bit offset, so each of its words contributes to two output
    words; both come from one uint64 shift, accumulated with |=.
    """
    total = sum(nb for _, nb in parts)
    if total == 0:
        return b""
    nw = (total + 31) // 32
    out = np.zeros(nw + 1, np.uint64)
    pos = 0
    for payload, nbits in parts:
        if nbits == 0:
            continue
        pad = (-len(payload)) % 4
        w = np.frombuffer(payload + b"\x00" * pad, dtype=">u4").astype(
            np.uint64)
        base, s = pos >> 5, pos & 31
        comb = w << np.uint64(32 - s)        # s=0 -> shift 32, still < 64
        out[base:base + w.size] |= comb >> np.uint64(32)
        out[base + 1:base + 1 + w.size] |= comb & np.uint64(0xFFFFFFFF)
        pos += nbits
    return words_to_bytes(out[:nw], total)
