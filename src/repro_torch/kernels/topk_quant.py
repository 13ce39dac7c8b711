"""Kernel B: block-local threshold Top-K + int8/int4 quantization.

Each ``block``-sized row of a flat tensor (zero-padded; the padding counts
in the kept fraction) finds its magnitude threshold with a fixed-iteration
bisection on ``mean(|x| >= mid) > p_s``, keeps what clears it, and
quantizes symmetrically with the row's max-abs scale of the kept values.
Block-local K approximates global Top-K; a block as large as the tensor
gives the whole-tensor threshold channel.  Outputs: int8 levels
``(M, block)`` and f32 scales ``(M, 1)``, for any ``block >= 1``.

Two versions of the same function, bit-identical to each other and to the
JAX package's ``topk_quant`` (for blocks below 2^24, where the count of
kept values is exact in f32):

* :func:`topk_quant_plain` -- plain PyTorch, on any device;
* the CUDA kernel ``csrc/topk_quant.cu``: one launch for a whole list of
  leaves, rows read straight from the unpadded leaves, the bisection taken
  8 steps per pass over a row; a row of more than
  ``CTA_ROW`` values is spread over a thread-block cluster of up to
  ``CLUSTER`` CTAs.

:func:`topk_quant_leaves` and :func:`topk_quant` pick by device: the
kernel for CUDA tensors (a build or launch failure raises), the plain
version for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

DEFAULT_BLOCK = 16384

# the kernel's largest cluster (kCluster in csrc/topk_quant.cu) and the
# leaves one launch takes (kMaxLeaves; a longer list takes one launch per
# MAX_LEAVES); a row takes one CTA per CTA_ROW values, up to a cluster of
# CLUSTER (measured on the card: at block 16,384 a 4-CTA cluster beats one
# CTA, PERF.md)
CTA_ROW = 4096
CLUSTER = 8
MAX_LEAVES = 64

# launches of the CUDA kernel in this process; set to 0 to count a window
LAUNCHES = 0

Rows = Tuple[torch.Tensor, torch.Tensor]


def n_rows(n: int, block: int) -> int:
    """Rows of a leaf of ``n`` values (at least one, as for an empty leaf
    the JAX package pads nothing but the port keeps a row of zeros)."""
    return max(1, -(-n // block))


def _pad_rows(x: torch.Tensor, block: int) -> torch.Tensor:
    """Flat ``x`` zero-padded to ``(M, block)`` in its own dtype."""
    flat = x.reshape(-1)
    m = n_rows(flat.numel(), block)
    xp = torch.zeros(m * block, dtype=flat.dtype, device=flat.device)
    xp[:flat.numel()] = flat
    return xp.reshape(m, block)


def topk_quant_plain(xp: torch.Tensor, p_s: float = 0.25, bits: int = 8,
                     iters: int = 16) -> Rows:
    """Plain PyTorch version of kernel B on padded rows ``xp (M, block)``
    -> (levels int8 (M, block), scales f32 (M, 1))."""
    x = xp.to(torch.float32)
    block = x.shape[1]
    ax = x.abs()
    p_s32 = torch.tensor(p_s, dtype=torch.float32)
    lo = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    hi = ax.max(dim=1).values + torch.tensor(1e-12, dtype=torch.float32)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        # count / block in f32: the count is exact, and so is its f32
        # value below 2^24; one IEEE division, as in XLA's mean
        frac = (ax >= mid[:, None]).sum(dim=1).to(torch.float32) / block
        keep = frac > p_s32.to(x.device)
        lo, hi = torch.where(keep, mid, lo), torch.where(keep, hi, mid)
    thr = 0.5 * (lo + hi)
    kept = torch.where(ax >= thr[:, None], x, torch.zeros_like(x))
    L = 2 ** (bits - 1) - 1
    scale = torch.clamp(kept.abs().max(dim=1, keepdim=True).values,
                        min=1e-12)
    levels = torch.clamp(torch.round(kept / scale * L), -L, L)
    return levels.to(torch.int8), scale


def _check(leaves: Sequence[torch.Tensor], bits: int, iters: int,
           block: int) -> torch.device:
    if not leaves:
        raise ValueError("topk_quant needs at least one leaf")
    device, dtype = leaves[0].device, leaves[0].dtype
    for x in leaves:
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"topk_quant takes float32 or bfloat16, got "
                            f"{x.dtype}")
        if x.device != device or x.dtype != dtype:
            raise ValueError("topk_quant leaves of one call must share "
                             "their device and dtype")
    if not 1 <= block < 2 ** 31:
        raise ValueError(f"block must be in [1, 2^31), got {block}")
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must be in [2, 8], got {bits}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"topk_quant runs on cuda or cpu, not {device}")
    return device


def least_kept_count(block: int, p_s: float) -> int:
    """The least count c of a row's values >= mid with c / block > p_s in
    f32 (``block + 1`` when none): the bisection keeps mid as lo iff its
    count is at least this.  The f32 division is monotone in c, so the
    search starts at floor(p_s * block) and moves a step or two."""
    fb, ps = np.float32(block), np.float32(p_s)

    def keeps(c: int) -> bool:
        return bool(np.float32(c) / fb > ps)
    c = min(max(int(np.floor(np.float64(ps) * block)), 0), block + 1)
    while c > 0 and keeps(c - 1):
        c -= 1
    while c <= block and not keeps(c):
        c += 1
    return c


def slices_for(block: int) -> int:
    """CTAs that take one row of ``block`` values: one per ``CTA_ROW``
    values, up to a cluster of ``CLUSTER``."""
    return min(CLUSTER, -(-block // CTA_ROW))


def launch_plan(sizes: Sequence[int], block: int
                ) -> Tuple[List[int], int, List[Tuple[int, int, int]]]:
    """Shape-only plan of the kernel's launches for leaves of ``sizes``
    values: (each leaf's first output row, total rows, and per launch its
    leaves ``[a, b)`` and its row count), ``MAX_LEAVES`` leaves a launch."""
    firsts, total = [], 0
    for n in sizes:
        firsts.append(total)
        total += n_rows(n, block)
    launches = []
    for a in range(0, len(sizes), MAX_LEAVES):
        b = min(len(sizes), a + MAX_LEAVES)
        launches.append((a, b, (firsts[b] if b < len(sizes) else total)
                         - firsts[a]))
    return firsts, total, launches


def _rows_cuda(leaves: Sequence[torch.Tensor], p_s: float, bits: int,
               iters: int, block: int) -> Tuple[torch.Tensor, torch.Tensor,
                                                List[int]]:
    """All leaves' rows through the kernel: (levels (R, block), scales
    (R, 1), each leaf's first row)."""
    from repro_torch.kernels.build import check, library
    global LAUNCHES
    device = leaves[0].device
    flats = [x.contiguous().reshape(-1) for x in leaves]
    firsts, total, launches = launch_plan([x.numel() for x in flats], block)
    levels = torch.empty((total, block), dtype=torch.int8, device=device)
    scales = torch.empty((total, 1), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    slices = slices_for(block)
    need = least_kept_count(block, p_s)
    lib = library()
    i64 = ctypes.c_longlong
    for a, b, rows in launches:
        k = b - a
        err = lib.topk_quant_launch(
            k, (i64 * k)(*[x.data_ptr() for x in flats[a:b]]),
            (i64 * k)(*[x.numel() for x in flats[a:b]]),
            (i64 * k)(*firsts[a:b]), rows,
            int(flats[0].dtype == torch.bfloat16), block, slices, need,
            int(bits), int(iters), levels.data_ptr(), scales.data_ptr(),
            stream)
        check(err, "topk_quant kernel")
        LAUNCHES += 1
    return levels, scales, firsts


def topk_quant_rows(leaves: Sequence[torch.Tensor], p_s: float, bits: int,
                    iters: int, block: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
    """(levels (R, block), scales (R, 1), each leaf's first row) of all
    leaves' rows, stacked in leaf order."""
    if _check(leaves, bits, iters, block).type == "cuda":
        return _rows_cuda(leaves, p_s, bits, iters, block)
    outs = [topk_quant_plain(_pad_rows(x, block), p_s, bits, iters)
            for x in leaves]
    firsts = launch_plan([x.numel() for x in leaves], block)[0]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]),
            firsts)


def _split_rows(t: torch.Tensor, firsts: List[int]) -> List[torch.Tensor]:
    """Each leaf's rows of the stacked ``t``, as views."""
    ends = firsts[1:] + [t.shape[0]]
    return [t[a:b] for a, b in zip(firsts, ends)]


def topk_quant_leaves(leaves: Sequence[torch.Tensor], *, p_s: float = 0.25,
                      bits: int = 8, iters: int = 16,
                      block: int = DEFAULT_BLOCK) -> List[Rows]:
    """``[topk_quant(x, ...) for x in leaves]``: on CUDA tensors one kernel
    launch for the list (up to ``MAX_LEAVES`` leaves), the results views
    into one allocation; on CPU tensors the plain version, leaf by leaf.
    The leaves share device and dtype."""
    levels, scales, firsts = topk_quant_rows(leaves, p_s, bits, iters, block)
    return list(zip(_split_rows(levels, firsts), _split_rows(scales, firsts)))


def topk_quant(x: torch.Tensor, *, p_s: float = 0.25, bits: int = 8,
               iters: int = 16, block: int = DEFAULT_BLOCK) -> Rows:
    """Compress a tensor (flattened): -> (levels int8 (M, block), scales
    f32 (M, 1)).  The CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    return topk_quant_leaves([x], p_s=p_s, bits=bits, iters=iters,
                             block=block)[0]


def dequant(levels: torch.Tensor, scales: torch.Tensor, bits: int, n: int,
            shape) -> torch.Tensor:
    L = 2 ** (bits - 1) - 1
    flat = (levels.to(torch.float32) * scales / L).reshape(-1)[:n]
    return flat.reshape(shape)

