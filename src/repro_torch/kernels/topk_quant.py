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

The channel form is the cohort trainer's threshold channel
(``kernels.ops.threshold_channel_leaves``): each leaf ``(C, ...)`` holds C
rows of its own length (one device's leaf, no pad), and the result is the
dequantized value in the leaf's dtype and layout, bit-identical to the
JAX package's ``sparsify_quantize_threshold`` under ``jax.jit`` and
``jax.vmap`` (the kept fraction ``count * f32(1/len)``, the value
``(level * scale) * f32(1/L)``), for ``bits`` 2..16 or 32.  Its plain
version is :func:`threshold_channel_plain`; on the card the same kernel
runs with one launch per cluster size (:func:`channel_plan`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.compression import (FLOAT_BITS, recip32,
                                          sparsify_quantize_threshold_rows)

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



# ----------------------------------------------------------------------
# the channel form
# ----------------------------------------------------------------------
def threshold_channel_plain(leaves: Sequence[torch.Tensor], p_s: float,
                            p_q: int, iters: int = 12, wire: bool = False):
    """Plain PyTorch version of the channel form: each leaf ``(C, ...)``
    row by row through ``sparsify_quantize_threshold``, all C rows of a
    leaf at once; each result has its leaf's shape and dtype.  With
    ``wire`` (``p_q`` <= 8) -> (values, int8 levels of each leaf's shape,
    f32 scales (C,) of each leaf): the wire of ``compress_delta``."""
    outs = [sparsify_quantize_threshold_rows(
        x.reshape(x.shape[0], -1), p_s, p_q, iters, wire) for x in leaves]
    if not wire:
        return [o.reshape(x.shape) for o, x in zip(outs, leaves)]
    return ([o[0].reshape(x.shape) for o, x in zip(outs, leaves)],
            [o[1].reshape(x.shape) for o, x in zip(outs, leaves)],
            [o[2] for o in outs])


@functools.lru_cache(maxsize=1024)
def channel_need(row_len: int, p_s: float) -> int:
    """The channel form's need: the least count c with ``f32(c) *
    f32(1/row_len) > p_s`` in f32 (``row_len + 1`` when none), the rule
    XLA compiles the mean to.  The product is monotone in c."""
    r, ps = np.float32(recip32(row_len)), np.float32(p_s)

    def keeps(c: int) -> bool:
        return bool(np.float32(np.float32(c) * r) > ps)
    c = min(max(int(np.floor(np.float64(ps) * row_len)), 0), row_len + 1)
    while c > 0 and keeps(c - 1):
        c -= 1
    while c <= row_len and not keeps(c):
        c += 1
    return c


def channel_plan(row_lens: Sequence[int], rows: Sequence[int]
                 ) -> List[Tuple[int, List[int], List[int], int]]:
    """Shape-only plan of the channel form's launches for leaves of
    ``rows[i]`` rows of ``row_lens[i]`` values: leaves grouped by the CTAs
    a row takes (``slices_for``; a cluster's size is fixed per launch), in
    increasing order, ``MAX_LEAVES`` leaves a launch.  Per launch: (CTAs a
    row, its leaves' indices, each one's first row in the launch, its row
    count)."""
    groups: dict = {}
    for i, n in enumerate(row_lens):
        groups.setdefault(slices_for(n), []).append(i)
    plan = []
    for slices in sorted(groups):
        idx = groups[slices]
        for a in range(0, len(idx), MAX_LEAVES):
            part = idx[a:a + MAX_LEAVES]
            firsts = [int(f) for f in np.cumsum(
                [0] + [rows[i] for i in part[:-1]])]
            plan.append((slices, part, firsts, sum(rows[i] for i in part)))
    return plan


def check_channel(leaves: Sequence[torch.Tensor], p_q: int,
                  iters: int) -> torch.device:
    """The channel form's argument checks (the same for both versions)."""
    if not leaves:
        raise ValueError("the threshold channel needs at least one leaf")
    device, dtype = leaves[0].device, leaves[0].dtype
    for x in leaves:
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"the threshold channel takes float32 or "
                            f"bfloat16, got {x.dtype}")
        if x.device != device or x.dtype != dtype:
            raise ValueError("leaves of one channel call must share their "
                             "device and dtype")
        if x.dim() < 1 or x.shape[0] < 1:
            raise ValueError("a channel leaf needs a leading row axis")
    if not (2 <= p_q <= 16 or p_q >= FLOAT_BITS):
        raise ValueError(f"p_q must be in [2, 16] or >= 32, got {p_q}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the threshold channel runs on cuda or cpu, not "
                         f"{device}")
    return device


@functools.lru_cache(maxsize=256)
def _channel_launches(shapes: Tuple[Tuple[int, ...], ...], p_s: float
                      ) -> List[Tuple[int, List[int], tuple, tuple, tuple,
                                      tuple, int]]:
    """The shape-only arguments of the channel form's launches for leaves
    of ``shapes``: per launch (CTAs a row, its leaves' indices, their
    element counts, row lengths, needs and first rows as ``ctypes``
    arrays, its row count).  Empty leaves are left out."""
    i64 = ctypes.c_longlong
    live = [i for i, s in enumerate(shapes) if int(np.prod(s)) > 0]
    ns = [int(np.prod(shapes[i])) for i in live]
    lens = [n // shapes[i][0] for n, i in zip(ns, live)]
    out = []
    for slices, part, firsts, rows in channel_plan(
            lens, [shapes[i][0] for i in live]):
        k = len(part)
        out.append((slices, [live[j] for j in part],
                    (i64 * k)(*[ns[j] for j in part]),
                    (i64 * k)(*[lens[j] for j in part]),
                    (i64 * k)(*[0 if p_s >= 1.0 else
                                channel_need(lens[j], p_s) for j in part]),
                    (i64 * k)(*firsts), rows))
    return out


def threshold_channel_cuda(leaves: Sequence[torch.Tensor], p_s: float,
                           p_q: int, iters: int, wire: bool = False):
    """The channel form through the kernel: one launch per group of
    :func:`channel_plan`, results in fresh tensors of the leaves' shapes.
    With ``wire`` (``p_q`` <= 8) -> (values, int8 levels, f32 scales per
    row), as :func:`threshold_channel_plain` gives them."""
    from repro_torch.kernels.build import check, library
    global LAUNCHES
    if wire and p_q > 8:
        raise ValueError(f"the int8 wire takes p_q <= 8, got {p_q}")
    flats = [x.contiguous() for x in leaves]
    outs = [torch.empty_like(x) for x in flats]
    lvls = [torch.empty(x.shape, dtype=torch.int8, device=x.device)
            for x in flats] if wire else None
    scales = [torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
              for x in flats] if wire else None
    bits = FLOAT_BITS if p_q >= FLOAT_BITS else int(p_q)
    is_bf16 = int(flats[0].dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(flats[0].device).cuda_stream
    lib = library()
    i64 = ctypes.c_longlong
    for slices, sel, ns, lens, needs, firsts, rows in _channel_launches(
            tuple(tuple(x.shape) for x in flats), float(p_s)):
        k = len(sel)
        sc = None
        if wire:    # one scale per row of the launch, split after it
            sc = torch.empty(rows, dtype=torch.float32,
                             device=flats[0].device)
        err = lib.topk_channel_launch(
            k, (i64 * k)(*[flats[i].data_ptr() for i in sel]),
            (i64 * k)(*[outs[i].data_ptr() for i in sel]), ns, lens, needs,
            firsts, rows, is_bf16, slices, bits, int(iters),
            int(p_s >= 1.0),
            (i64 * k)(*[lvls[i].data_ptr() for i in sel]) if wire else None,
            sc.data_ptr() if wire else None, stream)
        check(err, "topk_quant channel kernel")
        LAUNCHES += 1
        if wire:
            for j, i in enumerate(sel):
                scales[i] = sc.narrow(0, firsts[j], flats[i].shape[0])
    vals = [o.view(x.shape) for o, x in zip(outs, leaves)]
    if not wire:
        return vals
    return vals, [v.view(x.shape) for v, x in zip(lvls, leaves)], scales
