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
  ``CLUSTER`` CTAs (the channel form's rows of ``WIDE_MIN`` values or more
  take its wide route instead).

:func:`topk_quant_leaves` and :func:`topk_quant` pick by device: the
kernel for CUDA tensors (a build or launch failure raises), the plain
version for CPU tensors.

The channel form is the cohort trainer's threshold channel
(``kernels.ops.threshold_channel_leaves``): each leaf ``(C, ...)`` holds C
rows of its own length (one device's leaf, no pad), and the result is the
dequantized value in the leaf's dtype and layout, bit-identical to the
JAX package's ``sparsify_quantize_threshold`` under ``jax.jit`` and
``jax.vmap`` (the kept fraction ``count * f32(1/len)``, the value
``(level * scale) * f32(1/L)``), for ``bits`` 2..16 or 32, while the
kept counts the bisection meets near its need stay at or under 2^24
(p_s * len <= 2^24; see :func:`channel_need`).  Its plain version is
:func:`threshold_channel_plain`.  On the card one C call runs
its :func:`channel_plan` over two routes: a row of fewer than ``WIDE_MIN``
values on the same kernel as the block form, one launch per cluster size;
a longer row on the wide route, one CTA per tile over the whole card (its
max, one histogram pass per 12 bisection steps, its store).
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.compression import (FLOAT_BITS, recip32,
                                          sparsify_quantize_threshold_rows)
from repro_torch.kernels.build import check, library

DEFAULT_BLOCK = 16384

# the kernel's largest cluster (kCluster in csrc/topk_quant.cu) and the
# leaves one launch takes (kMaxLeaves; a longer list takes one launch per
# MAX_LEAVES); a row takes one CTA per CTA_ROW values, up to a cluster of
# CLUSTER (measured on the card: at block 16,384 a 4-CTA cluster beats one
# CTA, PERF.md)
CTA_ROW = 4096
CLUSTER = 8
MAX_LEAVES = 64
# the channel form's two routes: a row of fewer than WIDE_MIN values takes
# the cluster route above (an 8-CTA cluster's slices fit shared memory up
# to 376,832 values); a longer one the wide route, one CTA per tile of the
# row over the whole card (WIDE marks its plan entries), a tile of about a
# TILE_CTAS-th of the entry's values within [TILE_MIN, TILE_MAX].  Measured
# on the card (chip_smoke.py phase 35, PERF.md): the cluster route is as
# fast or faster at rows of 2^18 values, the wide route 2-3x faster at 2^19
# and up to 50x at 2^27; a 256th of the values was the best tile, or close
# to it, at every size of the sweep.
WIDE_MIN = 376_833
TILE_MIN, TILE_MAX, TILE_CTAS = 8_192, 131_072, 256
WIDE = 0

# launches of kernel B in this process, set to 0 to count a window: one
# per block-form launch and one per entry of the channel form's plan,
# however many CUDA launches the entry makes (a wide entry makes 3 or more)
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
    XLA compiles the mean to.  The product is monotone in c.

    The port decides from the exact integer count.  The JAX package's
    jitted mean sums the mask in f32, which is the count only up to 2^24:
    past it an f32 cannot hold every integer, and the sum may land a
    count or more off (``tests/test_torch_channel.py`` reproduces one
    such row, 18,000,000 values at p_s = 0.99).  So the channel form is
    bit-exact with the reference where p_s * row_len <= 2^24.  Past that a
    bisection step whose count lands within that error of the need may
    decide the other way, and the result is held as ``gather_q``'s float
    noise is (``tests/torch_fed_rules.py``): within the threshold plus one
    quantization step."""
    r, ps = np.float32(recip32(row_len)), np.float32(p_s)

    def keeps(c: int) -> bool:
        return bool(np.float32(np.float32(c) * r) > ps)
    c = min(max(int(np.floor(np.float64(ps) * row_len)), 0), row_len + 1)
    while c > 0 and keeps(c - 1):
        c -= 1
    while c <= row_len and not keeps(c):
        c += 1
    return c


class ChannelLaunch(NamedTuple):
    """One entry of :func:`channel_plan`: the leaves ``part`` (indices),
    each one's first row in the entry (``firsts``), its ``rows`` in all,
    and the route: ``slices`` CTAs a row of one cluster, or ``WIDE``, with
    its ``tile`` length, each leaf's first tile (``tile_firsts``), the
    entry's ``tiles`` and its first row of the workspace (``ws_row``)."""
    slices: int
    part: List[int]
    firsts: List[int]
    rows: int
    tile: int
    tile_firsts: List[int]
    tiles: int
    ws_row: int


def wide_tile_len(values: int) -> int:
    """The wide route's tile for an entry of ``values`` values: the least
    power of two at or above a TILE_CTAS-th of them, within [TILE_MIN,
    TILE_MAX] (fewer CTAs than the card holds at once leave it idle, and
    each CTA merges its histogram into the row's)."""
    return min(TILE_MAX, max(TILE_MIN, 1 << (-(-values // TILE_CTAS)
                                             - 1).bit_length()))


WIDE_BITS = 12    # bisection steps a pass of the wide route (kWideBits)


def ws_stride(iters: int) -> int:
    """u32 words of a wide-route row's workspace (``ws_stride`` in
    csrc/topk_quant.cu): its max, lo and hi, then per pass of 12 bisection
    steps 4,096 bins and a ticket."""
    return 4 + -(-iters // WIDE_BITS) * ((1 << WIDE_BITS) + 4)


def channel_plan(row_lens: Sequence[int], rows: Sequence[int],
                 tile: Optional[int] = None, wide_min: int = WIDE_MIN
                 ) -> List[ChannelLaunch]:
    """Shape-only plan of the channel form for leaves of ``rows[i]`` rows
    of ``row_lens[i]`` values: a leaf whose rows hold fewer than
    ``wide_min`` values takes the cluster route, grouped with the others
    of its cluster size (``slices_for``; fixed per launch) in increasing
    order; the longer ones take the wide route, one CTA per ``tile`` values
    of each row (:func:`wide_tile_len` of the entry's values by default),
    after them; ``MAX_LEAVES`` leaves an entry.  Each wide entry has rows
    of the workspace of its own."""
    for n in row_lens:
        if not 1 <= n < 2 ** 31:
            raise ValueError(f"a channel row holds 1 to 2^31 - 1 values, "
                             f"got {n}")
    if tile is not None and tile < 1:
        raise ValueError(f"the wide route's tile must be >= 1, got {tile}")
    groups: dict = {}
    for i, n in enumerate(row_lens):
        groups.setdefault(WIDE if n >= wide_min else slices_for(n),
                          []).append(i)
    plan, ws_row = [], 0
    for slices in sorted(groups, key=lambda s: (s == WIDE, s)):
        idx = groups[slices]
        for a in range(0, len(idx), MAX_LEAVES):
            part = idx[a:a + MAX_LEAVES]
            firsts = [int(f) for f in np.cumsum(
                [0] + [rows[i] for i in part[:-1]])]
            total = sum(rows[i] for i in part)
            if total * max(slices, 1) >= 2 ** 31:
                raise ValueError(f"a channel launch takes under 2^31 rows "
                                 f"of CTAs, got {total} rows")
            if slices != WIDE:
                plan.append(ChannelLaunch(slices, part, firsts, total, 0, [],
                                          0, 0))
                continue
            t = tile or wide_tile_len(sum(rows[i] * row_lens[i]
                                          for i in part))
            per = [rows[i] * -(-row_lens[i] // t) for i in part]
            if sum(per) >= 2 ** 31:
                raise ValueError(f"a wide launch takes under 2^31 tiles, got "
                                 f"{sum(per)} (tile {t})")
            plan.append(ChannelLaunch(
                WIDE, part, firsts, total, t,
                [int(f) for f in np.cumsum([0] + per[:-1])], sum(per),
                ws_row))
            ws_row += total
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
    if device.type not in ("cuda", "cpu", "meta"):   # meta: the dry run
        raise ValueError(f"the threshold channel runs on cuda or cpu, not "
                         f"{device}")
    return device


class _Layout(NamedTuple):
    """The shape-only part of a channel call (:func:`_channel_layout`)."""
    table: np.ndarray     # the plan as topk_channel_run reads it
    entries: int
    out_len: int          # elements of the flat output (and level) buffer
    views: list           # per leaf (shape, stride, offset) in it
    scale_len: int        # rows of the flat scale buffer
    scale_views: list     # per leaf (offset, rows) in it
    ws_rows: int          # rows of the wide route's workspace


OUT_ALIGN = 16    # each leaf's output starts at a multiple of 16 values


@functools.lru_cache(maxsize=256)
def _channel_layout(shapes: Tuple[torch.Size, ...], p_s: float,
                    tile: Optional[int], wide_min: int) -> _Layout:
    """The plan of :func:`channel_plan` for leaves of ``shapes`` as one
    int64 table, and where each leaf's results lie in the call's flat
    buffers.  Empty leaves are left out of the plan."""
    sizes = [int(np.prod(s)) for s in shapes]
    offs = [int(o) for o in np.cumsum(
        [0] + [-(-n // OUT_ALIGN) * OUT_ALIGN for n in sizes])]
    live = [i for i, n in enumerate(sizes) if n > 0]
    lens = [sizes[i] // shapes[i][0] for i in live]
    plan = channel_plan(lens, [shapes[i][0] for i in live], tile, wide_min)
    table, scale_row, scale_views = [len(plan)], 0, [None] * len(shapes)
    for e in plan:
        table += [e.slices, len(e.part), e.rows, e.tiles, e.ws_row,
                  scale_row, e.tile]
        for j, i in enumerate(e.part):
            leaf = live[i]
            table += [leaf, sizes[leaf], lens[i],
                      0 if p_s >= 1.0 else channel_need(lens[i], p_s),
                      e.firsts[j], e.tile_firsts[j] if e.tile_firsts else 0,
                      offs[leaf]]
            scale_views[leaf] = (scale_row + e.firsts[j], shapes[leaf][0])
        scale_row += e.rows
    for i, s in enumerate(shapes):       # empty leaves' scales: unwritten
        if scale_views[i] is None:
            scale_views[i] = (scale_row, s[0])
            scale_row += s[0]
    views = [(s, tuple(int(st) for st in np.cumprod(
        (1,) + tuple(s[:0:-1]))[::-1]) if len(s) else (), o)
        for s, o in zip(shapes, offs)]
    ws_rows = sum(e.rows for e in plan if e.slices == WIDE)
    return _Layout(np.asarray(table, np.int64), len(plan), max(offs[-1], 1),
                   views, max(scale_row, 1), scale_views, ws_rows)


_WORKSPACE: dict = {}


def _workspace(device: torch.device, stream: int, words: int
               ) -> torch.Tensor:
    """The wide route's workspace on ``device`` for ``stream``: kept
    between calls (each call zeroes its rows on the stream) and grown when
    a call needs more."""
    key = (device.index, stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws.numel() < words:
        ws = torch.empty(max(words, 1 << 14), dtype=torch.int32,
                         device=device)
        _WORKSPACE[key] = ws
    return ws


def threshold_channel_cuda(leaves: Sequence[torch.Tensor], p_s: float,
                           p_q: int, iters: int, wire: bool = False, *,
                           tile: Optional[int] = None,
                           wide_min: int = WIDE_MIN):
    """The channel form through the kernels: one C call for the whole
    :func:`channel_plan` (each cluster entry one launch, each wide entry
    its workspace zeroed and 2 + ceil(iters / 12) launches), the results
    views into one flat output buffer.  With ``wire`` (``p_q`` <= 8) ->
    (values, int8 levels, f32 scales per row), as
    :func:`threshold_channel_plain` gives them, from one level and one
    scale buffer.  ``tile`` and ``wide_min`` choose the routes (the
    defaults were measured on the card)."""
    global LAUNCHES
    if wire and p_q > 8:
        raise ValueError(f"the int8 wire takes p_q <= 8, got {p_q}")
    xs = [x.contiguous() for x in leaves]
    x0 = xs[0]
    dev = x0.device
    lay = _channel_layout(tuple(x.shape for x in xs), float(p_s), tile,
                          wide_min)
    out = torch.empty(lay.out_len, dtype=x0.dtype, device=dev)
    lvl = torch.empty(lay.out_len, dtype=torch.int8, device=dev) \
        if wire else None
    sc = torch.empty(lay.scale_len, dtype=torch.float32, device=dev) \
        if wire else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    iters = int(iters)
    words = lay.ws_rows * ws_stride(0 if p_s >= 1.0 else iters)
    ws = _workspace(dev, stream, words).data_ptr() if words else None
    ptrs = np.fromiter((x.data_ptr() for x in xs), np.int64, len(xs))
    check(library().topk_channel_run(
        lay.table.ctypes.data, ptrs.ctypes.data, out.data_ptr(),
        lvl.data_ptr() if wire else None, sc.data_ptr() if wire else None,
        ws, words, int(x0.dtype == torch.bfloat16),
        FLOAT_BITS if p_q >= FLOAT_BITS else int(p_q), iters,
        int(p_s >= 1.0), stream), "topk_quant channel kernel")
    LAUNCHES += lay.entries
    vals = [out.as_strided(*v) for v in lay.views]
    if not wire:
        return vals
    return (vals, [lvl.as_strided(*v) for v in lay.views],
            [sc.narrow(0, *v) for v in lay.scale_views])
