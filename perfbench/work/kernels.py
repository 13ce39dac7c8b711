"""Bytes and operations of the port's kernels at one call's shape, and
their bounds on the card: the larger of bytes over the HBM rate and
operations over the rate of the units that compute them.  Each input byte
is counted read once and each output byte written once; two operations a
multiply-add.

These are the counts of the port's kernel table (``PERF.md``) and of
``chip_smoke.py`` (``Smoke.c_bwd_work`` and the phase 35 and 10 counts),
written out again.
"""
from __future__ import annotations

from typing import Tuple

from perfbench.work.peaks import F32_FLOPS, HBM_BYTES, TF32_FLOPS


def channel_work(values: int, rows: int, wire: bool = False
                 ) -> Tuple[int, int]:
    """Kernel B's channel form over ``values`` f32 values in ``rows``
    rows: each value read once and its dequantized value written once
    (with the wire also its int8 level, and an f32 scale a row); 12
    bisection steps and 5 operations of quantization a value."""
    nbytes = 8 * values + ((values + 4 * rows) if wire else 0)
    return nbytes, 17 * values


def channel_bound_s(values: int, rows: int, wire: bool = False) -> float:
    nbytes, ops = channel_work(values, rows, wire)
    return max(nbytes / HBM_BYTES, ops / F32_FLOPS)


def ssd_fwd_work(cells: int, heads: int, L: int, P: int, N: int
                 ) -> Tuple[int, int]:
    """Kernel C (forward) over ``cells`` (batch, chunk, head) cells of
    ``heads`` heads sharing B and C, f32: reads xb (L, P) and cum (L) a
    cell, B and C (L, N) a head group; writes y (L, P), the state (N, P)
    and the decay a cell.  C Bᵀ once a head group and the masked product
    a cell on the causal triangle, the chunk state a cell."""
    gb = cells // heads
    nbytes = 4 * (cells * L * P + 2 * gb * L * N + cells * L
                  + cells * L * P + cells * N * P + cells)
    ops = gb * L * (L + 1) * N + cells * L * (L + 1) * P \
        + cells * 2 * L * N * P
    return nbytes, ops


def ssd_fwd_bound_s(cells: int, heads: int, L: int, P: int, N: int
                    ) -> float:
    """On the tensor cores in split TF32: three TF32 products an f32
    one."""
    nbytes, ops = ssd_fwd_work(cells, heads, L, P, N)
    return max(nbytes / HBM_BYTES, 3 * ops / TF32_FLOPS)


def ssd_bwd_work(cells: int, heads: int, L: int, P: int, N: int,
                 elem: int = 4) -> Tuple[int, int]:
    """Kernel C's backward: reads xb, b, c, cum and the cotangents gy, gs,
    ga once, writes dxb, db, dc and dcum once (b and c of ``elem``
    bytes); C Bᵀ once a head group, dW = gy Xᵀ and Wᵀ gy a cell, the
    heads' dCB times B and times C once a head group, (B ∘ d) gS and X
    gSᵀ a cell, on and below the diagonal."""
    G, gb = cells, cells // heads
    nbytes = (4 * (2 * G * L * P + G * N * P + G + G * L)
              + 2 * elem * gb * L * N
              + 4 * (G * L * P + G * L) + 2 * elem * gb * L * N)
    ops = 3 * gb * L * (L + 1) * N + G * (2 * L * (L + 1) * P
                                          + 4 * L * N * P)
    return nbytes, ops


def ssd_bwd_bound_s(cells: int, heads: int, L: int, P: int, N: int,
                    tensor_cores: bool = True) -> float:
    """Split TF32 on the tensor cores (the route of large chunks), or f32
    FMAs (the route of small ones)."""
    nbytes, ops = ssd_bwd_work(cells, heads, L, P, N)
    rate = 3 * ops / TF32_FLOPS if tensor_cores else ops / F32_FLOPS
    return max(nbytes / HBM_BYTES, rate)
