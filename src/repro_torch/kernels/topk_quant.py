"""Kernel B: block-local threshold Top-K + int8/int4 quantization.

Each ``block``-sized row of a flat tensor (zero-padded; the padding counts
in the kept fraction) finds its magnitude threshold with a fixed-iteration
bisection on ``mean(|x| >= mid) > p_s``, keeps what clears it, and
quantizes symmetrically with the row's max-abs scale of the kept values.
Block-local K approximates global Top-K.  Outputs: int8 levels
``(M, block)`` and f32 scales ``(M, 1)``.

Two versions of the same function, bit-identical to each other and to the
JAX package's ``topk_quant`` for power-of-two blocks:

* :func:`topk_quant_plain` -- plain PyTorch, on any device;
* the CUDA kernel ``csrc/topk_quant.cu`` (one CTA per row, the row in
  shared memory).

:func:`topk_quant` picks by device: the kernel for CUDA tensors (a build or
launch failure raises), the plain version for CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

DEFAULT_BLOCK = 16384          # 64 KiB of f32 per row, in shared memory
MAX_BLOCK = 16384

# launches of the CUDA kernel in this process (one per topk_quant call on
# CUDA tensors); set to 0 to count a window
LAUNCHES = 0


def _pad_rows(x: torch.Tensor, block: int) -> torch.Tensor:
    """Flat ``x`` zero-padded to ``(M, block)`` in its own dtype."""
    flat = x.reshape(-1)
    m = max(1, -(-flat.numel() // block))
    xp = torch.zeros(m * block, dtype=flat.dtype, device=flat.device)
    xp[:flat.numel()] = flat
    return xp.reshape(m, block)


def topk_quant_plain(xp: torch.Tensor, p_s: float = 0.25, bits: int = 8,
                     iters: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
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
        # count / block in f32: the count is exact, and so is the mean of a
        # power-of-two block
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


def _topk_quant_cuda(xp: torch.Tensor, p_s: float, bits: int,
                     iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    from repro_torch.kernels.build import check, library
    global LAUNCHES
    m, block = xp.shape
    levels = torch.empty((m, block), dtype=torch.int8, device=xp.device)
    scales = torch.empty((m, 1), dtype=torch.float32, device=xp.device)
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    err = library().topk_quant_launch(
        xp.data_ptr(), int(xp.dtype == torch.bfloat16), m, block,
        float(p_s), int(bits), int(iters), levels.data_ptr(),
        scales.data_ptr(), stream)
    check(err, "topk_quant kernel")
    LAUNCHES += 1
    return levels, scales


def topk_quant(x: torch.Tensor, *, p_s: float = 0.25, bits: int = 8,
               iters: int = 16, block: int = DEFAULT_BLOCK
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compress a tensor (flattened): -> (levels int8 (M, block), scales
    f32 (M, 1)).  The CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"topk_quant takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not 1 <= block <= MAX_BLOCK:
        raise ValueError(f"block must be in [1, {MAX_BLOCK}], got {block}")
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must be in [2, 8], got {bits}")
    xp = _pad_rows(x, block)
    if xp.device.type == "cuda":
        return _topk_quant_cuda(xp, p_s, bits, iters)
    if xp.device.type == "cpu":
        return topk_quant_plain(xp, p_s, bits, iters)
    raise ValueError(f"topk_quant runs on cuda or cpu, not {xp.device}")


def dequant(levels: torch.Tensor, scales: torch.Tensor, bits: int, n: int,
            shape) -> torch.Tensor:
    L = 2 ** (bits - 1) - 1
    flat = (levels.to(torch.float32) * scales / L).reshape(-1)[:n]
    return flat.reshape(shape)
