"""Kernel C: the Mamba2 SSD intra-chunk step.

The quadratic within-chunk part of state-space duality, per grid cell (one
batch row, one head, one chunk of ``L`` positions):

    CB = C Bᵀ                                   (L x L)
    y  = (CB ∘ exp(cum_i - cum_j) [i >= j]) X̄   (L x P)
    S  = (B ∘ exp(cum[-1] - cum))ᵀ X̄            (N x P)
    a  = exp(cum[-1])

The mask sits in the exponent: above the diagonal ``cum_i - cum_j`` is a
positive log-decay whose ``exp`` overflows.

Two versions of the same function, within the f32 tolerances of each
other and of the JAX package's ``ssd_intra_chunk``:

* :func:`ssd_intra_chunk_plain` -- plain PyTorch, on any device;
* the CUDA kernel ``csrc/ssd_scan.cu``: TF32 warpgroup MMAs with split
  TF32 (hi + lo parts, three products each), one CTA per 64-row tile of
  ``y`` and head group, forming ``C Bᵀ`` once for the heads of its group,
  plus one CTA per head group for ``S`` and ``a``.

:func:`ssd_intra_chunk` picks by device: the kernel for CUDA tensors (a
build or launch failure raises), the plain version for CPU tensors.  Its
gradient is the plain version's, recomputed in the backward pass
(:class:`SSDIntraChunk`); there is no backward kernel.

Cells are ordered (batch, chunk, head).  ``b`` and ``c`` are the same for
every head of a (batch, chunk), so they come once per (batch, chunk):
``b[g // heads]`` serves cell ``g``.  With ``heads=1`` the shapes are the
JAX kernel's, ``(G, L, N)``.  :func:`ssd_chunked_kernel` is the
full-sequence SSD around the step, the counterpart of the JAX package's
``ssd_chunked_pallas``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

MAX_L, MAX_P, MAX_N = 256, 64, 128

# launches of the CUDA kernel in this process (one per ssd_intra_chunk call
# on CUDA tensors); set to 0 to count a window
LAUNCHES = 0


def _check(xb: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
           cum: torch.Tensor, heads: int) -> None:
    """Raise unless the shapes and types are ones the kernel takes."""
    if xb.dim() != 3 or b.dim() != 3 or c.dim() != 3 or cum.dim() != 3:
        raise ValueError("ssd_intra_chunk takes xb (G, L, P), b and c "
                         "(G // heads, L, N), cum (G, 1, L)")
    G, L, P = xb.shape
    N = b.shape[-1]
    if heads < 1 or G % heads or b.shape != (G // heads, L, N) or \
            c.shape != b.shape or cum.shape != (G, 1, L):
        raise ValueError(
            f"ssd_intra_chunk shapes do not fit: xb {tuple(xb.shape)}, b "
            f"{tuple(b.shape)}, c {tuple(c.shape)}, cum {tuple(cum.shape)}, "
            f"heads {heads}")
    if not (1 <= L <= MAX_L and 4 <= P <= MAX_P and P % 4 == 0
            and 4 <= N <= MAX_N and N % 4 == 0):
        raise ValueError(
            f"ssd_intra_chunk takes L <= {MAX_L}, P <= {MAX_P} and N <= "
            f"{MAX_N}, P and N multiples of 4; got L={L}, P={P}, N={N}")
    if xb.dtype != torch.float32 or cum.dtype != torch.float32:
        raise TypeError("ssd_intra_chunk takes xb and cum in float32")
    if b.dtype not in (torch.float32, torch.bfloat16) or c.dtype != b.dtype:
        raise TypeError("ssd_intra_chunk takes b and c both float32 or both "
                        "bfloat16")


def ssd_intra_chunk_plain(xb: torch.Tensor, b: torch.Tensor,
                          c: torch.Tensor, cum: torch.Tensor, heads: int = 1
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel C.

    xb: (G, L, P) dt-scaled inputs; b, c: (G // heads, L, N); cum: (G, 1, L)
    cumulative log-decay.  -> (y (G, L, P), S (G, N, P), a (G, 1)), f32."""
    G, L, P = xb.shape
    N = b.shape[-1]
    gb = G // heads
    x = xb.to(torch.float32).reshape(gb, heads, L, P)
    bf = b.to(torch.float32)
    cf = c.to(torch.float32)
    cm = cum.to(torch.float32).reshape(gb, heads, L)
    cb = cf @ bf.transpose(1, 2)                               # (gb, L, L)
    tril = torch.ones((L, L), dtype=torch.bool, device=xb.device).tril()
    diff = torch.where(tril, cm[..., :, None] - cm[..., None, :],
                       torch.full((), float("-inf"), device=xb.device))
    y = (cb[:, None] * torch.exp(diff)) @ x                    # (gb, H, L, P)
    d2e = torch.exp(cm[..., -1:] - cm)                         # (gb, H, L)
    s = (bf[:, None] * d2e[..., None]).transpose(-1, -2) @ x   # (gb, H, N, P)
    a = torch.exp(cm[..., -1])
    return y.reshape(G, L, P), s.reshape(G, N, P), a.reshape(G, 1)


def _ssd_intra_chunk_cuda(xb, b, c, cum, heads):
    from repro_torch.kernels.build import check, library
    global LAUNCHES
    G, L, P = xb.shape
    N = b.shape[-1]
    y = torch.empty((G, L, P), dtype=torch.float32, device=xb.device)
    s = torch.empty((G, N, P), dtype=torch.float32, device=xb.device)
    a = torch.empty((G, 1), dtype=torch.float32, device=xb.device)
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    err = library().ssd_scan_launch(
        xb.data_ptr(), b.data_ptr(), c.data_ptr(), cum.data_ptr(),
        int(b.dtype == torch.bfloat16), G, heads, L, P, N, y.data_ptr(),
        s.data_ptr(), a.data_ptr(), stream)
    check(err, "ssd_scan kernel")
    LAUNCHES += 1
    return y, s, a


def _intra_chunk(xb, b, c, cum, heads):
    """Kernel C on CUDA tensors, the plain version on CPU tensors (and on
    meta tensors, the dry run's shapes, ``launch/dryrun.py``)."""
    if xb.device.type == "cuda":
        return _ssd_intra_chunk_cuda(xb.contiguous(), b.contiguous(),
                                     c.contiguous(), cum.contiguous(), heads)
    if xb.device.type in ("cpu", "meta"):
        return ssd_intra_chunk_plain(xb, b, c, cum, heads)
    raise ValueError(f"ssd_intra_chunk runs on cuda or cpu, not {xb.device}")


class SSDIntraChunk(torch.autograd.Function):
    """Kernel C with a gradient.

    Forward: :func:`_intra_chunk` (the kernel on the card).  Backward: the
    vector-Jacobian product of :func:`ssd_intra_chunk_plain`, recomputed
    from the saved inputs; the JAX package has no backward kernel either
    (it trains by differentiating its plain ``ssd_chunked``).  Under
    ``torch.func.vmap`` the mapped axis is folded into the cell axis G:
    cells are independent, so one launch serves every mapped copy."""

    @staticmethod
    def forward(xb, b, c, cum, heads):
        return _intra_chunk(xb, b, c, cum, heads)

    @staticmethod
    def setup_context(ctx, inputs, output):
        xb, b, c, cum, heads = inputs
        ctx.save_for_backward(xb, b, c, cum)
        ctx.heads = heads

    @staticmethod
    def backward(ctx, gy, gs, ga):
        # torch.func.vjp, not torch.autograd.grad: the backward then also
        # runs inside torch.func transforms (the federated round's
        # vmap over groups of grad)
        _, vjp = torch.func.vjp(
            lambda *ins: ssd_intra_chunk_plain(*ins, ctx.heads),
            *ctx.saved_tensors)
        grads = vjp((gy, gs, ga))
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad)) + (None,)

    @staticmethod
    def vmap(info, in_dims, xb, b, c, cum, heads):
        n = info.batch_size

        def fold(t, d):
            t = t.expand((n,) + t.shape) if d is None else t.movedim(d, 0)
            return t.reshape((-1,) + t.shape[2:])

        out = SSDIntraChunk.apply(*(fold(t, d) for t, d in
                                    zip((xb, b, c, cum), in_dims)), heads)
        return (tuple(o.reshape((n, -1) + o.shape[1:]) for o in out),
                (0, 0, 0))


def ssd_intra_chunk(xb: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    cum: torch.Tensor, heads: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched intra-chunk SSD (shapes as in :func:`ssd_intra_chunk_plain`).
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors;
    differentiable (:class:`SSDIntraChunk`) and ``torch.func.vmap``-able
    on both."""
    _check(xb, b, c, cum, heads)
    devices = {t.device for t in (xb, b, c, cum)}
    if len(devices) != 1:
        raise ValueError(f"ssd_intra_chunk inputs on several devices: "
                         f"{devices}")
    return SSDIntraChunk.apply(xb, b, c, cum, heads)


def ssd_chunked_kernel(xh: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                       dt: torch.Tensor, la: torch.Tensor, chunk: int,
                       init_state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD with the intra-chunk step on kernel C.

    xh (B, S, H, P), b and c (B, S, N), dt and la (B, S, H); ``init_state``
    (B, H, P, N) seeds the inter-chunk recurrence.  Returns y (B, S, H, P)
    in ``xh``'s dtype and the final state (B, H, P, N) in f32: the values
    of ``models.ssm.ssd_chunked``."""
    B, S, H, P = xh.shape
    N = b.shape[-1]
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"seq {S} not divisible by chunk {L}")
    nc = S // L

    xb = (xh.to(torch.float32) * dt[..., None]).reshape(B, nc, L, H, P)
    cum = torch.cumsum(la.to(torch.float32).reshape(B, nc, L, H), dim=2)
    # cells (B, nc, H); b and c once per (B, nc), no copy per head
    xg = xb.permute(0, 1, 3, 2, 4).reshape(B * nc * H, L, P)
    cumg = cum.permute(0, 1, 3, 2).reshape(B * nc * H, 1, L)
    y_i, s_c, a_c = ssd_intra_chunk(xg, b.reshape(B * nc, L, N),
                                    c.reshape(B * nc, L, N), cumg, heads=H)
    s_c = s_c.reshape(B, nc, H, N, P)
    a_c = a_c.reshape(B, nc, H)

    # inter-chunk recurrence (sequential over chunks, tiny)
    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=xh.device)
         if init_state is None
         else init_state.to(torch.float32).transpose(-1, -2))
    hprevs = []
    for i in range(nc):
        hprevs.append(h)
        h = a_c[:, i, :, None, None] * h + s_c[:, i]
    hprevs = torch.stack(hprevs, dim=1)                        # (B,nc,H,N,P)

    cc = c.reshape(B, nc, L, N).to(torch.float32)
    y_inter = torch.einsum("bcln,bchnp,bclh->bclhp", cc, hprevs,
                           torch.exp(cum))
    y = y_i.reshape(B, nc, H, L, P).permute(0, 1, 3, 2, 4) + y_inter
    return y.reshape(B, S, H, P).to(xh.dtype), h.transpose(-1, -2)
