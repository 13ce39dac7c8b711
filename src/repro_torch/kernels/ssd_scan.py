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

Its gradient, the vector-Jacobian product of the step, ships twice too:

* :func:`ssd_intra_chunk_bwd_plain` -- plain PyTorch, the formulas
  written out (no autograd);
* the CUDA kernel ``csrc/ssd_scan_bwd.cu``, on one of two routes picked
  by shape (:func:`bwd_route`).  Route 1 runs every product on the
  tensor cores with split TF32, as the forward: one CTA per (batch,
  chunk, 64-column tile, head group) for ``dX``, the heads' ``dCB`` and
  the column terms of ``dcum``, then one CTA per (batch, chunk, 64-row
  tile, ``dC`` or ``dB``) for ``dC``, ``dB`` and ``dcum``.  Route 2, for
  small chunks, is one launch of one CTA per (batch, chunk) owning all
  its heads, f32 FMAs on shared memory sized to the shape.  Neither uses
  float atomics, so the gradient is the same from run to run.

:func:`ssd_intra_chunk` picks by device: the kernel for CUDA tensors (a
build or launch failure raises), the plain version for CPU tensors (and
meta ones); its gradient (:class:`SSDIntraChunk`) goes through
:class:`SSDIntraChunkBwd`, which picks the same way.

Cells are ordered (batch, chunk, head).  ``b`` and ``c`` are the same for
every head of a (batch, chunk), so they come once per (batch, chunk):
``b[g // heads]`` serves cell ``g``.  With ``heads=1`` the shapes are the
JAX kernel's, ``(G, L, N)``.  :func:`ssd_chunked_kernel` is the
full-sequence SSD around the step, the counterpart of the JAX package's
``ssd_chunked_pallas``.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import fold, raw_stream, ready

MAX_L, MAX_P, MAX_N = 256, 64, 128

# launches of the CUDA kernel in this process (one per ssd_intra_chunk call
# on CUDA tensors); set to 0 to count a window
LAUNCHES = 0
# launches of the backward kernel (one per gradient of an ssd_intra_chunk
# call on CUDA tensors, whatever CUDA launches it makes), and calls of the
# plain backward on CUDA tensors, which nothing in the port makes (it
# stays 0; chip_smoke.py checks)
BWD_LAUNCHES = 0
BWD_PLAIN_ON_CUDA = 0


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


# ----------------------------------------------------------------------
# the backward
# ----------------------------------------------------------------------
def _bwd_plain_f32(xb, b, c, cum, gy, gs, ga, heads):
    """The plain backward with the gradients of b and c in f32."""
    G, L, P = xb.shape
    N = b.shape[-1]
    gb = G // heads
    f32 = torch.float32
    x = xb.to(f32).reshape(gb, heads, L, P)
    bf = b.to(f32)
    cf = c.to(f32)
    cm = cum.to(f32).reshape(gb, heads, L)
    gy = gy.to(f32).reshape(gb, heads, L, P)
    gs = gs.to(f32).reshape(gb, heads, N, P)
    ga = ga.to(f32).reshape(gb, heads)
    cb = cf @ bf.transpose(1, 2)                               # (gb, L, L)
    tril = torch.ones((L, L), dtype=torch.bool, device=xb.device).tril()
    # the mask in the exponent, as in the forward
    m = torch.exp(torch.where(tril, cm[..., :, None] - cm[..., None, :],
                              torch.full((), float("-inf"),
                                         device=xb.device)))
    w = cb[:, None] * m                                        # (gb,H,L,L)
    d = torch.exp(cm[..., -1:] - cm)                           # (gb, H, L)
    bd = bf[:, None] * d[..., None]                            # (gb,H,L,N)
    dx = w.transpose(-1, -2) @ gy + bd @ gs                    # (gb,H,L,P)
    dw = gy @ x.transpose(-1, -2)                              # (gb,H,L,L)
    dcb = (dw * m).sum(1)                                      # (gb, L, L)
    q = dw * w
    xg = x @ gs.transpose(-1, -2)                              # (gb,H,L,N)
    dc = dcb @ bf
    db = dcb.transpose(-1, -2) @ cf + (d[..., None] * xg).sum(1)
    dr = d * (bf[:, None] * xg).sum(-1)                        # (gb, H, L)
    dcum = q.sum(-1) - q.sum(-2) - dr
    last = dr.sum(-1) + ga * torch.exp(cm[..., -1])            # (gb, H)
    dcum = torch.cat([dcum[..., :-1], dcum[..., -1:] + last[..., None]], -1)
    return (dx.reshape(G, L, P), db, dc, dcum.reshape(G, 1, L))


def ssd_intra_chunk_bwd_plain(xb: torch.Tensor, b: torch.Tensor,
                              c: torch.Tensor, cum: torch.Tensor,
                              gy: torch.Tensor, gs: torch.Tensor,
                              ga: torch.Tensor, heads: int = 1
                              ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of kernel C's backward: the vector-Jacobian
    product of :func:`ssd_intra_chunk_plain` at (xb, b, c, cum) for the
    cotangents gy (G, L, P), gs (G, N, P) and ga (G, 1).

    Per cell, with CB = C Bᵀ, M_ij = exp(cum_i - cum_j) on and below the
    diagonal (0 above), W = CB ∘ M, d = exp(cum[L-1] - cum):

        dX   = Wᵀ gy + (B ∘ d) gS
        dW   = gy Xᵀ,  dCB = dW ∘ M,  Q = dW ∘ W
        dC   = dCB B,  dB = dCBᵀ C + d ∘ (X gSᵀ)
        dcum = rowsum(Q) - colsum(Q) - d ∘ r,  r = rowsum(B ∘ (X gSᵀ)),
               plus Σ d ∘ r + ga·exp(cum[L-1]) at position L-1

    dB and dC are summed over the ``heads`` cells that share b and c, and
    come back in b's dtype (as autograd of the forward's widening gives
    them).  -> (dxb (G, L, P), db, dc (G // heads, L, N), dcum (G, 1,
    L))."""
    global BWD_PLAIN_ON_CUDA
    if xb.device.type == "cuda":
        BWD_PLAIN_ON_CUDA += 1
    dx, db, dc, dcum = _bwd_plain_f32(xb, b, c, cum, gy, gs, ga, heads)
    return dx, db.to(b.dtype), dc.to(c.dtype), dcum


# Kernel C's backward takes one of two routes, by shape (bwd_route).
# Route 1, full chunks: split-TF32 tensor-core products; C Bᵀ once per
# pair of 64-row tiles, then one CTA per (batch, chunk, 64-column tile,
# head group), the head groups' sums, and one CTA per 64-row tile for dC,
# dB and dcum.  Route 2, small chunks: one launch, one CTA per (batch,
# chunk) owning all its heads, f32 FMAs on shared memory sized to (L, P,
# N) and a batch of heads.
BWD_TILE = 64         # columns (rows) of a route-1 CTA's tile
BWD_CTAS = 132        # route 1's first pass aims for a CTA on each SM
SMEM_MAX = 232_448    # bytes of shared memory an H100 CTA can have
# route 2 takes a shape whose work for one CTA, heads L (L + N) P, is at
# most this and whose shared memory fits: phase 27's sweep in
# chip_smoke.py put the crossover on the card between ssm_lm's widths at
# L = 16 (24,576; route 2 the faster) and L = 32 (81,920; route 1)
SMALL_MAX_WORK = 1 << 15
# route 2 runs as many heads at once as fit in this much shared memory,
# so that several CTAs share an SM
SMALL_SMEM_TARGET = 48 * 1024


def small_smem_bytes(L: int, P: int, N: int, hb: int = 1) -> int:
    """Route 2's shared memory for one (batch, chunk) running ``hb`` heads
    at once: B, C, C Bᵀ, the heads' dCB and dB term, and each head's X,
    gy, gS, cum, d, d r, W, Q, dW ∘ M and X gSᵀ, each part rounded to 16
    bytes (``SmallLayout`` in ``csrc/ssd_scan_bwd.cu``)."""
    r4 = lambda n: -(-n // 4) * 4
    head = (2 * r4(L * P) + r4(N * P) + 3 * r4(L) + 3 * r4(L * L)
            + r4(L * N))
    return 4 * (3 * r4(L * N) + 2 * r4(L * L) + hb * head)


def small_heads(heads: int, L: int, P: int, N: int) -> int:
    """Route 2's heads at once: as many as fit ``SMALL_SMEM_TARGET`` (at
    least one)."""
    common = small_smem_bytes(L, P, N, 0)
    head = small_smem_bytes(L, P, N, 1) - common
    return max(1, min(heads, (SMALL_SMEM_TARGET - common) // head))


@functools.lru_cache(maxsize=256)
def bwd_route(heads: int, L: int, P: int, N: int) -> int:
    """The backward's route for a shape: 2 (small chunks) where one CTA's
    f32 work, heads L (L + N) P, is at most ``SMALL_MAX_WORK`` and its
    shared memory fits, else 1 (the tensor cores)."""
    small = (heads * L * (L + N) * P <= SMALL_MAX_WORK
             and small_smem_bytes(L, P, N) <= SMEM_MAX)
    return 2 if small else 1


@functools.lru_cache(maxsize=256)
def bwd_plan(G: int, heads: int, L: int) -> Tuple[int, int]:
    """Route 1's head groups: (heads a group, groups).  At least as many
    groups as give its first pass a CTA for each of an H100's 132 SMs,
    where the heads allow, and groups of equal size (a divisor of
    ``heads``): a group's C Bᵀ is formed once, and its dCB and dB term
    are summed in the CTA.  Shape-only."""
    tiles = -(-L // BWD_TILE)
    ctas = (G // heads) * tiles
    want = max(1, min(heads, -(-BWD_CTAS // max(ctas, 1))))
    per = max(d for d in range(1, heads + 1)
              if heads % d == 0 and d * want <= heads)
    return per, heads // per


class BwdLayout(NamedTuple):
    """One backward call's buffers, in floats: where dxb, db, dc and dcum
    start in the output buffer and its size, the workspace's size (0 on
    route 2), and the launcher's arguments after the pointers and the
    stream (``ssd_scan_bwd_run`` in ``csrc/ssd_scan_bwd.cu``)."""
    dx: int
    db: int
    dc: int
    dcum: int
    out_floats: int
    ws_floats: int
    args: Tuple[int, ...]


def _parts(sizes):
    """Offsets of consecutive parts of ``sizes`` floats, each starting
    16-byte aligned, and their total."""
    offs, at = [], 0
    for n in sizes:
        offs.append(at)
        at += -(-n // 4) * 4
    return offs, at


@functools.lru_cache(maxsize=256)
def bwd_layout(G: int, heads: int, L: int, P: int, N: int, bf16: bool,
               route: Optional[int] = None, per: Optional[int] = None
               ) -> BwdLayout:
    """The buffers of a backward call at one shape, on ``route`` (by
    default ``bwd_route``'s) with ``per`` heads a group on route 1 (by
    default ``bwd_plan``'s).  Route 1's workspace: each head group's dCB
    and dB term, rowsum(Q) over each column tile, the column terms of
    dcum, the sums of d r over each column tile, and C Bᵀ of each pair
    of row tiles.  On route 2 ``per`` is the heads run at once (by
    default ``small_heads``'s)."""
    gb = G // heads
    route = route or bwd_route(heads, L, P, N)
    (dx, db, dc, dcum), out = _parts((G * L * P, gb * L * N, gb * L * N,
                                      G * L))
    if route == 2:
        per = per or small_heads(heads, L, P, N)
        ws, offs = 0, (0,) * 6
    else:
        per = per or bwd_plan(G, heads, L)[0]
        groups, tiles = heads // per, -(-L // BWD_TILE)
        Lp, Np = tiles * BWD_TILE, -(-N // BWD_TILE) * BWD_TILE
        offs, ws = _parts((groups * gb * Lp * Lp, groups * gb * Lp * Np,
                           G * tiles * Lp, G * Lp, G * tiles,
                           gb * tiles * tiles * BWD_TILE ** 2))
    return BwdLayout(dx, db, dc, dcum, out, ws,
                     (int(bf16), G, heads, L, P, N, route, per, *offs))


_LOCAL = threading.local()


def _ssd_intra_chunk_bwd_cuda(xb, b, c, cum, gy, gs, ga, heads,
                              route=None, per=None):
    """The backward kernel on contiguous, 16-byte-aligned CUDA tensors (gy,
    gs, ga f32): the gradients of b and c in f32.  One allocation for the
    outputs and, on route 1, one for the workspace; the launcher's 27
    arguments go as one array.  ``route`` and ``per`` force a route and
    route 1's head groups (phase 27's sweep)."""
    global BWD_LAUNCHES
    G, L, P = xb.shape
    N = b.shape[-1]
    lay = bwd_layout(G, heads, L, P, N, b.dtype == torch.bfloat16, route,
                     per)
    dev = xb.device
    out = torch.empty(lay.out_floats, dtype=torch.float32, device=dev)
    ws = torch.empty(lay.ws_floats, dtype=torch.float32, device=dev) \
        if lay.ws_floats else None
    args = getattr(_LOCAL, "args", None)
    if args is None:
        args = _LOCAL.args = (ctypes.c_longlong * 27)()
    o = out.data_ptr()
    args[:] = (xb.data_ptr(), b.data_ptr(), c.data_ptr(), cum.data_ptr(),
               gy.data_ptr(), gs.data_ptr(), ga.data_ptr(), o + 4 * lay.dx,
               o + 4 * lay.db, o + 4 * lay.dc, o + 4 * lay.dcum,
               0 if ws is None else ws.data_ptr(), raw_stream(dev.index),
               *lay.args)
    build.check(build.library().ssd_scan_bwd_run(args),
                "ssd_scan backward kernel")
    BWD_LAUNCHES += 1
    gb = G // heads
    return (out.as_strided((G, L, P), (L * P, P, 1), lay.dx),
            out.as_strided((gb, L, N), (L * N, N, 1), lay.db),
            out.as_strided((gb, L, N), (L * N, N, 1), lay.dc),
            out.as_strided((G, 1, L), (L, L, 1), lay.dcum))


def _intra_chunk_bwd(xb, b, c, cum, gy, gs, ga, heads):
    """Kernel C's backward on CUDA tensors (a build or launch failure
    raises), the plain backward on CPU and meta tensors."""
    if xb.device.type == "cuda":
        f32 = torch.float32
        dx, db, dc, dcum = _ssd_intra_chunk_bwd_cuda(
            ready(xb), ready(b), ready(c), ready(cum), ready(gy, f32),
            ready(gs, f32), ready(ga, f32), heads)
        if b.dtype != f32:
            db, dc = db.to(b.dtype), dc.to(c.dtype)
        return dx, db, dc, dcum
    if xb.device.type in ("cpu", "meta"):
        return ssd_intra_chunk_bwd_plain(xb, b, c, cum, gy, gs, ga, heads)
    raise ValueError(f"ssd_intra_chunk's backward runs on cuda or cpu, not "
                     f"{xb.device}")


class SSDIntraChunkBwd(torch.autograd.Function):
    """Kernel C's backward as a Function of its own: the kernel on the
    card, the plain backward on the CPU (:func:`_intra_chunk_bwd`).  Under
    ``torch.func.vmap`` (the federated round's ``vmap`` of
    ``grad_and_value``, the cohort loss) the mapped axis is folded into
    the cell axis G, as the forward's rule does, so one launch serves
    every mapped copy.  It has no backward of its own: a graph may be
    built through it (``grad_and_value`` differentiates with
    ``create_graph``), but differentiating it raises."""

    @staticmethod
    def forward(xb, b, c, cum, gy, gs, ga, heads):
        return _intra_chunk_bwd(xb, b, c, cum, gy, gs, ga, heads)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("kernel C's backward has no gradient of its own "
                           "(double backward through ssd_intra_chunk)")

    @staticmethod
    def vmap(info, in_dims, xb, b, c, cum, gy, gs, ga, heads):
        n = info.batch_size
        out = SSDIntraChunkBwd.apply(*(fold(n, t, d) for t, d in zip(
            (xb, b, c, cum, gy, gs, ga), in_dims[:7])), heads)
        return (tuple(o.reshape((n, -1) + o.shape[1:]) for o in out),
                (0, 0, 0, 0))


class SSDIntraChunk(torch.autograd.Function):
    """Kernel C with a gradient.

    Forward: :func:`_intra_chunk` (the kernel on the card).  Backward:
    :class:`SSDIntraChunkBwd` from the saved inputs (the backward kernel
    on the card, the plain backward on the CPU); the JAX package has no
    backward kernel (``jax.vjp`` cannot differentiate its Pallas call; it
    trains by differentiating its plain ``ssd_chunked``).  Under
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
        grads = SSDIntraChunkBwd.apply(*ctx.saved_tensors, gy, gs, ga,
                                       ctx.heads)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad)) + (None,)

    @staticmethod
    def vmap(info, in_dims, xb, b, c, cum, heads):
        n = info.batch_size
        out = SSDIntraChunk.apply(*(fold(n, t, d) for t, d in
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
