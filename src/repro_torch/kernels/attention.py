"""Kernel D: causal self-attention, forward and backward, and the plain
form of attention that ``models/attention.py`` builds on.

The plain form (:func:`plain_attention`): q (B, S, H, hd), k and v (B, Sk,
G, hd) with H a multiple of G (q head h reads kv head h // (H / G)); f32
scores of the widened inputs divided by sqrt(hd) after the product
(:func:`grouped_scores`); masked scores ``NEG_INF``; the softmax; its
product with v (:func:`grouped_out`).  Kernel D computes it under the
causal mask (:func:`causal_mask`).  Two versions:

* :func:`causal_attention_plain` -- the plain form itself under the
  causal mask, on any device;
* the CUDA kernel ``csrc/attention.cu``: flash attention's online softmax
  over tiles in registers, split-TF32 ``mma.sync`` products, the tiles
  above the diagonal skipped; its backward recomputes the probabilities
  from the saved log-sum-exp of each row, so nothing of size S^2 is
  written (that source's header has the design and the bound).

It replaces no Pallas kernel: the JAX package leaves attention to XLA,
which fuses it.  It exists because the port's eager plain form writes the
S x S f32 scores of every head and passes over them several times more.

:class:`CausalAttention` (forward) and :class:`CausalAttentionBwd` (its
gradient) pick by device: the kernel for CUDA tensors (a build or launch
failure raises), the plain form for CPU and meta tensors.  Each has a
``vmap`` rule that folds the mapped axis into the batch axis, so one
launch serves every group of the federated round's ``vmap``.  The kernel
takes head dims of 16, 32, 48, 64 and 128 (every attention config, smoke
config and LM task of the port) in f32 or bf16; any other raises.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import fold, raw_stream, ready

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 48, 64, 128)

# calls of the forward and of the backward on CUDA tensors in this process
# (the backward makes two CUDA launches a call); set to 0 to count a window
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless the shapes and types are ones the kernel takes."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError("causal attention takes q (B, S, H, hd), k and v "
                         "(B, S, G, hd)")
    B, S, H, hd = q.shape
    G = k.shape[2]
    if k.shape != (B, S, G, hd) or H % G:
        raise ValueError(f"causal attention shapes do not fit: q "
                         f"{tuple(q.shape)}, k and v {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"causal attention's kernel takes head dims "
                         f"{HEAD_DIMS}, not {hd}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("causal attention takes q, k and v all float32 or "
                        "all bfloat16")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("causal attention inputs on several devices")


def grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,H,hd), k: (B,Sk,G,hd) with H = G*rep -> (B,G,rep,Sq,Sk)
    f32 scores, divided by sqrt(hd) after the product."""
    B, Sq, H, hd = q.shape
    G = k.shape[2]
    q = q.reshape(B, Sq, G, H // G, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", q.to(torch.float32),
                     k.to(torch.float32))
    return s / math.sqrt(hd)


def grouped_out(probs: torch.Tensor, v: torch.Tensor, out_dtype
                ) -> torch.Tensor:
    """probs: (B,G,rep,Sq,Sk), v: (B,Sk,G,hd) -> (B,Sq,H,hd)."""
    B, G, rep, Sq, _ = probs.shape
    o = torch.einsum("bgrqk,bkgd->bqgrd",
                     probs.to(v.dtype).to(torch.float32),
                     v.to(torch.float32))
    return o.reshape(B, Sq, G * rep, -1).to(out_dtype)


def plain_attention(q, k, v, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain form; ``mask`` (Sq, Sk) broadcasts over (B, G, rep)."""
    s = grouped_scores(q, k)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    probs = torch.softmax(s, dim=-1)
    return grouped_out(probs, v, q.dtype)


def causal_mask(S: int, Sk: int, device) -> torch.Tensor:
    """(S, Sk) bool, true where a query may read a key: key <= query."""
    return torch.ones((S, Sk), dtype=torch.bool, device=device).tril()


def causal_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """The plain form under the causal mask, op for op."""
    S = q.shape[1]
    return plain_attention(q, k, v, causal_mask(S, S, q.device))


def _plain_lse(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The log-sum-exp of each row of the masked scores, (B, H, S) f32."""
    B, S, H, _ = q.shape
    s = torch.where(causal_mask(S, S, q.device), grouped_scores(q, k),
                    NEG_INF)
    return torch.logsumexp(s, dim=-1).reshape(B, H, S)


_LOCAL = threading.local()


def _args(n: int):
    """This thread's int64 argument array of ``n`` values."""
    a = getattr(_LOCAL, f"a{n}", None)
    if a is None:
        a = (ctypes.c_longlong * n)()
        setattr(_LOCAL, f"a{n}", a)
    return a


def _params(q: torch.Tensor, k: torch.Tensor) -> Tuple[int, ...]:
    """B, S, H, G, hd, bf16 and the bits of the f32 scale: 1/sqrt(hd) as
    the card's plain form takes it (the f32 reciprocal of the f32 root)."""
    B, S, H, hd = q.shape
    scale = np.float32(1.0) / np.float32(math.sqrt(hd))
    bits = int(np.array(scale, np.float32).view(np.uint32))
    return (B, S, H, k.shape[2], hd, int(q.dtype == torch.bfloat16), bits)


def _fwd_cuda(q, k, v):
    """The forward kernel on contiguous, 16-byte-aligned CUDA tensors ->
    (o, lse (B, H, S)), both f32."""
    global FWD_LAUNCHES
    B, S, H, hd = q.shape
    o = torch.empty((B, S, H, hd), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    a = _args(13)
    a[:] = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), raw_stream(q.device.index), *_params(q, k))
    build.check(build.library().attn_fwd_run(a), "attention kernel")
    FWD_LAUNCHES += 1
    return o, lse


def _bwd_cuda(q, k, v, o, lse, do):
    """The backward kernels on contiguous, 16-byte-aligned CUDA tensors (o,
    lse and do f32) -> (dq, dk, dv) in f32."""
    global BWD_LAUNCHES
    dev = q.device
    dq = torch.empty(q.shape, dtype=torch.float32, device=dev)
    dk = torch.empty(k.shape, dtype=torch.float32, device=dev)
    dv = torch.empty(k.shape, dtype=torch.float32, device=dev)
    dsum = torch.empty(lse.shape, dtype=torch.float32, device=dev)
    a = _args(18)
    a[:] = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dsum.data_ptr(), raw_stream(dev.index),
            *_params(q, k))
    build.check(build.library().attn_bwd_run(a), "attention backward kernel")
    BWD_LAUNCHES += 1
    return dq, dk, dv


def _forward(q, k, v):
    """(o, lse), both f32: the kernel on CUDA tensors, the plain form on CPU
    and meta tensors (its output widened, exactly)."""
    if q.device.type == "cuda":
        return _fwd_cuda(ready(q), ready(k), ready(v))
    if q.device.type in ("cpu", "meta"):
        o = causal_attention_plain(q, k, v)
        return o.to(torch.float32), _plain_lse(q, k)
    raise ValueError(f"causal attention runs on cuda or cpu, not {q.device}")


def _backward(q, k, v, o, lse, do):
    """(dq, dk, dv) in the inputs' dtype for the f32 cotangent ``do`` of the
    f32 output ``o``: the kernels on CUDA tensors, the plain form's
    vector-Jacobian product (autograd's own backward of it, op for op) on
    CPU and meta tensors."""
    if q.device.type == "cuda":
        grads = _bwd_cuda(ready(q), ready(k), ready(v), ready(o),
                          ready(lse), ready(do, torch.float32))
        return tuple(g.to(q.dtype) for g in grads)
    if q.device.type in ("cpu", "meta"):
        _, vjp = torch.func.vjp(causal_attention_plain, q, k, v)
        return vjp(do.to(q.dtype))
    raise ValueError(f"causal attention's backward runs on cuda or cpu, not "
                     f"{q.device}")


def _unfold(n, out):
    return tuple(t.reshape((n, -1) + t.shape[1:]) for t in out)


class CausalAttentionBwd(torch.autograd.Function):
    """The backward as a Function of its own: the kernels on the card, the
    plain form's vector-Jacobian product on the CPU (:func:`_backward`).
    Under ``torch.func.vmap`` the mapped axis is folded into the batch
    axis, so one launch serves every mapped copy.  It has no backward of
    its own: a graph may be built through it (``grad_and_value``
    differentiates with ``create_graph``), but differentiating it
    raises."""

    @staticmethod
    def forward(q, k, v, o, lse, do):
        return _backward(q, k, v, o, lse, do)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("causal attention's backward has no gradient of "
                           "its own (double backward through the attention "
                           "kernel)")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, do):
        n = info.batch_size
        out = CausalAttentionBwd.apply(*(fold(n, t, d) for t, d in zip(
            (q, k, v, o, lse, do), in_dims)))
        return _unfold(n, out), (0, 0, 0)


class CausalAttention(torch.autograd.Function):
    """Causal self-attention with a gradient: -> (o (B, S, H, hd) f32, lse
    (B, H, S) f32, not differentiable).  It saves q, k, v, o and lse,
    nothing of size S^2 (o in f32 also where q is bf16, so that the
    backward's rowsum(dO o O) is not rounded); its backward is
    :class:`CausalAttentionBwd`.  Under ``torch.func.vmap`` the mapped
    axis is folded into the batch axis (one launch for every mapped
    copy), inside ``torch.func.grad`` and a recompute's ``vjp`` alike."""

    @staticmethod
    def forward(q, k, v):
        return _forward(q, k, v)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v = inputs
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse)

    @staticmethod
    def backward(ctx, do, dlse):
        return CausalAttentionBwd.apply(*ctx.saved_tensors, do)

    @staticmethod
    def vmap(info, in_dims, q, k, v):
        n = info.batch_size
        out = CausalAttention.apply(*(fold(n, t, d) for t, d in
                                      zip((q, k, v), in_dims)))
        return _unfold(n, out), (0, 0)


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Causal self-attention (shapes as in the module docstring), -> o
    (B, S, H, hd) in q's dtype.  The CUDA kernel for CUDA tensors, the
    plain form for CPU tensors; differentiable (:class:`CausalAttention`)
    and ``torch.func.vmap``-able on both."""
    _check(q, k, v)
    return CausalAttention.apply(q, k, v)[0].to(q.dtype)
