"""Layers shared by the reference models, in plain PyTorch and f32.

Every product of two tensors goes through :func:`mm` or :func:`ein`, so a
control can compute them one precision lower: with ``PRECISION["mode"]``
set to ``"tf32"`` both operands of each product are rounded to TF32 (10
bits of mantissa, to nearest even) and the product accumulates in f32, as
the card's TF32 tensor cores do.  The default is plain f32 (the card's
TF32 switches off, ``perfbench.harness`` sets them).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

PRECISION = {"mode": "f32"}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32's 10-bit mantissa, to nearest even (finite
    values)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


class _LowEinsum(torch.autograd.Function):
    """A two-operand einsum whose operands are rounded to TF32 in the
    forward and in both products of the backward (every index of an
    operand is in the output or in the other operand)."""

    @staticmethod
    def forward(ctx, eq, a, b):
        ctx.eq = eq
        ctx.save_for_backward(a, b)
        return torch.einsum(eq, tf32_round(a), tf32_round(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ins, out = ctx.eq.split("->")
        ia, ib = ins.split(",")
        g = tf32_round(g)
        ga = torch.einsum(f"{out},{ib}->{ia}", g, tf32_round(b))
        gb = torch.einsum(f"{ia},{out}->{ib}", tf32_round(a), g)
        return None, ga, gb


def ein(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if PRECISION["mode"] == "tf32":
        return _LowEinsum.apply(eq, a, b)
    return torch.einsum(eq, a, b)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, S, k) @ (k, n)."""
    if PRECISION["mode"] == "tf32":
        return _LowEinsum.apply("bsk,kn->bsn", a, b)
    return a @ b


def uniform(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    """Uniform on [-scale, scale), one draw on ``gen``'s device."""
    return torch.empty(shape, dtype=torch.float32,
                       device=gen.device).uniform_(-scale, scale,
                                                   generator=gen)


def ones(shape, device) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(shape, dtype=torch.float32, device=device)}


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float
            ) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) \
        * scale


def embed_params(gen: torch.Generator, vocab: int, d: int):
    return {"embed": uniform(gen, (vocab, d), 1.0 / math.sqrt(d)),
            "final_norm": ones((d,), gen.device)}


def next_token_nll(params, x: torch.Tensor, tokens: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Mean next-token NLL of the final hidden states ``x`` (B, S, d)
    through the final norm and the tied head."""
    x = rmsnorm(params["final_norm"]["scale"], x, eps)
    logits = mm(x[:, :-1], params["embed"].T)
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0].mean()
