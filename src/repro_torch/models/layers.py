"""Primitive layers: norms, embeddings and the LM head, in PyTorch.

The JAX package's ``models/layers.py`` with its layouts: dense weights are
``(d_in, d_out)`` and applied as ``x @ w``, embedding tables ``(vocab, d)``,
a norm is ``{"scale": (d,)}``.  Initializers draw from a ``torch.Generator``
with the JAX package's distributions (not its draws: a test that needs the
JAX package's own weights carries them over with
``repro_torch.utils.tree.from_numpy``).  Each takes ``lead``, a tuple of
leading axes, and draws the layer-stacked leaf ``lead + shape`` in one
call, so a stack of layers is never held twice while it is built.

Under active sharding rules a split parameter is the rank's block
(``sharding/rules.py::param_blocks``) and these layers are Megatron's: the
MLP column-parallel in ``w_gate``/``w_up`` and row-parallel in
``w_down``, the embedding and the head vocabulary-parallel.  Each takes
the whole width of its split dim (``ffn``, ``vocab``) to tell a block from
a leaf held whole; with no rules it computes as the JAX package does.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding.rules import copy_to, gather, pmax, psum, tp_axis


def init_device(generator: Optional[torch.Generator]):
    """The device an initializer makes its leaves on: ``generator``'s, or
    the default one for None."""
    return None if generator is None else generator.device


def uniform_init(generator: Optional[torch.Generator], shape, scale: float,
                 dtype=torch.float32) -> torch.Tensor:
    """Uniform on [-scale, scale), drawn on ``generator``'s device.  With
    no generator the leaf is only made (``torch.empty``, no draw): the
    shape-only trees of ``launch/specs.py``, under a fake-tensor mode."""
    u = torch.empty(shape, dtype=dtype, device=init_device(generator))
    if generator is None:
        return u
    return u.uniform_(-scale, scale, generator=generator)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, lead=()) -> torch.Tensor:
    return uniform_init(generator, tuple(lead) + (d_in, d_out),
                        1.0 / math.sqrt(d_in), dtype)


# -- norms --------------------------------------------------------------
def rmsnorm_init(d: int, dtype=torch.float32, device=None, lead=()
                 ) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype,
                                device=device)}


def rmsnorm(params: Dict[str, torch.Tensor], x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMS norm over the last axis, in f32, back in ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


def head_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """qk-norm: RMS over head_dim (last axis) with learned scale
    (head_dim,)."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(
        x.dtype)


# -- rotary -------------------------------------------------------------
def rotary(x: torch.Tensor, positions: torch.Tensor,
           theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over the two halves of the head (not interleaved
    pairs).  x: (..., S, H, hd), positions: (..., S) integers."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]     # (..., S, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- MLP: SwiGLU (gated, default) or GELU (non-gated, e.g. granite) -------
def mlp_init(generator: torch.Generator, d: int, f: int,
             dtype=torch.float32, gated: bool = True, lead=()
             ) -> Dict[str, torch.Tensor]:
    p = {}
    if gated:
        p["w_gate"] = dense_init(generator, d, f, dtype, lead)
    p["w_up"] = dense_init(generator, d, f, dtype, lead)
    p["w_down"] = dense_init(generator, f, d, dtype, lead)
    return p


def mlp(params: Dict[str, torch.Tensor], x: torch.Tensor, ffn: int = 0
        ) -> torch.Tensor:
    """SwiGLU with ``w_gate``, else GELU in ``jax.nn.gelu``'s default
    form, the tanh approximation.  ``ffn``: the whole hidden width; where
    the rules split it, the params are the rank's blocks and the partial
    outputs are summed over the ranks."""
    group = tp_axis("ffn", ffn)[0] if ffn else None
    x = copy_to(x, group)
    if "w_gate" in params:
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    return psum(h @ params["w_down"], group)


# -- embeddings ----------------------------------------------------------
def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    return uniform_init(generator, (vocab, d), 1.0 / math.sqrt(d), dtype)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, vocab: int = 0
                 ) -> torch.Tensor:
    """Rows of ``table`` for ``ids``.  ``vocab``: the whole vocabulary;
    where the rules split it, ``table`` is the rank's rows, ids outside
    them look up zeros and the ranks' rows are summed."""
    group, r, _ = tp_axis("vocab", vocab) if vocab else (None, 0, 1)
    if group is None:
        return table[ids]
    n = table.shape[0]
    local = ids - r * n
    mine = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)] * mine[..., None].to(table.dtype)
    return psum(rows, group)


def lm_head_block(x: torch.Tensor, table: Optional[torch.Tensor],
                  head: Optional[torch.Tensor], vocab: int = 0):
    """-> (f32 logits of the rank's vocabulary columns, (group, index,
    size) of the split; (None, 0, 1) where the vocabulary is whole)."""
    axis = tp_axis("vocab", vocab) if vocab else (None, 0, 1)
    x = copy_to(x, axis[0])
    logits = x @ head if head is not None else x @ table.T
    return logits.to(torch.float32), axis


def lm_head(x: torch.Tensor, table: Optional[torch.Tensor],
            head: Optional[torch.Tensor], vocab: int = 0) -> torch.Tensor:
    """Project to vocab logits (tied table or separate head). f32 logits,
    the whole vocabulary's (gathered where the rules split it)."""
    logits, (group, r, n) = lm_head_block(x, table, head, vocab)
    return gather(logits, -1, group, r, n)


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor,
                       group, index: int) -> torch.Tensor:
    """Megatron's vocabulary-parallel cross entropy: ``logits`` (..., V/n)
    f32, the rank's columns; ``targets`` (...) whole ids -> (...) the
    next-token NLL, the same on every rank.  The maximum (detached), the
    sum of exponentials and the target's logit are reduced over
    ``group``."""
    n = logits.shape[-1]
    m = pmax(logits.detach().amax(dim=-1), group)
    sumexp = psum(torch.exp(logits - m[..., None]).sum(dim=-1), group)
    local = targets.long() - index * n
    mine = (local >= 0) & (local < n)
    t = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    t = psum(torch.where(mine, t, torch.zeros_like(t)), group)
    return torch.log(sumexp) + m - t
