"""Mamba2 language model (arXiv:2405.21060), plain PyTorch in f32.

A stack of ``n_layers`` residual blocks ``x + mixer(rmsnorm(x))``; the
mixer is the SSD (state-space duality) block: ``in_proj`` to z, x, B, C
and dt; a causal depthwise conv of width ``ssm_conv_width`` and SiLU over
x, B and C; dt = softplus(dt + dt_bias); the chunked SSD (a masked
quadratic form inside each chunk of ``ssm_chunk`` positions, a recurrence
of the (H, P, N) state across chunks) plus D x; a gated RMS norm of y *
SiLU(z); ``out_proj``.  Embeddings are tied to the head.  One group of B
and C is shared by every head (``ngroups`` = 1).

The parameter layout is the one the port takes (a dict with every
per-layer leaf stacked on a leading layer axis), so one set of weights
serves both.  :func:`ssd_chunked` follows the port's plain oracle
``models/ssm.py::ssd_chunked``, written out again here.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.layers import (ein, embed_params, mm,
                                        next_token_nll, ones, rmsnorm,
                                        uniform)


def sizes(cfg: Dict) -> Tuple[int, int, int, int, int]:
    """(d_inner, state N, heads H, head dim P, conv width)."""
    di = cfg["ssm_expand"] * cfg["d_model"]
    return (di, cfg["ssm_state"], di // cfg["ssm_head_dim"],
            cfg["ssm_head_dim"], cfg["ssm_conv_width"])


def init_params(cfg: Dict, gen: torch.Generator, device=None) -> Dict:
    """Seeded weights on ``gen``'s device, one draw a stacked leaf:
    uniform projections scaled by 1/sqrt(fan in), the conv within 0.5,
    A = -[1 .. 16] over the heads, D = 1, dt_bias = 0, norms 1."""
    d, nl = cfg["d_model"], cfg["n_layers"]
    di, n, h, _, w = sizes(cfg)
    dev = gen.device
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                     device=dev))
    p = embed_params(gen, cfg["vocab"], d)
    p["layers"] = {
        "norm1": ones((nl, d), dev),
        "ssm": {
            "in_proj": uniform(gen, (nl, d, 2 * di + 2 * n + h),
                               1.0 / math.sqrt(d)),
            "conv_w": uniform(gen, (nl, w, di + 2 * n), 0.5),
            "a_log": a_log.expand(nl, h).clone(),
            "ssm_d": torch.ones((nl, h), dtype=torch.float32, device=dev),
            "dt_bias": torch.zeros((nl, h), dtype=torch.float32, device=dev),
            "out_proj": uniform(gen, (nl, di, d), 1.0 / math.sqrt(di)),
            "gate_norm": ones((nl, di), dev),
        },
    }
    return p


def _causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u (B, S, C), w (W, C): per-channel causal conv, tap W-1 on the
    current position."""
    W = w.shape[0]
    out = u * w[W - 1]
    for i in range(1, W):
        out = out + F.pad(u[:, :-i, :], (0, 0, i, 0)) * w[W - 1 - i]
    return out


def ssd_chunked(xh: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                dt: torch.Tensor, la: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xh (B, S, H, P), b and c (B, S, N), dt and la (B, S, H) -> y (B, S,
    H, P), final state (B, H, P, N)."""
    B, S, H, P = xh.shape
    N = b.shape[-1]
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"seq {S} not divisible by chunk {L}")
    nc = S // L
    xb = (xh * dt[..., None]).reshape(B, nc, L, H, P)
    bc = b.reshape(B, nc, L, N)
    cc = c.reshape(B, nc, L, N)
    cum = torch.cumsum(la.reshape(B, nc, L, H), dim=2)
    cb = ein("bcln,bcmn->bclm", cc, bc)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,L,L,H)
    mask = torch.ones((L, L), dtype=torch.bool, device=xh.device).tril()
    # mask the exponent: above the diagonal the log decay is positive
    diff = torch.where(mask[None, None, :, :, None], diff,
                       torch.full((), float("-inf"), device=xh.device))
    m = torch.exp(diff)
    y_intra = ein("bclmh,bcmhp->bclhp", cb[..., None] * m, xb)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    s_c = ein("bcln,bclhp->bchpn", bc, decay_to_end[..., None] * xb)
    a_chunk = torch.exp(cum[:, :, -1, :])
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
         if init_state is None else init_state)
    hprevs = []
    for i in range(nc):
        hprevs.append(h)
        h = a_chunk[:, i, :, None, None] * h + s_c[:, i]
    hprevs = torch.stack(hprevs, dim=1)                      # (B,nc,H,P,N)
    y_inter = ein("bcln,bchpn->bclhp", cc, hprevs) \
        * torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(B, S, H, P), h


def mixer(p: Dict, x: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """One Mamba2 mixer, x (B, S, d) -> (B, S, d)."""
    di, n, h, hp, _ = sizes(cfg)
    proj = mm(x, p["in_proj"])
    z = proj[..., :di]
    xbc = F.silu(_causal_conv(proj[..., di:2 * di + 2 * n], p["conv_w"]))
    dt = F.softplus(proj[..., 2 * di + 2 * n:] + p["dt_bias"])
    B_, S_ = x.shape[0], x.shape[1]
    xh = xbc[..., :di].reshape(B_, S_, h, hp)
    b, c = xbc[..., di:di + n], xbc[..., di + n:]
    la = -torch.exp(p["a_log"]) * dt
    y, _ = ssd_chunked(xh, b, c, dt, la, cfg["ssm_chunk"])
    y = y + p["ssm_d"][:, None] * (xh * dt[..., None])
    y = y.reshape(B_, S_, di) * F.silu(z)
    y = rmsnorm(p["gate_norm"]["scale"], y, cfg["norm_eps"])
    return mm(y, p["out_proj"])


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def lm_loss(params: Dict, tokens: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """Mean next-token cross entropy over ``tokens`` (B, S)."""
    x = params["embed"][tokens.long()]
    eps = cfg["norm_eps"]
    for i in range(cfg["n_layers"]):
        lp = _layer(params["layers"], i)
        x = x + mixer(lp["ssm"], rmsnorm(lp["norm1"]["scale"], x, eps), cfg)
    return next_token_nll(params, x, tokens, eps)
