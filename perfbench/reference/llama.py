"""A Llama-style decoder (the SmolLM family, hf:HuggingFaceTB/SmolLM-135M),
plain PyTorch in f32.

``n_layers`` pre-norm blocks: grouped-query attention with rotary
embeddings over the two halves of each head (theta ``rope_theta``),
causal, softmax in f32, the scores divided by sqrt(head_dim) after the
product; then a SwiGLU MLP.  RMS norms; embeddings tied to the head.  The
parameter layout is the one the port takes (per-layer leaves stacked on a
leading layer axis), so one set of weights serves both.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.reference.layers import (ein, embed_params, mm,
                                        next_token_nll, ones, rmsnorm,
                                        uniform)


def init_params(cfg: Dict, gen: torch.Generator, device=None) -> Dict:
    """Seeded weights on ``gen``'s device, one draw a stacked leaf:
    uniform projections scaled by 1/sqrt(fan in), norms 1."""
    d, nl, f = cfg["d_model"], cfg["n_layers"], cfg["d_ff"]
    hd = d // cfg["n_heads"]
    q, kv = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
    dev = gen.device
    s = 1.0 / math.sqrt(d)
    p = embed_params(gen, cfg["vocab"], d)
    p["layers"] = {
        "norm1": ones((nl, d), dev),
        "attn": {"wq": uniform(gen, (nl, d, q), s),
                 "wk": uniform(gen, (nl, d, kv), s),
                 "wv": uniform(gen, (nl, d, kv), s),
                 "wo": uniform(gen, (nl, q, d), 1.0 / math.sqrt(q))},
        "ffn": {"w_gate": uniform(gen, (nl, d, f), s),
                "w_up": uniform(gen, (nl, d, f), s),
                "w_down": uniform(gen, (nl, f, d), 1.0 / math.sqrt(f))},
        "norm2": ones((nl, d), dev),
    }
    return p


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd), positions 0 .. S-1."""
    S, half = x.shape[1], x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p: Dict, x: torch.Tensor, cfg: Dict) -> torch.Tensor:
    B, S, d = x.shape
    H, G = cfg["n_heads"], cfg["n_kv_heads"]
    hd = d // H
    q = rotary(mm(x, p["wq"]).reshape(B, S, H, hd), cfg["rope_theta"])
    k = rotary(mm(x, p["wk"]).reshape(B, S, G, hd), cfg["rope_theta"])
    v = mm(x, p["wv"]).reshape(B, S, G, hd)
    q = q.reshape(B, S, G, H // G, hd)
    s = ein("bqgrd,bkgd->bgrqk", q, k) / math.sqrt(hd)
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    s = torch.where(causal, s, torch.full((), -1e30, device=x.device))
    o = ein("bgrqk,bkgd->bqgrd", torch.softmax(s, dim=-1), v)
    return mm(o.reshape(B, S, H * hd), p["wo"])


def swiglu(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return mm(F.silu(mm(x, p["w_gate"])) * mm(x, p["w_up"]), p["w_down"])


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def lm_loss(params: Dict, tokens: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """Mean next-token cross entropy over ``tokens`` (B, S)."""
    x = params["embed"][tokens.long()]
    eps = cfg["norm_eps"]
    for i in range(cfg["n_layers"]):
        lp = _layer(params["layers"], i)
        x = x + attention(lp["attn"], rmsnorm(lp["norm1"]["scale"], x, eps),
                          cfg)
        x = x + swiglu(lp["ffn"], rmsnorm(lp["norm2"]["scale"], x, eps))
    return next_token_nll(params, x, tokens, eps)
