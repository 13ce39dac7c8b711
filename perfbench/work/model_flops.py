"""Model FLOPs of one trained token (forward and backward, no recompute).

Six times the parameters that enter a matrix product (the layers' and the
tied head's; the embedding lookup, norms, convs and per-head scalars are
not products), plus the products that have no parameter:

* attention: QKᵀ and PV, the causal half counted once: ``2 S H hd`` a
  token forward, ``6 S H hd`` trained, each layer;
* the SSD (Mamba2), per chunk of L positions: C Bᵀ and the masked
  product with X on their causal half, ``L^2 N + L^2 H P``; the chunk
  states and the output from the carried state, ``2 L N H P`` each; per
  token forward ``L N + L H P + 4 N H P``, three times that trained.

Two operations a multiply-add.  ``cfg`` is a configuration file's
``model`` dict.
"""
from __future__ import annotations

from typing import Dict


def matmul_params(cfg: Dict) -> int:
    d, nl, v = cfg["d_model"], cfg["n_layers"], cfg["vocab"]
    head = v * d
    if cfg.get("ssm_state", 0) and not cfg.get("attn_every", 0):
        di = cfg["ssm_expand"] * d
        n = cfg["ssm_state"]
        h = di // cfg["ssm_head_dim"]
        return nl * (d * (2 * di + 2 * n + h) + di * d) + head
    hd = d // cfg["n_heads"]
    q, kv = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
    ffn = (3 if cfg.get("gated_mlp", True) else 2) * d * cfg["d_ff"]
    return nl * (2 * d * q + 2 * d * kv + ffn) + head


def nonparam_flops_per_token(cfg: Dict, seq: int) -> int:
    """Forward FLOPs a token of the products with no parameter."""
    d, nl = cfg["d_model"], cfg["n_layers"]
    if cfg.get("ssm_state", 0) and not cfg.get("attn_every", 0):
        di = cfg["ssm_expand"] * d
        n, p = cfg["ssm_state"], cfg["ssm_head_dim"]
        h = di // p
        L = min(cfg["ssm_chunk"], seq)
        return nl * (L * n + L * h * p + 4 * n * h * p)
    hd = d // cfg["n_heads"]
    return nl * 2 * seq * cfg["n_heads"] * hd


def train_flops_per_token(cfg: Dict, seq: int) -> int:
    return 6 * matmul_params(cfg) + 3 * nonparam_flops_per_token(cfg, seq)
