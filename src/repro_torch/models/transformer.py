"""Architecture assembly, in PyTorch: the SSM-only (Mamba2) decoder.

The JAX package's ``models/transformer.py`` with its public entry points
and layouts.  Parameters are the same nested dict, with every per-layer
leaf stacked on a leading (n_layers, ...) axis; the layers run in a Python
loop over that axis (the JAX package's ``lax.scan``).  Decode caches are
stacked the same way: ``{"state": (L, B, H, P, N), "conv": (L, B, W-1,
C)}``.

  init_model(cfg, generator, device)      -> params
  forward(params, batch, cfg)             -> (logits, aux)
  prefill(params, batch, cfg)             -> (last-position logits, cache)
  init_decode_state(cfg, batch, cache_len, dtype, device) -> cache
  decode_step(params, tokens, pos, cfg, cache) -> (logits, new cache)

The attention, MoE, hybrid, encoder-decoder and VLM families raise
``NotImplementedError`` until their slice.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (dense_init, embed_init, embed_lookup,
                                       lm_head, rmsnorm, rmsnorm_init)
from repro_torch.utils.tree import resolve_device, tree_map, tree_stack

Tree = Dict[str, Any]

# where the other families arrive
_LATER = ("ROADMAP.md Queue A item 2 (the attention, MoE, hybrid, "
          "encoder-decoder and VLM families)")


def require_ssm(cfg) -> None:
    """Raise unless ``cfg`` is of a family the port runs."""
    if not cfg.is_ssm_only:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) is not ported yet: the port runs the "
            f"SSM-only family; the others arrive with {_LATER}")


def _layer(tree: Tree, i: int) -> Tree:
    return tree_map(lambda a: a[i], tree)


# ======================================================================
# init
# ======================================================================
def init_model(cfg, generator: torch.Generator, device=None,
               dtype=torch.float32) -> Tree:
    """Random weights with the JAX ``init_model``'s distributions, drawn
    from ``generator`` on its own device, returned on ``device`` (the card
    unless ``device`` names another)."""
    device = resolve_device(device)
    require_ssm(cfg)
    params: Tree = {
        "embed": embed_init(generator, cfg.vocab, cfg.d_model, dtype),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, generator.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab,
                                       dtype)
    params["layers"] = tree_stack([
        {"norm1": rmsnorm_init(cfg.d_model, dtype, generator.device),
         "ssm": ssm_mod.ssm_init(generator, cfg, dtype)}
        for _ in range(cfg.n_layers)])
    return tree_map(lambda a: a.to(device), params)


# ======================================================================
# forward (train / prefill)
# ======================================================================
def _uniform_block(x, lp, cfg, collect_cache=False):
    h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
    if collect_cache:
        o, kv = ssm_mod.ssm_forward(lp["ssm"], h, cfg, return_state=True)
        return x + o, kv
    return x + ssm_mod.ssm_forward(lp["ssm"], h, cfg), None


def _run_stack(params, x, cfg, collect_cache=False):
    caches = []
    for i in range(cfg.n_layers):
        x, kv = _uniform_block(x, _layer(params["layers"], i), cfg,
                               collect_cache)
        caches.append(kv)
    return x, (tree_stack(caches) if collect_cache else None)


def _head(params, x, cfg):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_head(x, params["embed"] if cfg.tie_embeddings else None,
                   params.get("lm_head"))


def forward(params, batch: Dict[str, torch.Tensor], cfg
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: {tokens (B, S)} -> (logits (B, S, vocab) f32, aux)."""
    require_ssm(cfg)
    x = embed_lookup(params["embed"], batch["tokens"])
    x, _ = _run_stack(params, x, cfg)
    return _head(params, x, cfg), torch.zeros((), device=x.device)


def prefill(params, batch: Dict[str, torch.Tensor], cfg
            ) -> Tuple[torch.Tensor, Tree]:
    """Serve-side prefill: process the full prompt, return (last-position
    logits (B, 1, vocab), layer-stacked SSM cache) ready for
    ``decode_step``."""
    require_ssm(cfg)
    x = embed_lookup(params["embed"], batch["tokens"])
    x, cache = _run_stack(params, x, cfg, collect_cache=True)
    return _head(params, x[:, -1:, :], cfg), cache


def extend_cache(cache: Tree, target_len: int) -> Tree:
    """Make room for decode up to ``target_len`` positions.  An SSM cache
    has no sequence axis, so it is returned as it is; the attention slice
    pads its KV caches here."""
    del target_len
    return cache


# ======================================================================
# decode (one token with caches)
# ======================================================================
def init_decode_state(cfg, batch: int, cache_len: int,
                      dtype=torch.bfloat16, device=None) -> Tree:
    """Stacked (over layers) zero cache."""
    del cache_len                    # an SSM cache has no sequence axis
    require_ssm(cfg)
    one = ssm_mod.init_ssm_cache(cfg, batch, dtype, resolve_device(device))
    return tree_map(
        lambda a: a[None].repeat((cfg.n_layers,) + (1,) * a.dim()), one)


def decode_step(params, tokens: torch.Tensor, pos, cfg, cache: Tree
                ) -> Tuple[torch.Tensor, Tree]:
    """tokens: (B, 1) int; ``pos`` (the absolute position) is not read by
    the SSM recurrence."""
    del pos
    require_ssm(cfg)
    x = embed_lookup(params["embed"], tokens)
    new = []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
        o, lc = ssm_mod.ssm_decode(lp["ssm"], h, cfg, _layer(cache, i))
        x = x + o
        new.append(lc)
    return _head(params, x, cfg), tree_stack(new)
