"""Architecture assembly, in PyTorch: the dense, MoE, SSM-only and hybrid
(Jamba) decoders.

The JAX package's ``models/transformer.py`` with its public entry points
and layouts, so ``utils.tree.from_numpy`` carries the JAX weights across
unchanged.  Parameters are the same nested dict:

* a uniform stack (dense, MoE, SSM-only) has every per-layer leaf stacked
  on a leading ``(n_layers, ...)`` axis;
* the hybrid stacks *groups* of ``attn_every`` layers (``attn_every - 1``
  Mamba layers, then one attention layer; the FFN of position ``p`` is
  MoE when ``p % moe_every == moe_every - 1``, else dense): ``ssm`` is
  ``(n_groups, attn_every - 1, ...)``, ``norm1``/``norm2`` ``(n_groups,
  attn_every, d)``, ``ffn`` ``(n_groups, n_dense, ...)``, ``moe``
  ``(n_groups, n_moe, ...)``, and position ``p`` takes ``ffn[p //
  moe_every]`` or ``moe[p // moe_every]``.

The layers run in a Python loop over the leading axis (the JAX package's
``lax.scan``).  Decode caches are stacked the same way: attention
``{"k", "v"}`` of ``(L, B, S, G, hd)``, SSM ``{"state", "conv"}`` of
``(L, B, ...)``, the hybrid ``{"attn": (n_groups, B, S, G, hd), "ssm":
(n_groups, attn_every - 1, B, ...)}``.

  init_model(cfg, generator, device)      -> params
  forward(params, batch, cfg)             -> (logits, aux)
  prefill(params, batch, cfg)             -> (last-position logits, cache)
  extend_cache(cache, target_len)         -> cache with room to decode
  init_decode_state(cfg, batch, cache_len, dtype, device) -> cache
  decode_step(params, tokens, pos, cfg, cache) -> (logits, new cache)

``decode_step`` takes ``pos`` as an int or as a ``(B,)`` tensor of
per-row positions.  The encoder-decoder and VLM branches raise
``NotImplementedError`` until their slice.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (dense_init, embed_init, embed_lookup,
                                       lm_head, mlp, mlp_init, rmsnorm,
                                       rmsnorm_init)
from repro_torch.utils.tree import resolve_device, tree_map, tree_stack

Tree = Dict[str, Any]

# where the other branches arrive
_LATER = ("ROADMAP.md Queue A item 2 (the encoder-decoder and VLM "
          "branches)")


def require_ported(cfg) -> None:
    """Raise unless ``cfg`` is a decoder-only family the port runs."""
    if cfg.is_encoder_decoder or cfg.n_patches:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) is not ported yet: the port runs "
            f"the decoder-only families (dense, MoE, SSM, hybrid); the "
            f"others arrive with {_LATER}")


def _layer(tree: Tree, i: int) -> Tree:
    return tree_map(lambda a: a[i], tree)


def _n_blocks(cfg) -> int:
    """Entries of the leading axis: groups for the hybrid, else layers."""
    return cfg.n_layers // cfg.attn_every if cfg.is_hybrid else cfg.n_layers


def _is_moe_position(cfg, p: int) -> bool:
    return p % cfg.moe_every == cfg.moe_every - 1


# ======================================================================
# init
# ======================================================================
def _init_uniform_layers(g: torch.Generator, cfg, dtype) -> Tree:
    lead = (cfg.n_layers,)
    p: Tree = {"norm1": rmsnorm_init(cfg.d_model, dtype, g.device, lead)}
    if cfg.is_ssm_only:
        p["ssm"] = ssm_mod.ssm_init(g, cfg, dtype, lead)
        return p
    p["attn"] = attn.attn_init(g, cfg, dtype, lead=lead)
    if cfg.is_moe:
        p["moe"] = moe_mod.moe_init(g, cfg, dtype, lead)
    elif cfg.d_ff > 0:
        p["ffn"] = mlp_init(g, cfg.d_model, cfg.d_ff, dtype,
                            gated=cfg.gated_mlp, lead=lead)
    else:
        return p
    p["norm2"] = rmsnorm_init(cfg.d_model, dtype, g.device, lead)
    return p


def _init_hybrid_groups(g: torch.Generator, cfg, dtype) -> Tree:
    """Every Jamba group at once: (attn_every - 1) Mamba + 1 attention;
    the FFN dense or MoE by position."""
    ae, ng = cfg.attn_every, _n_blocks(cfg)
    n_moe = ae // cfg.moe_every
    n_dense = ae - n_moe
    p: Tree = {
        "ssm": ssm_mod.ssm_init(g, cfg, dtype, (ng, ae - 1)),
        "attn": attn.attn_init(g, cfg, dtype, lead=(ng,)),
        "norm1": rmsnorm_init(cfg.d_model, dtype, g.device, (ng, ae)),
        "norm2": rmsnorm_init(cfg.d_model, dtype, g.device, (ng, ae)),
    }
    if n_dense:
        p["ffn"] = mlp_init(g, cfg.d_model, cfg.d_ff, dtype,
                            gated=cfg.gated_mlp, lead=(ng, n_dense))
    if n_moe:
        p["moe"] = moe_mod.moe_init(g, cfg, dtype, (ng, n_moe))
    return p


def init_model(cfg, generator: torch.Generator, device=None,
               dtype=torch.float32) -> Tree:
    """Random weights with the JAX ``init_model``'s distributions and
    layouts, drawn from ``generator`` on its own device (each stacked leaf
    in one draw), returned on ``device`` (the card unless ``device`` names
    another)."""
    device = resolve_device(device)
    require_ported(cfg)
    params: Tree = {
        "embed": embed_init(generator, cfg.vocab, cfg.d_model, dtype),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, generator.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab,
                                       dtype)
    params["layers"] = (_init_hybrid_groups if cfg.is_hybrid else
                        _init_uniform_layers)(generator, cfg, dtype)
    return tree_map(lambda a: a.to(device), params)


# ======================================================================
# forward (prefill)
# ======================================================================
def _uniform_block(x, lp, cfg, positions, window, collect_cache=False):
    aux = torch.zeros((), device=x.device)
    kv = None
    h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
    if cfg.is_ssm_only:
        if collect_cache:
            o, kv = ssm_mod.ssm_forward(lp["ssm"], h, cfg, return_state=True)
        else:
            o = ssm_mod.ssm_forward(lp["ssm"], h, cfg)
        return x + o, aux, kv
    if collect_cache:
        o, kv = attn.attn_forward(lp["attn"], h, positions, cfg, causal=True,
                                  window=window, return_kv=True)
    else:
        o = attn.attn_forward(lp["attn"], h, positions, cfg, causal=True,
                              window=window)
    x = x + o
    if cfg.is_moe:
        y, aux = moe_mod.moe_apply(
            lp["moe"], rmsnorm(lp["norm2"], x, cfg.norm_eps), cfg)
        x = x + y
    elif cfg.d_ff > 0:
        x = x + mlp(lp["ffn"], rmsnorm(lp["norm2"], x, cfg.norm_eps))
    return x, aux, kv


def _ffn(x, gp, cfg, p: int):
    """Position ``p``'s FFN of a hybrid group on the residual ``x``: (new
    x, load-balance loss)."""
    hf = rmsnorm(_layer(gp["norm2"], p), x, cfg.norm_eps)
    if _is_moe_position(cfg, p):
        y, lb = moe_mod.moe_apply(_layer(gp["moe"], p // cfg.moe_every), hf,
                                  cfg)
        return x + y, lb
    return (x + mlp(_layer(gp["ffn"], p // cfg.moe_every), hf),
            torch.zeros((), device=x.device))


def _hybrid_group_block(x, gp, cfg, positions, window, collect_cache=False):
    ae = cfg.attn_every
    aux = torch.zeros((), device=x.device)
    attn_kv, ssm_states = None, []
    for p in range(ae):
        h = rmsnorm(_layer(gp["norm1"], p), x, cfg.norm_eps)
        if p == ae - 1:
            if collect_cache:
                o, attn_kv = attn.attn_forward(gp["attn"], h, positions, cfg,
                                               causal=True, window=window,
                                               return_kv=True)
            else:
                o = attn.attn_forward(gp["attn"], h, positions, cfg,
                                      causal=True, window=window)
        elif collect_cache:
            o, st = ssm_mod.ssm_forward(_layer(gp["ssm"], p), h, cfg,
                                        return_state=True)
            ssm_states.append(st)
        else:
            o = ssm_mod.ssm_forward(_layer(gp["ssm"], p), h, cfg)
        x, lb = _ffn(x + o, gp, cfg, p)
        aux = aux + lb
    kv = None
    if collect_cache:
        kv = {"attn": attn_kv, "ssm": tree_stack(ssm_states)}
    return x, aux, kv


def _run_stack(params, x, cfg, positions, window=0, collect_cache=False):
    block = _hybrid_group_block if cfg.is_hybrid else _uniform_block
    aux = torch.zeros((), device=x.device)
    caches = []
    for i in range(_n_blocks(cfg)):
        x, lb, kv = block(x, _layer(params["layers"], i), cfg, positions,
                          window, collect_cache)
        aux = aux + lb
        caches.append(kv)
    return x, aux, (tree_stack(caches) if collect_cache else None)


def _head(params, x, cfg):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_head(x, params["embed"] if cfg.tie_embeddings else None,
                   params.get("lm_head"))


def _embed(params, tokens):
    x = embed_lookup(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device).expand(
        x.shape[:2])
    return x, positions


def forward(params, batch: Dict[str, torch.Tensor], cfg, window: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: {tokens (B, S)} -> (logits (B, S, vocab) f32, aux)."""
    require_ported(cfg)
    x, positions = _embed(params, batch["tokens"])
    x, aux, _ = _run_stack(params, x, cfg, positions, window)
    return _head(params, x, cfg), aux


def prefill(params, batch: Dict[str, torch.Tensor], cfg, window: int = 0
            ) -> Tuple[torch.Tensor, Tree]:
    """Serve-side prefill: process the full prompt, return (last-position
    logits (B, 1, vocab), layer-stacked KV/SSM cache) ready for
    ``decode_step``."""
    require_ported(cfg)
    x, positions = _embed(params, batch["tokens"])
    x, _, cache = _run_stack(params, x, cfg, positions, window,
                             collect_cache=True)
    return _head(params, x[:, -1:, :], cfg), cache


def extend_cache(cache: Tree, target_len: int) -> Tree:
    """Zero-pad the sequence axis (axis 2) of the stacked attention KV
    leaves (5-D leaves named ``k`` and ``v``) out to ``target_len`` slots
    for continued decode; every other leaf is returned as it is."""
    out = {}
    for name, a in cache.items():
        if isinstance(a, dict):
            out[name] = extend_cache(a, target_len)
        elif name in ("k", "v") and a.dim() == 5 and a.shape[2] < target_len:
            out[name] = F.pad(a, (0, 0, 0, 0, 0, target_len - a.shape[2]))
        else:
            out[name] = a
    return out


# ======================================================================
# decode (one token with caches)
# ======================================================================
def _stack_tree(tree: Tree, n: int) -> Tree:
    return tree_map(lambda a: a[None].repeat((n,) + (1,) * a.dim()), tree)


def init_decode_state(cfg, batch: int, cache_len: int,
                      dtype=torch.bfloat16, device=None,
                      rolling: bool = False, quantized: bool = False) -> Tree:
    """Stacked (over layers / groups) zero cache.  ``rolling`` needs no
    other layout: the same buffer serves as the circular window."""
    del rolling
    require_ported(cfg)
    device = resolve_device(device)
    if cfg.is_ssm_only:
        return _stack_tree(ssm_mod.init_ssm_cache(cfg, batch, dtype, device),
                           cfg.n_layers)
    kv = attn.init_cache(cfg, batch, cache_len, dtype, quantized=quantized,
                         device=device)
    if cfg.is_hybrid:
        g = {"attn": kv,
             "ssm": _stack_tree(ssm_mod.init_ssm_cache(cfg, batch, dtype,
                                                       device),
                                cfg.attn_every - 1)}
        return _stack_tree(g, _n_blocks(cfg))
    return _stack_tree(kv, cfg.n_layers)


def cache_batch_axis(name: str, axis: int = 1) -> int:
    """The batch axis of the stacked cache leaves under key ``name``: 1
    for the (layers, B, ...) leaves, 2 under a hybrid's ``ssm`` key, whose
    leaves are (groups, attn_every - 1, B, ...)."""
    return 2 if name == "ssm" else axis


def batched_cache_zeros(one: Tree, slots: int, axis: int = 1) -> Tree:
    """Zeros shaped like the one-row cache ``one`` with ``slots`` rows."""
    out = {}
    for k, v in one.items():
        ax = cache_batch_axis(k, axis)
        out[k] = batched_cache_zeros(v, slots, ax) if isinstance(v, dict) \
            else v.new_zeros(v.shape[:ax] + (slots,) + v.shape[ax + 1:])
    return out


def splice_cache_row(cache: Tree, one: Tree, s: int, axis: int = 1) -> None:
    """Write the one-row cache ``one`` into row ``s`` of the batched
    ``cache``, in place."""
    for k, v in one.items():
        ax = cache_batch_axis(k, axis)
        if isinstance(v, dict):
            splice_cache_row(cache[k], v, s, ax)
        else:
            cache[k].select(ax, s).copy_(v.select(ax, 0))


def decode_step(params, tokens: torch.Tensor, pos, cfg, cache: Tree, *,
                rolling: bool = False) -> Tuple[torch.Tensor, Tree]:
    """tokens: (B, 1) int; ``pos`` the absolute position, an int or a
    (B,) tensor with each row's own (the SSM recurrence does not read
    it).  Returns (logits (B, 1, vocab), a new cache)."""
    require_ported(cfg)
    x = embed_lookup(params["embed"], tokens)
    if not cfg.is_ssm_only:
        pos = attn.row_positions(pos, x.shape[0], x.device)
    new = []
    for i in range(_n_blocks(cfg)):
        lp, lc = _layer(params["layers"], i), _layer(cache, i)
        if cfg.is_hybrid:
            ae = cfg.attn_every
            ssm_new = []
            for p in range(ae):
                h = rmsnorm(_layer(lp["norm1"], p), x, cfg.norm_eps)
                if p == ae - 1:
                    o, ac = attn.attn_decode(lp["attn"], h, pos, cfg,
                                             lc["attn"], rolling=rolling)
                else:
                    o, sc = ssm_mod.ssm_decode(_layer(lp["ssm"], p), h, cfg,
                                               _layer(lc["ssm"], p))
                    ssm_new.append(sc)
                x, _ = _ffn(x + o, lp, cfg, p)
            new.append({"attn": ac, "ssm": tree_stack(ssm_new)})
            continue
        h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
        if cfg.is_ssm_only:
            o, lc2 = ssm_mod.ssm_decode(lp["ssm"], h, cfg, lc)
            x = x + o
        else:
            o, lc2 = attn.attn_decode(lp["attn"], h, pos, cfg, lc,
                                      rolling=rolling)
            x = x + o
            if cfg.is_moe:
                y, _ = moe_mod.moe_apply(
                    lp["moe"], rmsnorm(lp["norm2"], x, cfg.norm_eps), cfg)
                x = x + y
            elif cfg.d_ff > 0:
                x = x + mlp(lp["ffn"], rmsnorm(lp["norm2"], x, cfg.norm_eps))
        new.append(lc2)
    return _head(params, x, cfg), tree_stack(new)
