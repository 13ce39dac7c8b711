"""Architecture assembly, in PyTorch: the dense, MoE, SSM-only and hybrid
(Jamba) decoders, the encoder-decoder (Whisper) and the VLM (InternVL2).

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
  moe_every]`` or ``moe[p // moe_every]``;
* the encoder-decoder has ``enc_layers`` (``n_enc_layers``: ``norm1``,
  ``attn``, ``norm_ffn``, ``ffn``), ``layers`` (``n_layers``: those and
  ``norm_x``, ``xattn``, the cross attention) and ``enc_norm``;
* the VLM adds ``patch_proj`` (d_model, d_model): ``batch["patches"] @
  patch_proj`` goes before the token embeddings, and logits come only at
  the text positions.

The layers run in a Python loop over the leading axis (the JAX package's
``lax.scan``).  Decode caches are stacked the same way: attention
``{"k", "v"}`` of ``(L, B, S, G, hd)`` (the encoder-decoder's also
``{"xk", "xv"}`` of ``(L, B, enc_seq, G, hd)``), SSM ``{"state",
"conv"}`` of ``(L, B, ...)``, the hybrid ``{"attn": (n_groups, B, S, G,
hd), "ssm": (n_groups, attn_every - 1, B, ...)}``.

  init_model(cfg, generator, device)      -> params
  forward(params, batch, cfg, remat=)     -> (logits, aux)
  lm_loss(params, batch, cfg, remat=, loss_chunk=) -> (loss, {"nll", "lb"})
  prefill(params, batch, cfg)             -> (last-position logits, cache)
  encdec_prefill(params, batch, cfg, cache_len) -> the same, enc-dec
  extend_cache(cache, target_len)         -> cache with room to decode
  init_decode_state(cfg, batch, cache_len, dtype, device) -> cache
  decode_step(params, tokens, pos, cfg, cache) -> (logits, new cache)

``decode_step`` takes ``pos`` as an int or as a ``(B,)`` tensor of
per-row positions.

``remat=True`` (the JAX package's per-layer ``jax.checkpoint``) and the
chunked loss recompute through :class:`_Recompute`, which keeps only a
block's inputs and recomputes it in the backward pass; unlike
``torch.utils.checkpoint`` it also runs inside ``torch.func`` transforms
(the federated round's ``vmap`` of ``grad``).

Under active sharding rules the params are the rank's blocks
(``sharding/rules.py::param_blocks``) and each layer computes its share
(Megatron tensor parallelism: ``models/attention.py``, ``models/layers.py``,
the expert-parallel MoE, the head-split Mamba2 mixer of ``models/ssm.py``);
``forward``, ``prefill`` and ``decode_step`` return the whole
vocabulary's logits on every rank, and a decode cache holds the rank's kv
heads where they split (``attention.init_cache``) and the rank's
``ssm_heads`` of the SSM state where they split (``ssm.init_ssm_cache``;
the conv history whole), its batch axis where :func:`cache_batch_axis`
says.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (dense_init, embed_init, embed_lookup,
                                       init_device, lm_head, lm_head_block,
                                       mlp, mlp_init, rmsnorm, rmsnorm_init,
                                       vocab_parallel_nll)
from repro_torch.sharding.rules import active_rules, tp_axis, use_rules
from repro_torch.utils.spans import span
from repro_torch.utils.tree import (leaves, paths, resolve_device,
                                   tree_map, tree_stack, unflatten)

Tree = Dict[str, Any]

def _layer(tree: Tree, i: int) -> Tree:
    return tree_map(lambda a: a[i], tree)


class _Recompute(torch.autograd.Function):
    """``fn(*tensors)``, a tuple of tensors, computed with no graph; only
    the inputs are saved, and the backward recomputes ``fn`` under
    ``torch.func.vjp``.  With ``setup_context`` and a generated ``vmap``
    rule it runs inside ``torch.func.grad`` and ``vmap``, where
    ``torch.utils.checkpoint``'s saved-tensor hooks cannot (the pattern
    of ``kernels/ssd_scan.py::SSDIntraChunk``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *tensors):
        return fn(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        ins = ctx.saved_tensors
        diff = [i for i, t in enumerate(ins)
                if t.is_floating_point() and ctx.needs_input_grad[i + 1]]

        def fn(*d):
            full = list(ins)
            for i, t in zip(diff, d):
                full[i] = t
            return ctx.fn(*full)

        with span("remat.recompute"):
            _, vjp = torch.func.vjp(fn, *(ins[i] for i in diff))
        out = [None] * len(ins)
        # no graph of this backward: ``torch.func.grad`` differentiates
        # with ``create_graph``, which would keep the recomputed
        # activations alive to its end
        for i, g in zip(diff, vjp(tuple(grads), create_graph=False)):
            out[i] = g
        return (None,) + tuple(out)


def _recompute(fn, *args):
    """``fn(*args)`` through :class:`_Recompute`: each of ``args`` a
    tensor, None, or a (nested) dict of tensors; ``fn`` returns a tuple of
    tensors.  The recompute runs under the sharding rules active now, so
    it repeats the forward pass's collectives wherever the backward pass
    runs."""
    rules = active_rules()
    plan, flat = [], []
    for a in args:
        if isinstance(a, dict):
            plan.append(paths(a))
            flat.extend(leaves(a))
        else:
            plan.append(a is not None)
            if a is not None:
                flat.append(a)

    def run(*ts):
        it = iter(ts)
        back = []
        for p in plan:
            if p is False:
                back.append(None)
            elif p is True:
                back.append(next(it))
            else:
                back.append(unflatten(p, [next(it) for _ in p]))
        with use_rules(rules):
            return tuple(fn(*back))

    return _Recompute.apply(run, *flat)


def _n_blocks(cfg) -> int:
    """Entries of the leading axis: groups for the hybrid, else layers."""
    return cfg.n_layers // cfg.attn_every if cfg.is_hybrid else cfg.n_layers


def _is_moe_position(cfg, p: int) -> bool:
    return p % cfg.moe_every == cfg.moe_every - 1


# ======================================================================
# init
# ======================================================================
def _init_uniform_layers(g: torch.Generator, cfg, dtype) -> Tree:
    lead, dev = (cfg.n_layers,), init_device(g)
    p: Tree = {"norm1": rmsnorm_init(cfg.d_model, dtype, dev, lead)}
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
    p["norm2"] = rmsnorm_init(cfg.d_model, dtype, dev, lead)
    return p


def _init_hybrid_groups(g: torch.Generator, cfg, dtype) -> Tree:
    """Every Jamba group at once: (attn_every - 1) Mamba + 1 attention;
    the FFN dense or MoE by position."""
    ae, ng, dev = cfg.attn_every, _n_blocks(cfg), init_device(g)
    n_moe = ae // cfg.moe_every
    n_dense = ae - n_moe
    p: Tree = {
        "ssm": ssm_mod.ssm_init(g, cfg, dtype, (ng, ae - 1)),
        "attn": attn.attn_init(g, cfg, dtype, lead=(ng,)),
        "norm1": rmsnorm_init(cfg.d_model, dtype, dev, (ng, ae)),
        "norm2": rmsnorm_init(cfg.d_model, dtype, dev, (ng, ae)),
    }
    if n_dense:
        p["ffn"] = mlp_init(g, cfg.d_model, cfg.d_ff, dtype,
                            gated=cfg.gated_mlp, lead=(ng, n_dense))
    if n_moe:
        p["moe"] = moe_mod.moe_init(g, cfg, dtype, (ng, n_moe))
    return p


def _init_encdec_layers(g: torch.Generator, cfg, dtype, n: int,
                        decoder: bool) -> Tree:
    """``n`` encoder (or decoder, with the cross attention) layers,
    stacked."""
    lead, dev = (n,), init_device(g)
    p: Tree = {"norm1": rmsnorm_init(cfg.d_model, dtype, dev, lead),
               "attn": attn.attn_init(g, cfg, dtype, lead=lead),
               "norm_ffn": rmsnorm_init(cfg.d_model, dtype, dev, lead),
               "ffn": mlp_init(g, cfg.d_model, cfg.d_ff, dtype,
                               gated=cfg.gated_mlp, lead=lead)}
    if decoder:
        p["norm_x"] = rmsnorm_init(cfg.d_model, dtype, dev, lead)
        p["xattn"] = attn.attn_init(g, cfg, dtype, cross=True, lead=lead)
    return p


def init_model(cfg, generator: torch.Generator, device=None,
               dtype=torch.float32) -> Tree:
    """Random weights with the JAX ``init_model``'s distributions and
    layouts, drawn from ``generator`` on its own device (each stacked leaf
    in one draw), returned on ``device`` (the card unless ``device`` names
    another).  A ``generator`` of None makes the leaves without a draw
    (``launch/specs.py::param_specs``, under a fake-tensor mode)."""
    device, dev = resolve_device(device), init_device(generator)
    params: Tree = {
        "embed": embed_init(generator, cfg.vocab, cfg.d_model, dtype),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab,
                                       dtype)
    if cfg.is_encoder_decoder:
        params["enc_layers"] = _init_encdec_layers(
            generator, cfg, dtype, cfg.n_enc_layers, decoder=False)
        params["layers"] = _init_encdec_layers(generator, cfg, dtype,
                                               cfg.n_layers, decoder=True)
        params["enc_norm"] = rmsnorm_init(cfg.d_model, dtype, dev)
    else:
        params["layers"] = (_init_hybrid_groups if cfg.is_hybrid else
                            _init_uniform_layers)(generator, cfg, dtype)
    if cfg.n_patches:  # VLM: projector from (stubbed) vision embeddings
        params["patch_proj"] = dense_init(generator, cfg.d_model,
                                          cfg.d_model, dtype)
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
        x = x + mlp(lp["ffn"], rmsnorm(lp["norm2"], x, cfg.norm_eps),
                    cfg.d_ff)
    return x, aux, kv


def _ffn(x, gp, cfg, p: int):
    """Position ``p``'s FFN of a hybrid group on the residual ``x``: (new
    x, load-balance loss)."""
    hf = rmsnorm(_layer(gp["norm2"], p), x, cfg.norm_eps)
    if _is_moe_position(cfg, p):
        y, lb = moe_mod.moe_apply(_layer(gp["moe"], p // cfg.moe_every), hf,
                                  cfg)
        return x + y, lb
    return (x + mlp(_layer(gp["ffn"], p // cfg.moe_every), hf, cfg.d_ff),
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


def _run_stack(params, x, cfg, positions, window=0, collect_cache=False,
               remat=False):
    """The layer stack.  ``remat`` recomputes each block in the backward
    pass (the JAX package's per-layer ``jax.checkpoint``), without a
    cache only, as there."""
    block = _hybrid_group_block if cfg.is_hybrid else _uniform_block
    remat = remat and not collect_cache
    aux = torch.zeros((), device=x.device)
    caches = []
    for i in range(_n_blocks(cfg)):
        lp = _layer(params["layers"], i)
        if remat:
            x, lb = _recompute(
                lambda x_, lp_, pos_: block(x_, lp_, cfg, pos_, window)[:2],
                x, lp, positions)
            kv = None
        else:
            x, lb, kv = block(x, lp, cfg, positions, window, collect_cache)
        aux = aux + lb
        caches.append(kv)
    return x, aux, (tree_stack(caches) if collect_cache else None)


def _positions(x):
    return torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])


def _encoder(params, frames, cfg):
    """frames: (B, S_enc, D) stubbed audio embeddings -> the normed
    encoder output (non-causal self attention)."""
    x = frames
    pos = _positions(x)
    for i in range(cfg.n_enc_layers):
        lp = _layer(params["enc_layers"], i)
        h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
        x = x + attn.attn_forward(lp["attn"], h, pos, cfg, causal=False)
        x = x + mlp(lp["ffn"], rmsnorm(lp["norm_ffn"], x, cfg.norm_eps),
                    cfg.d_ff)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _decoder_encdec(params, tokens, enc_out, cfg, collect_cache=False):
    """The decoder over ``tokens`` with cross attention to ``enc_out``;
    with ``collect_cache`` also the stacked {k, v, xk, xv} cache."""
    x = embed_lookup(params["embed"], tokens, cfg.vocab)
    pos = _positions(x)
    caches = []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        o = attn.attn_forward(lp["attn"], rmsnorm(lp["norm1"], x,
                                                  cfg.norm_eps),
                              pos, cfg, causal=True,
                              return_kv=collect_cache)
        if collect_cache:
            o, kv = o
        x = x + o
        o = attn.attn_forward(lp["xattn"], rmsnorm(lp["norm_x"], x,
                                                   cfg.norm_eps),
                              pos, cfg, enc_out=enc_out,
                              return_kv=collect_cache)
        if collect_cache:
            o, xkv = o
            caches.append({"k": kv["k"], "v": kv["v"], "xk": xkv["k"],
                           "xv": xkv["v"]})
        x = x + o
        x = x + mlp(lp["ffn"], rmsnorm(lp["norm_ffn"], x, cfg.norm_eps),
                    cfg.d_ff)
    return x, (tree_stack(caches) if collect_cache else None)


def _head(params, x, cfg):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_head(x, params["embed"] if cfg.tie_embeddings else None,
                   params.get("lm_head"), cfg.vocab)


def _embed(params, batch, cfg):
    """Token embeddings, after the projected patch embeddings for a VLM,
    and their positions."""
    x = embed_lookup(params["embed"], batch["tokens"], cfg.vocab)
    if cfg.n_patches:
        pe = batch["patches"] @ params["patch_proj"]
        x = torch.cat([pe.to(x.dtype), x], dim=1)
    return x, _positions(x)


def _trunk(params, batch, cfg, window=0, remat=False):
    """The stack's last hidden states at the text positions (before the
    final norm), and the load-balance loss.  ``remat`` applies to the
    decoder stack (the encoder-decoder's layers run as they are, as in
    the JAX package)."""
    tokens = batch["tokens"]
    if cfg.is_encoder_decoder:
        enc_out = _encoder(params, batch["frames"], cfg)
        x, _ = _decoder_encdec(params, tokens, enc_out, cfg)
        return x, torch.zeros((), device=x.device)
    x, positions = _embed(params, batch, cfg)
    x, aux, _ = _run_stack(params, x, cfg, positions, window, remat=remat)
    if cfg.n_patches:
        x = x[:, -tokens.shape[1]:, :]
    return x, aux


def forward(params, batch: Dict[str, torch.Tensor], cfg, window: int = 0,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: {tokens (B, S), and patches (B, n_patches, D) for a VLM or
    frames (B, enc_seq, D) for an encoder-decoder} -> (logits (B, S,
    vocab) f32 over the token positions, aux).  ``remat``: recompute each
    layer in the backward pass."""
    x, aux = _trunk(params, batch, cfg, window, remat)
    return _head(params, x, cfg), aux


def prefill(params, batch: Dict[str, torch.Tensor], cfg, window: int = 0
            ) -> Tuple[torch.Tensor, Tree]:
    """Serve-side prefill: process the full prompt (after the patches, for
    a VLM), return (last-position logits (B, 1, vocab), layer-stacked
    KV/SSM cache) ready for ``decode_step``."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError("use encdec_prefill for encoder-decoder")
    x, positions = _embed(params, batch, cfg)
    x, _, cache = _run_stack(params, x, cfg, positions, window,
                             collect_cache=True)
    return _head(params, x[:, -1:, :], cfg), cache


def encdec_prefill(params, batch: Dict[str, torch.Tensor], cfg,
                   cache_len: int) -> Tuple[torch.Tensor, Tree]:
    """Whisper-style prefill: run the encoder, fill the cross KV caches,
    then teacher-force the prompt tokens through the decoder collecting
    the self KV.  ``cache_len`` is unused, as in the JAX package
    (``extend_cache`` makes the room to decode)."""
    del cache_len
    enc_out = _encoder(params, batch["frames"], cfg)
    x, cache = _decoder_encdec(params, batch["tokens"], enc_out, cfg,
                               collect_cache=True)
    return _head(params, x[:, -1:, :], cfg), cache


def _chunk_nll(xc, tc, vc, table, head, vocab=0):
    """The summed next-token NLL of one sequence chunk (its logits are
    recomputed in the backward pass); vocabulary-parallel where the rules
    split ``vocab``."""
    logits, (group, r, _) = lm_head_block(xc, table, head, vocab)
    if group is not None:
        return torch.sum(vocab_parallel_nll(logits, tc, group, r) * vc)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, tc[..., None].long())[..., 0]
    return torch.sum(nll * vc)


def lm_loss(params, batch, cfg, window: int = 0, lb_weight: float = 0.01,
            remat: bool = False, loss_chunk: int = 0
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy plus ``lb_weight`` times MoE's
    load-balance loss.

    ``loss_chunk > 0`` computes it in sequence chunks without holding the
    full (B, S, vocab) f32 logits: each chunk's head and softmax are
    recomputed in the backward pass (:class:`_Recompute`), the chunks
    padded to whole ones and the padding masked out.  ``remat``: recompute
    each layer in the backward pass.  Where the rules split the
    vocabulary the head gives the rank's columns and the loss is
    Megatron's vocabulary-parallel cross entropy."""
    with span("lm.loss"):
        return _lm_loss(params, batch, cfg, window, lb_weight, remat,
                        loss_chunk)


def _lm_loss(params, batch, cfg, window, lb_weight, remat, loss_chunk):
    tokens = batch["tokens"]
    table = params["embed"] if cfg.tie_embeddings else None
    head = params.get("lm_head")
    if loss_chunk <= 0 and tp_axis("vocab", cfg.vocab)[0] is not None:
        x, aux = _trunk(params, batch, cfg, window, remat)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits, (group, r, _) = lm_head_block(x[:, :-1, :], table, head,
                                              cfg.vocab)
        loss = vocab_parallel_nll(logits, tokens[:, 1:], group, r).mean()
        return loss + lb_weight * aux, {"nll": loss, "lb": aux}
    if loss_chunk <= 0:
        logits, aux = forward(params, batch, cfg, window, remat)
        logp = torch.log_softmax(logits[:, :-1, :], dim=-1)
        nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
        loss = nll.mean()
        return loss + lb_weight * aux, {"nll": loss, "lb": aux}

    x, aux = _trunk(params, batch, cfg, window, remat)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    B, S = tokens.shape
    Sm1 = S - 1
    C = min(loss_chunk, Sm1)
    n_chunks = -(-Sm1 // C)
    pad = n_chunks * C - Sm1
    xs = F.pad(x[:, :-1, :], (0, 0, 0, pad)).reshape(B, n_chunks, C, -1)
    tg = F.pad(tokens[:, 1:], (0, pad)).reshape(B, n_chunks, C)
    valid = F.pad(torch.ones((B, Sm1), dtype=torch.float32,
                             device=x.device), (0, pad)).reshape(
                                 B, n_chunks, C)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        total = total + _recompute(
            lambda *a: (_chunk_nll(*a, vocab=cfg.vocab),), xs[:, i],
            tg[:, i], valid[:, i], table, head)[0]
    loss = total / (B * Sm1)
    return loss + lb_weight * aux, {"nll": loss, "lb": aux}


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
    device = resolve_device(device)
    if cfg.is_encoder_decoder:
        return _stack_tree(attn.init_cache(cfg, batch, cache_len, dtype,
                                           cross_len=cfg.enc_seq,
                                           quantized=quantized,
                                           device=device), cfg.n_layers)
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
                rolling: bool = False, seq_shard_kv: bool = False
                ) -> Tuple[torch.Tensor, Tree]:
    """tokens: (B, 1) int; ``pos`` the absolute position, an int or a
    (B,) tensor with each row's own (the SSM recurrence does not read
    it).  Returns (logits (B, 1, vocab), a new cache).

    ``seq_shard_kv`` (the uniform attention stack only, under active
    sharding rules): each layer's attention is
    ``attn.attn_decode_seqshard``, ``cache`` this rank's sequence block
    and ``pos`` one int."""
    x = embed_lookup(params["embed"], tokens, cfg.vocab)
    if seq_shard_kv and (cfg.is_hybrid or cfg.is_encoder_decoder
                         or cfg.is_ssm_only):
        raise ValueError("seq_shard_kv takes the uniform attention stack "
                         "only, as in the JAX package")
    shard_pos = pos
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
        if cfg.is_encoder_decoder:
            o, lc2 = attn.attn_decode(lp["attn"], h, pos, cfg, lc,
                                      rolling=rolling)
            x = x + o
            o, _ = attn.attn_decode(lp["xattn"], rmsnorm(
                lp["norm_x"], x, cfg.norm_eps), pos, cfg, lc, cross=True)
            x = x + o
            x = x + mlp(lp["ffn"], rmsnorm(lp["norm_ffn"], x, cfg.norm_eps),
                    cfg.d_ff)
        elif cfg.is_ssm_only:
            o, lc2 = ssm_mod.ssm_decode(lp["ssm"], h, cfg, lc)
            x = x + o
        else:
            if seq_shard_kv:
                o, lc2 = attn.attn_decode_seqshard(lp["attn"], h, shard_pos,
                                                   cfg, lc)
            else:
                o, lc2 = attn.attn_decode(lp["attn"], h, pos, cfg, lc,
                                          rolling=rolling)
            x = x + o
            if cfg.is_moe:
                y, _ = moe_mod.moe_apply(
                    lp["moe"], rmsnorm(lp["norm2"], x, cfg.norm_eps), cfg)
                x = x + y
            elif cfg.d_ff > 0:
                x = x + mlp(lp["ffn"], rmsnorm(lp["norm2"], x, cfg.norm_eps),
                    cfg.d_ff)
        new.append(lc2)
    return _head(params, x, cfg), tree_stack(new)
