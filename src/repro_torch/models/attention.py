"""GQA attention, in PyTorch: prefill (plain or flash-chunked), encoder,
cross attention, and one-token decode over a KV cache.

The JAX package's ``models/attention.py`` written in tensor ops, with its
einsums, masks and order of operations: scores are f32 products divided
by ``sqrt(head_dim)`` after the product, masked scores are ``NEG_INF =
-1e30`` (not ``-inf``), and the flash form keeps the reference's chunk
padding, causal chunk skip and window.  It does not call
``scaled_dot_product_attention``, whose masking and summation order are
other ones.

Decode takes ``pos`` either as an int (every row at one position, the JAX
package's form) or as a ``(B,)`` tensor (each row at its own position,
the form the continuous batcher needs).  The cache slot a row writes is
its position clamped to ``[0, L-1]``, as XLA's ``dynamic_update_slice``
clamps its start; the rotary angle and the mask take the unclamped
position.  Decode returns a new cache and leaves its input as it was.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense_init, head_rmsnorm,
                                       init_device, rotary)

NEG_INF = -1e30

Params = Dict[str, torch.Tensor]


def attn_init(generator: torch.Generator, cfg, dtype=torch.float32,
              cross: bool = False, lead=()) -> Params:
    """One attention layer's weights (``lead`` stacks them on leading
    axes); ``q_norm``/``k_norm`` only for a qk-norm self-attention."""
    hd = cfg.head_dim
    p = {
        "wq": dense_init(generator, cfg.d_model, cfg.n_heads * hd, dtype,
                         lead),
        "wk": dense_init(generator, cfg.d_model, cfg.n_kv_heads * hd, dtype,
                         lead),
        "wv": dense_init(generator, cfg.d_model, cfg.n_kv_heads * hd, dtype,
                         lead),
        "wo": dense_init(generator, cfg.n_heads * hd, cfg.d_model, dtype,
                         lead),
    }
    if cfg.qk_norm and not cross:
        for name in ("q_norm", "k_norm"):
            p[name] = torch.ones(tuple(lead) + (hd,), dtype=dtype,
                                 device=init_device(generator))
    return p


def _project_q(p: Params, x, positions, cfg, rope: bool):
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    if "q_norm" in p:
        q = head_rmsnorm(q, p["q_norm"], cfg.norm_eps)
    if rope:
        q = rotary(q, positions, cfg.rope_theta)
    return q


def _project_kv(p: Params, x, positions, cfg, rope: bool):
    B, S, _ = x.shape
    hd = cfg.head_dim
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if "k_norm" in p:
        k = head_rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if rope:
        k = rotary(k, positions, cfg.rope_theta)
    return k, v


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,H,hd), k: (B,Sk,G,hd) with H = G*rep -> (B,G,rep,Sq,Sk)
    f32 scores, divided by sqrt(hd) after the product."""
    B, Sq, H, hd = q.shape
    G = k.shape[2]
    q = q.reshape(B, Sq, G, H // G, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", q.to(torch.float32),
                     k.to(torch.float32))
    return s / math.sqrt(hd)


def _grouped_out(probs: torch.Tensor, v: torch.Tensor, out_dtype
                 ) -> torch.Tensor:
    """probs: (B,G,rep,Sq,Sk), v: (B,Sk,G,hd) -> (B,Sq,H,hd)."""
    B, G, rep, Sq, _ = probs.shape
    o = torch.einsum("bgrqk,bkgd->bqgrd",
                     probs.to(v.dtype).to(torch.float32),
                     v.to(torch.float32))
    return o.reshape(B, Sq, G * rep, -1).to(out_dtype)


def _plain_attention(q, k, v, mask: Optional[torch.Tensor]) -> torch.Tensor:
    s = _grouped_scores(q, k)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)   # mask broadcasts over (B,G,rep)
    probs = torch.softmax(s, dim=-1)
    return _grouped_out(probs, v, q.dtype)


def _flash_attention(q, k, v, *, causal: bool, window: int = 0,
                     q_chunk: int = 1024, kv_chunk: int = 1024
                     ) -> torch.Tensor:
    """Online-softmax attention over (q_chunk, kv_chunk) score blocks."""
    B, Sq, H, hd = q.shape
    Sk, G = k.shape[1], k.shape[2]
    rep = H // G
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    # pad ragged sequence lengths up to whole chunks
    Sq_pad = -(-Sq // q_chunk) * q_chunk
    Sk_pad = -(-Sk // kv_chunk) * kv_chunk
    if Sq_pad != Sq:
        q = F.pad(q, (0, 0, 0, 0, 0, Sq_pad - Sq))
    if Sk_pad != Sk:
        k = F.pad(k, (0, 0, 0, 0, 0, Sk_pad - Sk))
        v = F.pad(v, (0, 0, 0, 0, 0, Sk_pad - Sk))
    dev = q.device
    outs = []
    for qi in range(Sq_pad // q_chunk):
        qc = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        # kv chunks this q chunk needs (the structural causal skip)
        q_end = (qi + 1) * q_chunk if causal else Sk_pad
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, G, rep, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, G, rep, q_chunk), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((B, G, rep, q_chunk, hd), dtype=torch.float32,
                          device=dev)
        for ki in range(-(-q_end // kv_chunk)):
            # a start past the end is clamped, as XLA's dynamic_slice
            # clamps it; such a chunk's positions are all masked below
            start = min(ki * kv_chunk, Sk_pad - kv_chunk)
            kc = k[:, start:start + kv_chunk]
            vc = v[:, start:start + kv_chunk]
            s = _grouped_scores(qc, kc)                   # (B,G,rep,qc,kc)
            k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            msk = (k_pos < Sk)[None, :].expand(q_chunk, kv_chunk)
            if causal:
                msk = msk & (q_pos[:, None] >= k_pos[None, :])
            if window:
                msk = msk & ((q_pos[:, None] - k_pos[None, :]) < window)
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bgrqk,bkgd->bgrqd",
                              p.to(vc.dtype).to(torch.float32),
                              vc.to(torch.float32))
            acc = acc * corr[..., None] + pv
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]   # (B,G,rep,qc,hd)
        outs.append(o.movedim(3, 1).reshape(B, q_chunk, H, hd).to(q.dtype))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out[:, :Sq] if Sq_pad != Sq else out


# ----------------------------------------------------------------------
def attn_forward(p: Params, x: torch.Tensor, positions: torch.Tensor, cfg,
                 *, causal: bool = True, enc_out=None, window: int = 0,
                 flash_threshold: int = 2048, return_kv: bool = False):
    """Full-sequence attention (prefill / encoder / cross).  x: (B,S,D),
    positions: (B,S); the flash form once a side exceeds
    ``flash_threshold``."""
    B, S, _ = x.shape
    rope = enc_out is None
    q = _project_q(p, x, positions, cfg, rope)
    if enc_out is None:
        k, v = _project_kv(p, x, positions, cfg, rope)
    else:
        Se = enc_out.shape[1]
        k, v = _project_kv(p, enc_out, torch.zeros(
            (B, Se), dtype=torch.int64, device=x.device), cfg, False)

    Sk = k.shape[1]
    if max(S, Sk) > flash_threshold:
        o = _flash_attention(q, k, v, causal=causal and enc_out is None,
                             window=window)
    else:
        mask = None
        if causal and enc_out is None:
            mask = torch.ones((S, Sk), dtype=torch.bool,
                              device=x.device).tril()
            if window:
                i = torch.arange(S, device=x.device)[:, None]
                j = torch.arange(Sk, device=x.device)[None, :]
                mask &= (i - j) < window
        o = _plain_attention(q, k, v, mask)
    o = o.reshape(B, S, -1) @ p["wo"]
    if return_kv:
        return o, {"k": k, "v": v}
    return o


# -- decode (one token, KV cache) ---------------------------------------
def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
               cross_len: int = 0, quantized: bool = False, device=None
               ) -> Params:
    """KV cache (B, L, G, hd).  ``quantized=True`` stores int8 levels and
    per-(slot, head) f32 scales."""
    hd, G = cfg.head_dim, cfg.n_kv_heads
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    if quantized:
        c = {"k": z((batch, cache_len, G, hd), torch.int8),
             "v": z((batch, cache_len, G, hd), torch.int8),
             "k_scale": z((batch, cache_len, G), torch.float32),
             "v_scale": z((batch, cache_len, G), torch.float32)}
    else:
        c = {"k": z((batch, cache_len, G, hd), dtype),
             "v": z((batch, cache_len, G, hd), dtype)}
    if cross_len:
        c["xk"] = z((batch, cross_len, G, hd), dtype)
        c["xv"] = z((batch, cross_len, G, hd), dtype)
    return c


def _quant_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,1,G,hd) -> (int8 levels, (B,1,G) scale)."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-12)
    lv = torch.clamp(torch.round(xf / scale[..., None] * 127), -127, 127)
    return lv.to(torch.int8), scale


def _dequant_kv(lv: torch.Tensor, scale: torch.Tensor, dtype
                ) -> torch.Tensor:
    return (lv.to(torch.float32) * (scale[..., None] / 127.0)).to(dtype)


def row_positions(pos, batch: int, device) -> torch.Tensor:
    """``pos`` as a (batch,) int64 tensor on ``device``: an int (or 0-d
    tensor) is every row's position, a (batch,) tensor each row's own."""
    pos = torch.as_tensor(pos, device=device)
    if pos.dim() == 0:
        pos = pos.expand(batch)
    if tuple(pos.shape) != (batch,):
        raise ValueError(f"pos must be an int or a ({batch},) tensor, got "
                         f"shape {tuple(pos.shape)}")
    return pos.to(torch.int64)


def attn_decode(p: Params, x: torch.Tensor, pos, cfg, cache: Params, *,
                rolling: bool = False, cross: bool = False
                ) -> Tuple[torch.Tensor, Params]:
    """One-token decode. x: (B,1,D); ``pos`` an int or a (B,) tensor of
    absolute positions.

    ``rolling=True`` treats the cache as a circular window buffer (slot =
    pos % L, all slots valid once full)."""
    B = x.shape[0]
    pos = row_positions(pos, B, x.device)
    positions = pos[:, None]
    q = _project_q(p, x, positions, cfg, rope=not cross)

    if cross:  # enc-dec cross attention: cache is pre-filled, never written
        k, v = cache["xk"], cache["xv"]
        mask = None
        new_cache = cache
    else:
        k_new, v_new = _project_kv(p, x, positions, cfg, rope=True)
        L = cache["k"].shape[1]
        slot = pos % L if rolling else pos.clamp(0, L - 1)
        at = (torch.arange(B, device=x.device), slot)
        if "k_scale" in cache:
            k_lv, k_sc = _quant_kv(k_new)
            v_lv, v_sc = _quant_kv(v_new)
            kq = cache["k"].index_put(at, k_lv[:, 0])
            vq = cache["v"].index_put(at, v_lv[:, 0])
            ks = cache["k_scale"].index_put(at, k_sc[:, 0])
            vs = cache["v_scale"].index_put(at, v_sc[:, 0])
            new_cache = dict(cache, k=kq, v=vq, k_scale=ks, v_scale=vs)
            k = _dequant_kv(kq, ks, x.dtype)
            v = _dequant_kv(vq, vs, x.dtype)
        else:
            k = cache["k"].index_put(at, k_new[:, 0].to(cache["k"].dtype))
            v = cache["v"].index_put(at, v_new[:, 0].to(cache["v"].dtype))
            new_cache = dict(cache, k=k, v=v)
        j = torch.arange(L, device=x.device)[None, :]
        if rolling:   # warmup: only the first pos+1 slots are valid
            mask = j < torch.clamp(pos + 1, max=L)[:, None]
        else:
            mask = j <= pos[:, None]                      # (B, L)

    s = _grouped_scores(q, k)                             # (B,G,rep,1,L)
    if mask is not None:
        s = torch.where(mask[:, None, None, None, :], s, NEG_INF)
    probs = torch.softmax(s, dim=-1)
    o = _grouped_out(probs, v, x.dtype)                   # (B,1,H,hd)
    return o.reshape(B, 1, -1) @ p["wo"], new_cache


# -- sequence-sharded decode (beyond-paper: MQA/GQA KV too small to TP) ---
def attn_decode_seqshard(p: Params, x: torch.Tensor, pos, cfg,
                         cache: Params) -> Tuple[torch.Tensor, Params]:
    """One-token decode with the KV cache sharded along the SEQUENCE over
    the active rules' ``model`` axis, merged with a log-sum-exp flash
    merge across the model ranks.

    ``cache`` is this rank's block: (B, L / model, G, hd) of a cache of L
    slots, the rank's slots ``[r * L/model, (r + 1) * L/model)``; ``x``
    holds the rows of this rank's batch block where the rules map
    ``batch`` to mesh axes.  Only the rank that owns slot ``pos`` writes
    the new K/V.  The merge is one all-reduce MAX of the local score
    maxima, then SUMs of the local exponent sums and outputs.  ``pos`` is
    one int for every row, as in the JAX package.  For MQA (granite:
    one KV head) a cache cannot shard over heads, so this cuts each
    rank's KV reads by the model degree."""
    from repro_torch.sharding.rules import (active_rules, axis_group, pmax,
                                            psum)
    rules = active_rules()
    if rules is None or "model" not in rules.mesh.mesh_dim_names:
        raise ValueError("the sequence-sharded decode needs active "
                         "sharding rules with a 'model' axis (use_rules)")
    pos = torch.as_tensor(pos)
    if pos.dim() != 0:
        raise ValueError(f"the sequence-sharded decode takes one position "
                         f"for every row, got shape {tuple(pos.shape)}")
    pos = int(pos)
    group, r, _ = axis_group(rules.mesh, "model")
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q = _project_q(p, x, positions, cfg, rope=True)        # (B,1,H,hd)
    k_new, v_new = _project_kv(p, x, positions, cfg, rope=True)

    kc, vc = cache["k"], cache["v"]
    L_loc = kc.shape[1]
    slot = pos - r * L_loc
    if 0 <= slot < L_loc:       # this rank owns the slot
        kc = kc.clone()
        vc = vc.clone()
        kc[:, slot] = k_new[:, 0].to(kc.dtype)
        vc[:, slot] = v_new[:, 0].to(vc.dtype)

    s = _grouped_scores(q, kc)                             # (B,G,rep,1,L_loc)
    gidx = r * L_loc + torch.arange(L_loc, device=x.device)
    s = torch.where(gidx <= pos, s, NEG_INF)
    m = pmax(s.amax(dim=-1), group)                        # (B,G,rep,1)
    e = torch.exp(s - m[..., None])
    l_sum = psum(e.sum(dim=-1), group)
    o = psum(torch.einsum("bgrqk,bkgd->bgrqd",
                          e.to(vc.dtype).to(torch.float32),
                          vc.to(torch.float32)), group)
    o = o / torch.clamp(l_sum, min=1e-30)[..., None]
    Bq, G, rep, _, hd = o.shape
    o = o.movedim(3, 1).reshape(Bq, 1, G * rep, hd).to(q.dtype)
    return o.reshape(B, 1, -1) @ p["wo"], dict(cache, k=kc, v=vc)
