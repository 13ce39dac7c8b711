"""GQA attention, in PyTorch: prefill (plain or flash-chunked), encoder,
cross attention, and one-token decode over a KV cache.  Causal
self-attention without a window on CUDA tensors runs on kernel D
(``kernels/attention.py``), the same function with no S x S matrix.

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

Under active sharding rules (Megatron tensor parallelism) ``wq``/``wo``
are the rank's blocks of the ``heads`` columns/rows and ``wk``/``wv`` of
the ``kv_heads`` columns, as ``Rules.spec`` cuts them; :func:`_tp_plan`
says how a rank computes on them:

* ``"heads"``, where the ``wq`` block is whole heads: the rank attends its
  q heads, the input entering through ``copy_to`` and the ``wo`` product
  summed over the ranks (``psum``).  Its k/v heads are its own where the
  ``wk``/``wv`` block is whole heads; otherwise (a block cutting through
  a head, or a leaf held whole) it gathers ``wk``/``wv`` whole for the
  layer and takes the kv heads its q heads read, through ``copy_to``
  (their gradient is then reduce-scattered);
* ``"replicated"``, where the ``wq`` block cuts through a head: every
  split leaf is gathered whole for the layer and the layer runs whole on
  every rank (a block's gradient is its slice).  The sequence-sharded
  decode takes this form too: its ranks hold the cache's sequence, so
  each needs every head.

The decode cache holds the rank's kv heads where they divide (``init_cache``
under the rules), the whole cache otherwise.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.attention import (NEG_INF, causal_attention,
                                           causal_mask, grouped_out,
                                           grouped_scores, plain_attention)
from repro_torch.models.layers import (dense_init, head_rmsnorm,
                                       init_device, rotary)
from repro_torch.sharding.rules import copy_to, gather, psum, tp_axis

# devices whose causal self-attention runs on kernel D
# (``kernels/attention.py``); its Functions take the plain form on CPU
# tensors, where the tests open the route to hold its other conditions
KERNEL_DEVICES = ("cuda",)

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


def _project_q(p: Params, x, positions, cfg, rope: bool, group=None):
    """x @ wq as (B, S, heads, hd): every head, or the rank's under a
    ``"heads"`` plan (``group``: its axis, through which the replicated
    ``q_norm`` enters)."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, -1, cfg.head_dim)
    if "q_norm" in p:
        q = head_rmsnorm(q, copy_to(p["q_norm"], group), cfg.norm_eps)
    if rope:
        q = rotary(q, positions, cfg.rope_theta)
    return q


def _project_kv(p: Params, x, positions, cfg, rope: bool, group=None,
                wk=None, wv=None):
    """(x @ wk, x @ wv) as (B, S, kv heads, hd), by default from the
    layer's own ``wk``/``wv``."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    k = (x @ (p["wk"] if wk is None else wk)).reshape(B, S, -1, hd)
    v = (x @ (p["wv"] if wv is None else wv)).reshape(B, S, -1, hd)
    if "k_norm" in p:
        k = head_rmsnorm(k, copy_to(p["k_norm"], group), cfg.norm_eps)
    if rope:
        k = rotary(k, positions, cfg.rope_theta)
    return k, v


# ----------------------------------------------------------------------
# tensor parallelism (the module docstring)
# ----------------------------------------------------------------------
class _Plan(NamedTuple):
    mode: str                   # "heads" or "replicated"
    group: Any                  # the model axis: ranks splitting heads
    q_axis: Tuple[Any, int, int]     # (group, index, size) of wq / wo
    kv_axis: Tuple[Any, int, int]    # of wk / wv
    kvs: Optional[Tuple[int, ...]]   # "heads": the kv heads the rank's q
    #                                  heads read, None where its own


def _tp_plan(cfg) -> Optional[_Plan]:
    """How this rank computes an attention layer under the active rules;
    None where no leaf of it is split."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q_axis = tp_axis("heads", H * hd)
    kv_axis = tp_axis("kv_heads", KV * hd)
    n, kn = q_axis[2], kv_axis[2]
    if n == 1 and kn == 1:
        return None
    if n == 1 or H % n or kn not in (1, n):
        return _Plan("replicated", None, q_axis, kv_axis, None)
    Hl, rep = H // n, H // KV
    lo = q_axis[1] * Hl
    kvs = None
    if kn == 1 or KV % n:
        per_q = [(lo + j) // rep for j in range(Hl)]
        heads = sorted(set(per_q))
        # grouped where each kv head serves as many of the rank's q heads
        uniform = all(per_q.count(h) * len(heads) == Hl for h in heads)
        kvs = tuple(heads if uniform else per_q)
    return _Plan("heads", q_axis[0], q_axis, kv_axis, kvs)


def _whole(w: torch.Tensor, axis) -> torch.Tensor:
    """A leaf split along its columns (``axis``) gathered whole."""
    return gather(w, -1, *axis)


def _whole_weights(p: Params, plan: Optional[_Plan]) -> Params:
    """The layer's leaves whole on every rank (``wo`` is split along its
    rows), for the ``"replicated"`` plan."""
    if plan is None:
        return p
    out = dict(p)
    out["wq"] = _whole(p["wq"], plan.q_axis)
    out["wo"] = gather(p["wo"], -2, *plan.q_axis)
    out["wk"] = _whole(p["wk"], plan.kv_axis)
    out["wv"] = _whole(p["wv"], plan.kv_axis)
    return out


def _tp_layer(p: Params, cfg):
    """-> (the layer's leaves as this rank computes on them, its
    ``"heads"`` plan or None, the group its inputs enter through or
    None): under a ``"replicated"`` plan the leaves gathered whole."""
    plan = _tp_plan(cfg)
    if plan is None:
        return p, None, None
    if plan.mode == "replicated":
        return _whole_weights(p, plan), None, None
    return p, plan, plan.group


def _head_cols(w: torch.Tensor, heads: Sequence[int], hd: int
               ) -> torch.Tensor:
    """The columns of ``heads`` (ascending runs joined) of a (..., D,
    heads * hd) weight."""
    runs, start = [], 0
    for i in range(1, len(heads) + 1):
        if i == len(heads) or heads[i] != heads[i - 1] + 1:
            runs.append(w.narrow(-1, heads[start] * hd,
                                 (heads[i - 1] - heads[start] + 1) * hd))
            start = i
    return runs[0] if len(runs) == 1 else torch.cat(runs, dim=-1)


def _select_heads(k: torch.Tensor, heads: Sequence[int]) -> torch.Tensor:
    """(B, S, heads, hd) of ``heads`` from a (B, S, all kv heads, hd)."""
    idx = torch.as_tensor(list(heads), device=k.device)
    return k.index_select(2, idx)


def _heads_kv(p: Params, plan: _Plan, src, positions, cfg, rope: bool,
              all_heads: bool):
    """k/v for the rank's q heads under a ``"heads"`` plan from ``src``
    (already through ``copy_to``).  -> (k, v for the attention, k, v for
    the cache: every kv head where the rank does not own its kv heads,
    else None for the same)."""
    g = plan.group
    if plan.kvs is None:
        k, v = _project_kv(p, src, positions, cfg, rope, g)
        return k, v, None, None
    wk = copy_to(_whole(p["wk"], plan.kv_axis), g)
    wv = copy_to(_whole(p["wv"], plan.kv_axis), g)
    if all_heads:
        k, v = _project_kv(p, src, positions, cfg, rope, g, wk, wv)
        return _select_heads(k, plan.kvs), _select_heads(v, plan.kvs), k, v
    hd = cfg.head_dim
    k, v = _project_kv(p, src, positions, cfg, rope, g,
                       _head_cols(wk, plan.kvs, hd),
                       _head_cols(wv, plan.kvs, hd))
    return k, v, None, None


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
            s = grouped_scores(qc, kc)                    # (B,G,rep,qc,kc)
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
    positions: (B,S).  Causal self-attention without a window on CUDA
    tensors runs on kernel D (``kernels/attention.py``) at any length;
    otherwise the flash form once a side exceeds ``flash_threshold``, the
    plain form below it."""
    B, S, _ = x.shape
    rope = enc_out is None
    p, plan, g = _tp_layer(p, cfg)
    x = copy_to(x, g)
    q = _project_q(p, x, positions, cfg, rope, g)
    if enc_out is None:
        src, kpos = x, positions
    else:
        src = copy_to(enc_out, g)
        kpos = torch.zeros((B, enc_out.shape[1]), dtype=torch.int64,
                           device=x.device)
    if plan is not None:
        k, v, kc, vc = _heads_kv(p, plan, src, kpos, cfg, rope, return_kv)
    else:
        k, v = _project_kv(p, src, kpos, cfg, rope)
        kc = vc = None

    Sk = k.shape[1]
    if causal and enc_out is None and not window and \
            q.device.type in KERNEL_DEVICES:
        # kernel D at every length: the plain and flash forms' function,
        # with no S x S matrix in device memory
        o = causal_attention(q, k, v)
    elif max(S, Sk) > flash_threshold:
        o = _flash_attention(q, k, v, causal=causal and enc_out is None,
                             window=window)
    else:
        mask = None
        if causal and enc_out is None:
            mask = causal_mask(S, Sk, x.device)
            if window:
                i = torch.arange(S, device=x.device)[:, None]
                j = torch.arange(Sk, device=x.device)[None, :]
                mask &= (i - j) < window
        o = plain_attention(q, k, v, mask)
    o = psum(o.reshape(B, S, -1) @ p["wo"], g)
    if return_kv:
        return o, {"k": k if kc is None else kc, "v": v if vc is None else vc}
    return o


# -- decode (one token, KV cache) ---------------------------------------
def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
               cross_len: int = 0, quantized: bool = False, device=None
               ) -> Params:
    """KV cache (B, L, G, hd).  ``quantized=True`` stores int8 levels and
    per-(slot, head) f32 scales.  Under rules that split the kv heads
    (they divide the model axis) G is the rank's share of them."""
    hd = cfg.head_dim
    G = cfg.n_kv_heads // tp_axis("kv_heads", cfg.n_kv_heads)[2]
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
    p, plan, g = _tp_layer(p, cfg)
    x = copy_to(x, g)
    q = _project_q(p, x, positions, cfg, rope=not cross, group=g)
    kvs = plan.kvs if plan else None      # the whole cache: read these

    if cross:  # enc-dec cross attention: cache is pre-filled, never written
        k, v = cache["xk"], cache["xv"]
        mask = None
        new_cache = cache
    else:
        if kvs is not None:               # every kv head, for the cache
            k_new, v_new = _project_kv(
                p, x, positions, cfg, True, g,
                _whole(p["wk"], plan.kv_axis), _whole(p["wv"], plan.kv_axis))
        else:
            k_new, v_new = _project_kv(p, x, positions, cfg, rope=True,
                                       group=g)
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

    if kvs is not None:
        k, v = _select_heads(k, kvs), _select_heads(v, kvs)
    s = grouped_scores(q, k)                              # (B,G,rep,1,L)
    if mask is not None:
        s = torch.where(mask[:, None, None, None, :], s, NEG_INF)
    probs = torch.softmax(s, dim=-1)
    o = grouped_out(probs, v, x.dtype)                    # (B,1,H,hd)
    return psum(o.reshape(B, 1, -1) @ p["wo"], g), new_cache


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
    rank's KV reads by the model degree.  Split leaves of the layer are
    gathered whole for it (every rank attends every head)."""
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
    p = _whole_weights(p, _tp_plan(cfg))
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

    s = grouped_scores(q, kc)                              # (B,G,rep,1,L_loc)
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
