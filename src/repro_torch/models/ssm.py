"""Mamba2 (SSD -- state-space duality) block, in PyTorch.

Chunked SSD: within a chunk the recurrence is unrolled into a masked
quadratic (attention-like) form; across chunks a short loop carries the
(H, P, N) state.  :func:`ssm_forward` runs the intra-chunk part through
``kernels.ops.ssd``, i.e. on kernel C (``kernels/csrc/ssd_scan.cu``) for
CUDA tensors; :func:`ssd_chunked` is the plain full-sequence oracle the
tests hold it to.

Decode is the O(1) recurrence: h = a*h + dt*B⊗x ; y = C·h + D*x.

Parameters and caches keep the JAX package's ``models/ssm.py`` layouts:
``in_proj`` (d, 2*d_inner + 2*N + H) split as z, x, B, C, dt; ``conv_w``
(W, d_inner + 2*N); the state (B, H, P, N).

Under active rules that split ``ssm_heads`` over mesh axes of m ranks
(``sharding/rules.py::tp_axis``; the JAX package constrains the SSD's
input to ``("batch", "seq", "ssm_heads", None)`` and GSPMD splits it) rank
r runs heads ``[r*H/m, (r+1)*H/m)``: it reads its slices of the whole
leaves (:func:`_rank_params`), computes B and C whole (every head shares
them), runs the SSD on its H/m heads (kernel C on the card), reduces the
gated norm's statistic over the ranks and sums its partial output
(``psum``).  Its decode state is its block (B, H/m, P, N); the conv
history stays whole, as the rules hold it.  Where the heads do not divide
the axis, or no rules are active, the mixer runs whole.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import (init_device, rmsnorm, rmsnorm_init,
                                       uniform_init)
from repro_torch.sharding.rules import copy_to, psum, tp_axis

Params = Dict[str, torch.Tensor]


def ssm_init(generator: torch.Generator, cfg, dtype=torch.float32,
             lead=()) -> Params:
    """One Mamba2 mixer's parameters, with the JAX ``ssm_init``'s
    distributions, drawn on ``generator``'s device; ``lead`` stacks them
    on leading axes (the layer-stacked layout)."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    w = cfg.ssm_conv_width
    dev = init_device(generator)
    lead = tuple(lead)
    d_in_proj = 2 * di + 2 * n + h          # z, x, B, C, dt
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                     device=dev))
    return {
        "in_proj": uniform_init(generator, lead + (d, d_in_proj),
                                1.0 / math.sqrt(d), dtype),
        "conv_w": uniform_init(generator, lead + (w, di + 2 * n), 0.5,
                               dtype),
        "a_log": a_log.expand(lead + (h,)).clone(),
        "ssm_d": torch.ones(lead + (h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(lead + (h,), dtype=torch.float32,
                               device=dev),
        "out_proj": uniform_init(generator, lead + (di, d),
                                 1.0 / math.sqrt(di), dtype),
        "gate_norm": rmsnorm_init(di, dtype, dev, lead),
    }


def _split_proj(proj: torch.Tensor, di: int, n: int):
    """z, xbc, dt of a projection laid out as z (di), x (di), B, C (n
    each), dt."""
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * n]
    dt = proj[..., di + di + 2 * n:]
    return z, xbc, dt


def _causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u: (B,S,C), w: (W,C) -- per-channel causal conv via shifted adds."""
    W = w.shape[0]
    out = u * w[W - 1]
    for i in range(1, W):
        shifted = F.pad(u[:, :-i, :], (0, 0, i, 0))
        out = out + shifted * w[W - 1 - i]
    return out


def _ssd_inputs(params: Params, proj: torch.Tensor, di: int, n: int,
                h: int, p: int, conv_fn=_causal_conv):
    """The SSD's inputs from a projection of ``di`` channels, ``h`` heads
    of ``p`` (the whole mixer's, or a rank's share: :func:`_rank_params`)."""
    z, xbc, dt = _split_proj(proj, di, n)
    xbc = F.silu(conv_fn(xbc, params["conv_w"]))
    x = xbc[..., :di]
    b = xbc[..., di:di + n]
    c = xbc[..., di + n:]
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])          # (B,S,H)
    B_, S_ = x.shape[0], x.shape[1]
    xh = x.reshape(B_, S_, h, p)
    la = -torch.exp(params["a_log"]) * dt                               # (B,S,H) log decay
    return z, xh, b, c, dt, la


def ssd_chunked(xh: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                dt: torch.Tensor, la: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD, plain PyTorch (the oracle). xh (B,S,H,P), b/c (B,S,N),
    dt/la (B,S,H).  Returns y (B,S,H,P) and final state (B,H,P,N)."""
    B, S, H, P = xh.shape
    N = b.shape[-1]
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"seq {S} not divisible by chunk {L}")
    nc = S // L

    xb = (xh * dt[..., None]).reshape(B, nc, L, H, P).to(torch.float32)
    bc_ = b.reshape(B, nc, L, N).to(torch.float32)
    cc_ = c.reshape(B, nc, L, N).to(torch.float32)
    cum = torch.cumsum(la.reshape(B, nc, L, H), dim=2)     # (B,nc,L,H)

    # intra-chunk (quadratic within chunk).  Mask the EXPONENT, not the
    # exponential: upper-triangular entries have positive log-decay and
    # exp() overflows to inf.
    cb = torch.einsum("bcln,bcmn->bclm", cc_, bc_)         # (B,nc,L,L)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,L,L,H)
    mask = torch.ones((L, L), dtype=torch.bool, device=xh.device).tril()
    diff = torch.where(mask[None, None, :, :, None], diff,
                       torch.full((), float("-inf"), device=xh.device))
    m = torch.exp(diff)
    y_intra = torch.einsum("bclm,bclmh,bcmhp->bclhp", cb, m, xb)

    # chunk states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)      # (B,nc,L,H)
    s_c = torch.einsum("bcln,bclh,bclhp->bchpn", bc_, decay_to_end, xb)
    a_chunk = torch.exp(cum[:, :, -1, :])                  # (B,nc,H)

    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
         if init_state is None else init_state.to(torch.float32))
    hprevs = []
    for i in range(nc):
        hprevs.append(h)
        h = a_chunk[:, i, :, None, None] * h + s_c[:, i]
    hprevs = torch.stack(hprevs, dim=1)                    # (B,nc,H,P,N)

    y_inter = torch.einsum("bcln,bclh,bchpn->bclhp", cc_, torch.exp(cum),
                           hprevs)
    y = (y_intra + y_inter).reshape(B, S, H, P)
    return y.to(xh.dtype), h


# -- the split over ``ssm_heads`` ------------------------------------------
def _xbc_cols(t: torch.Tensor, cfg, r: int, m: int) -> torch.Tensor:
    """Rank ``r`` of ``m``'s x channels and all of B and C from the last
    axis of ``t``, laid out as x (d_inner), B, C; ``t`` itself for m = 1."""
    if m == 1:
        return t
    di, n = cfg.d_inner, cfg.ssm_state
    ci = di // m
    return torch.cat([t.narrow(-1, r * ci, ci), t.narrow(-1, di, 2 * n)],
                     dim=-1)


def _rank_params(params: Params, cfg, group, r: int, m: int) -> Params:
    """Rank ``r`` of ``m``'s slices of the mixer's whole leaves, in their
    layouts: its x channels and B and C (``conv_w``), its entries of
    ``a_log``/``ssm_d``/``dt_bias``/``gate_norm`` and its rows of
    ``out_proj``; ``in_proj`` whole (:func:`_proj_cols` cuts it).  Each
    leaf is held whole and read in part, so it passes ``copy_to`` before
    it is cut: its gradient is then the whole program's on every rank.
    ``params`` itself where the layer runs whole."""
    if group is None:
        return params
    di, h = cfg.d_inner, cfg.ssm_heads
    ci, hr = di // m, h // m
    c = {k: copy_to(v, group) for k, v in params.items()
         if k != "gate_norm"}
    return {
        "in_proj": c["in_proj"],
        "conv_w": _xbc_cols(c["conv_w"], cfg, r, m),
        **{k: c[k].narrow(-1, r * hr, hr)
           for k in ("a_log", "ssm_d", "dt_bias")},
        "out_proj": c["out_proj"].narrow(-2, r * ci, ci),
        "gate_norm": {"scale": copy_to(params["gate_norm"]["scale"],
                                       group).narrow(-1, r * ci, ci)},
    }


def _proj_cols(w: torch.Tensor, cfg, r: int, m: int) -> torch.Tensor:
    """Rank ``r`` of ``m``'s columns of ``in_proj``, laid out as the whole
    one: its z channels, its x channels, all of B and C, its heads of
    dt; ``w`` itself for m = 1."""
    if m == 1:
        return w
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    ci, hr = di // m, h // m
    return torch.cat([w.narrow(-1, r * ci, ci),
                      _xbc_cols(w.narrow(-1, di, di + 2 * n), cfg, r, m),
                      w.narrow(-1, 2 * di + 2 * n + r * hr, hr)], dim=-1)


def _gated_norm(scale: Dict[str, torch.Tensor], g: torch.Tensor, cfg,
                group) -> torch.Tensor:
    """The RMS norm over ``d_inner`` of the gated output ``g``: a rank's
    channels of it where the heads split, its mean of squares the sum of
    the ranks' partial sums over ``d_inner``.  The statistic feeds every
    rank's slice, so its cotangent is summed over the ranks too
    (``copy_to`` after ``psum``)."""
    if group is None:
        return rmsnorm(scale, g, cfg.norm_eps)
    gf = g.to(torch.float32)
    ss = copy_to(psum(gf.square().sum(dim=-1, keepdim=True), group), group)
    y = gf * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)
    return (y * scale["scale"].to(torch.float32)).to(g.dtype)


def ssm_forward(params: Params, x: torch.Tensor, cfg,
                init_state: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """Full-sequence Mamba2 mixer. x: (B,S,D) -> (B,S,D); with
    ``return_state`` also the decode cache {"state", "conv"}.  Where the
    active rules split ``ssm_heads`` the rank runs its heads (``state``
    and ``init_state`` its block, (B, H/m, P, N); ``conv`` whole) and the
    output is summed over the ranks."""
    group, r, m = tp_axis("ssm_heads", cfg.ssm_heads)
    x = copy_to(x, group)
    lp = _rank_params(params, cfg, group, r, m)
    di, n = cfg.d_inner // m, cfg.ssm_state
    proj = x @ _proj_cols(lp["in_proj"], cfg, r, m)
    z, xh, b, c, dt, la = _ssd_inputs(lp, proj, di, n, cfg.ssm_heads // m,
                                      cfg.ssm_head_dim)
    y, state = ops.ssd(xh, b, c, dt, la, cfg.ssm_chunk, init_state)
    y = y + (lp["ssm_d"][:, None]
             * (xh.to(torch.float32) * dt[..., None])).to(y.dtype)
    B_, S_ = x.shape[0], x.shape[1]
    y = y.reshape(B_, S_, di)
    y = _gated_norm(lp["gate_norm"], y * F.silu(z), cfg, group)
    out = psum(y @ lp["out_proj"], group)
    if return_state:
        w = cfg.ssm_conv_width
        if group is None:
            tail = proj[:, -(w - 1):, di:di + di + 2 * n]
        else:   # the conv cache is whole: the raw columns of every channel
            tail = x[:, -(w - 1):] @ lp["in_proj"].narrow(
                -1, cfg.d_inner, cfg.d_inner + 2 * n)
        pad = w - 1 - tail.shape[1]
        if pad > 0:
            tail = F.pad(tail, (0, 0, pad, 0))
        return out, {"state": state, "conv": tail.to(x.dtype)}
    return out


# -- decode -------------------------------------------------------------
def init_ssm_cache(cfg, batch: int, dtype=torch.float32, device=None
                   ) -> Params:
    """The zero decode cache: the state on the rank's heads where the
    active rules split them, the conv history whole."""
    m = tp_axis("ssm_heads", cfg.ssm_heads)[2]
    return {
        "state": torch.zeros((batch, cfg.ssm_heads // m, cfg.ssm_head_dim,
                              cfg.ssm_state),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1,
                             cfg.d_inner + 2 * cfg.ssm_state), dtype=dtype,
                            device=device),
    }


def ssm_decode(params: Params, x: torch.Tensor, cfg, cache: Params):
    """One-token recurrence. x: (B,1,D).  Where the rules split the heads,
    ``cache["state"]`` is the rank's block; the whole conv column is
    computed (one token) and the rank's channels taken from it."""
    B = x.shape[0]
    group, r, m = tp_axis("ssm_heads", cfg.ssm_heads)
    x = copy_to(x, group)
    lp = _rank_params(params, cfg, group, r, m)
    di, n, h, p = (cfg.d_inner // m, cfg.ssm_state, cfg.ssm_heads // m,
                   cfg.ssm_head_dim)
    if group is None:
        z, xbc, dt = _split_proj(x @ params["in_proj"], di, n)  # (B,1,*)
    else:   # the rank's z and dt, the whole conv column
        w, dn = lp["in_proj"], cfg.d_inner + 2 * n
        z = x @ w.narrow(-1, r * di, di)
        xbc = x @ w.narrow(-1, cfg.d_inner, dn)
        dt = x @ w.narrow(-1, cfg.d_inner + dn + r * h, h)
    # conv step: cache["conv"] (B,W-1,C) then the new column
    hist = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)   # (B,W,C)
    conv_out = torch.einsum("bwc,wc->bc", _xbc_cols(hist, cfg, r, m),
                            lp["conv_w"])[:, None, :]
    new_conv = hist[:, 1:, :]
    xbc = F.silu(conv_out)
    xv = xbc[..., :di].reshape(B, h, p)
    b = xbc[..., di:di + n][:, 0, :]                        # (B,N)
    c = xbc[..., di + n:][:, 0, :]
    dt = F.softplus(dt.to(torch.float32) + lp["dt_bias"])[:, 0, :]  # (B,H)
    a = torch.exp(-torch.exp(lp["a_log"]) * dt)             # (B,H)

    xbar = xv.to(torch.float32) * dt[..., None]             # (B,H,P)
    new_state = (a[:, :, None, None] * cache["state"]
                 + torch.einsum("bhp,bn->bhpn", xbar, b.to(torch.float32)))
    y = torch.einsum("bhpn,bn->bhp", new_state, c.to(torch.float32))
    y = y + lp["ssm_d"][:, None] * xbar
    y = y.reshape(B, 1, di).to(x.dtype)
    y = _gated_norm(lp["gate_norm"], y * F.silu(z), cfg, group)
    return psum(y @ lp["out_proj"], group), {"state": new_state,
                                             "conv": new_conv}
