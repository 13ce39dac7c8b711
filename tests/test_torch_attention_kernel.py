"""Kernel D, causal self-attention (``kernels/attention.py``), and its route
in ``models/attention.py::attn_forward``.

On the CPU the Functions ``CausalAttention`` and ``CausalAttentionBwd``
take the plain form, so there they are held bit for bit to today's
``plain_attention`` and its autograd gradients: under
``torch.func.vmap(torch.func.grad_and_value(...))`` and inside the
recompute of ``models/transformer.py`` (``_Recompute``), at the test
model's shapes (hd 32, 3 q heads on 1 kv head, S 1, 17 and 64).  The
route is held to causal self-attention without a window: the windowed,
encoder, cross and decode forms never reach it (``KERNEL_DEVICES``
widened to the CPU, so that only the route's other conditions decide).
A federated round of the SmolLM test model counts the forward and
backward calls the card's round makes: two forwards (forward and
recompute) and one backward a layer and local step, the groups folded
into one call.

The CUDA kernel runs only on a card (``cuda``-marked tests, skipped
here; ``python3 chip_smoke.py --phases 50`` times it there).  There it is
held to the plain form on the same card tensors, forward and the three
gradients, over every head dim it takes (``HEAD_DIMS``: 16, 32, 48, 64
and 128), 1, 3 and 8 q heads a kv head, S of 1 to 4,096, f32 and bf16,
and under ``vmap`` over 4 groups.

Tolerances on the card, relative to each tensor's largest magnitude (at
least 1): f32 ``F32_TOL``: the kernel sums its products in another order
(tiles folded in f32, an online softmax rescaled tile by tile) and forms
each product in split TF32, whose dropped lo x lo term is 2^-22 of it;
bf16 ``BF16_STEP``: outputs and gradients are rounded to bf16 once, so
two f32 values a few ulps apart may round one bf16 step (2^-8 to 2^-7 of
the value) apart, and the kernel rounds the probabilities it multiplies
by v to bf16 before normalizing them (as the flash form does), the plain
form after.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig, get_smoke_config
from repro_torch.kernels import attention as K
from repro_torch.models import attention as A
from repro_torch.models import transformer as T

from torch_threads import one_torch_thread  # noqa: F401

F32_TOL = 1e-5
BF16_STEP = 2.0 ** -7
# the test model's attention: hd 32, 3 q heads reading 1 kv head
TEST_HD, TEST_H, TEST_G = 32, 3, 1


def _qkv(B, S, H, G, hd, seed, dtype=torch.float32, n=None):
    """Seeded q, k, v and an output cotangent (with a leading axis of
    ``n`` groups when given), made on the CPU."""
    g = torch.Generator().manual_seed(seed)
    lead = () if n is None else (n,)
    f = lambda *s: torch.randn(lead + s, generator=g)  # noqa: E731
    q, k, v = f(B, S, H, hd), f(B, S, G, hd), f(B, S, G, hd)
    return [t.to(dtype) for t in (q, k, v)], f(B, S, H, hd).to(dtype)


def _plain_mask(S):
    return torch.ones((S, S), dtype=torch.bool).tril()


# ----------------------------------------------------------------------
# the Functions' CPU path is the plain form, bit for bit
# ----------------------------------------------------------------------
def _vmapped(attend, qkv, w):
    """vmap over the groups of grad_and_value of a weighted sum of the
    attention output."""
    def loss(q, k, v):
        return (attend(q, k, v).float() * w).sum()
    return torch.func.vmap(torch.func.grad_and_value(
        loss, argnums=(0, 1, 2)))(*qkv)


def _through_recompute(q, k, v):
    return T._recompute(lambda a, b, c: (K.causal_attention(a, b, c),),
                        q, k, v)[0]


def _today(q, k, v):
    return A.plain_attention(q, k, v, _plain_mask(q.shape[1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["vmap_grad", "recompute"])
@pytest.mark.parametrize("S", [1, 17, 64])
def test_cpu_path_is_the_plain_form(S, form, dtype):
    """The Functions' value and gradients under vmap(grad_and_value),
    directly or inside ``_Recompute``, equal ``plain_attention``'s bit
    for bit; the groups fold into one forward and one backward call."""
    qkv, w = _qkv(2, S, TEST_H, TEST_G, TEST_HD, S, dtype, n=4)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = K._forward, K._backward

    def counted(name, fn):
        def call(*a):
            calls[name] += 1
            return fn(*a)
        return call

    attend = K.causal_attention if form == "vmap_grad" else \
        _through_recompute
    try:
        K._forward, K._backward = counted("fwd", fwd), counted("bwd", bwd)
        (grads, loss) = _vmapped(attend, qkv, w[0].float())
    finally:
        K._forward, K._backward = fwd, bwd
    want_grads, want_loss = _vmapped(_today, qkv, w[0].float())
    assert torch.equal(loss, want_loss)
    for g, wg in zip(grads, want_grads):
        assert g.dtype == wg.dtype and torch.equal(g, wg)
    # forward and recompute; the 4 groups in one call each
    assert calls == {"fwd": 1 if form == "vmap_grad" else 2, "bwd": 1}


@pytest.mark.parametrize("S", [1, 17, 64])
def test_cpu_forward_gives_the_output_and_each_rows_logsumexp(S):
    (q, k, v), _ = _qkv(2, S, TEST_H, TEST_G, TEST_HD, 7)
    o, lse = K.CausalAttention.apply(q, k, v)
    assert o.dtype == lse.dtype == torch.float32
    assert torch.equal(o, _today(q, k, v))
    s = torch.where(_plain_mask(S), A.grouped_scores(q, k), A.NEG_INF)
    assert lse.shape == (2, TEST_H, S)
    assert torch.equal(lse, torch.logsumexp(s, -1).reshape(2, TEST_H, S))
    assert not lse.requires_grad


def test_meta_tensors_take_the_plain_form():
    (q, k, v), do = _qkv(2, 9, TEST_H, TEST_G, TEST_HD, 3)
    q, k, v, do = (t.to("meta") for t in (q, k, v, do))
    o, lse = K.CausalAttention.apply(q, k, v)
    assert o.shape == q.shape and lse.shape == (2, TEST_H, 9)
    dq, dk, dv = K.CausalAttentionBwd.apply(q, k, v, o, lse, do)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


def test_double_backward_raises():
    (q, k, v), _ = _qkv(1, 5, TEST_H, TEST_G, TEST_HD, 4)
    q.requires_grad_(True)
    o = K.causal_attention(q, k, v)
    (g,) = torch.autograd.grad(o.sum(), q, create_graph=True)
    with pytest.raises(RuntimeError, match="no gradient of its own"):
        g.sum().backward()


@pytest.mark.parametrize("case", ["head_dim", "dtype", "shape", "groups"])
def test_inputs_the_kernel_does_not_take_raise(case):
    (q, k, v), _ = _qkv(1, 5, 4, 2, 32, 5)
    if case == "head_dim":
        q, k, v = q[..., :24], k[..., :24], v[..., :24]
    elif case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "shape":
        k = k[:, :4]
    else:
        k, v = (torch.cat([t, t[:, :, :1]], 2) for t in (k, v))
    with pytest.raises((ValueError, TypeError)):
        K.causal_attention(q, k, v)


@pytest.mark.parametrize("hd", K.HEAD_DIMS)
def test_scale_is_the_f32_reciprocal_of_the_f32_root(hd):
    (q, k, _), _ = _qkv(1, 2, 2, 1, hd, 6)
    bits = K._params(q, k)[-1]
    scale = np.array([bits], np.uint32).view(np.float32)[0]
    assert scale == np.float32(1.0) / np.float32(np.sqrt(hd))
    assert K._params(q, k)[:6] == (1, 2, 2, 1, hd, 0)


# ----------------------------------------------------------------------
# the route: causal self-attention without a window, nothing else
# ----------------------------------------------------------------------
@pytest.fixture
def routed_here(monkeypatch):
    """The route widened to CPU tensors, and the kernel's forward calls
    counted."""
    monkeypatch.setattr(A, "KERNEL_DEVICES", ("cuda", "cpu"))
    calls = []
    fwd = K._forward

    def counted(*a):
        calls.append(a[0].shape)
        return fwd(*a)
    monkeypatch.setattr(K, "_forward", counted)
    return calls


def _layer(arch, cross=False, seed=0):
    cfg = get_smoke_config(arch)
    return cfg, A.attn_init(torch.Generator().manual_seed(seed), cfg,
                            cross=cross)


def _x(B, S, D, seed):
    return torch.randn(B, S, D, generator=torch.Generator().manual_seed(
        seed))


FORMS = ["causal", "causal_past_flash_threshold", "window", "encoder",
         "cross", "decode", "decode_rolling", "decode_quantized",
         "decode_cross", "decode_seqshard"]


@pytest.mark.parametrize("form", FORMS)
def test_route_takes_causal_self_attention_only(routed_here, form):
    """With the route open to CPU tensors, causal self-attention (below and
    past the flash threshold) reaches the kernel's Function once and
    gives the branch's value it replaces (bit for bit below the
    threshold: the Function's CPU path is the plain form); the windowed,
    encoder and cross forms and every decode never reach it."""
    cfg, p = _layer("qwen3_1_7b")
    B, S = 2, 12
    x = _x(B, S, cfg.d_model, 1)
    pos = torch.arange(S).expand(B, S)
    if form.startswith("causal"):
        thr = 8 if form.endswith("threshold") else 2048
        got = A.attn_forward(p, x, pos, cfg, flash_threshold=thr)
        assert routed_here == [(B, S, cfg.n_heads, cfg.head_dim)]
        A.KERNEL_DEVICES = ("cuda",)
        want = A.attn_forward(p, x, pos, cfg, flash_threshold=thr)
        if thr == 2048:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        return
    if form == "window":
        A.attn_forward(p, x, pos, cfg, window=4)
    elif form == "encoder":
        A.attn_forward(p, x, pos, cfg, causal=False)
    elif form == "cross":
        cfg, p = _layer("whisper_tiny", cross=True)
        A.attn_forward(p, _x(B, S, cfg.d_model, 1), pos, cfg,
                       enc_out=_x(B, 7, cfg.d_model, 2))
    elif form == "decode_cross":
        cfg, p = _layer("whisper_tiny", cross=True)
        c = A.init_cache(cfg, B, 8, torch.float32, cross_len=7,
                         device="cpu")
        A.attn_decode(p, _x(B, 1, cfg.d_model, 3), 2, cfg, c, cross=True)
    elif form == "decode_seqshard":
        import torch.distributed as dist
        from repro_torch.launch.mesh import init_world, make_host_mesh
        from repro_torch.sharding.rules import Rules, use_rules
        cfg, p = _layer("granite_34b")
        c = A.init_cache(cfg, B, 8, torch.float32, device="cpu")
        init_world("gloo")
        try:
            with use_rules(Rules(make_host_mesh(1, 1))):
                A.attn_decode_seqshard(p, _x(B, 1, cfg.d_model, 3), 2, cfg,
                                       c)
        finally:
            dist.destroy_process_group()
    else:
        c = A.init_cache(cfg, B, 8, torch.float32,
                         quantized=form == "decode_quantized", device="cpu")
        A.attn_decode(p, _x(B, 1, cfg.d_model, 3), 5, cfg, c,
                      rolling=form == "decode_rolling")
    assert routed_here == []


def test_route_is_closed_to_cpu_tensors():
    """Unwidened, the route takes CUDA tensors only: on the CPU every form
    keeps today's branch."""
    assert A.KERNEL_DEVICES == ("cuda",)
    cfg, p = _layer("qwen3_1_7b")
    x, pos = _x(2, 12, cfg.d_model, 1), torch.arange(12).expand(2, 12)
    calls = []
    fwd = K._forward
    try:
        K._forward = lambda *a: calls.append(1) or fwd(*a)
        A.attn_forward(p, x, pos, cfg)
    finally:
        K._forward = fwd
    assert calls == []


def test_a_round_counts_two_forwards_and_one_backward_a_layer_and_step(
        routed_here):
    """The SmolLM cell's round, at its test model: G = 4 groups, E = 2
    local steps, ``lm_loss(remat=True, loss_chunk=512)``.  Each layer of
    each local step calls the forward twice (the forward pass and the
    recompute) and the backward once, the 4 groups folded into each call
    (on the card: 120 and 60 a round at 30 layers)."""
    import json
    from pathlib import Path

    from repro_torch.core import fed_step as F
    root = Path(__file__).resolve().parents[1]
    conf = json.loads((root / "perfbench" / "configs" / "smollm-135m.json")
                      .read_text())
    cfg = ModelConfig(**conf["test_model"])
    G, E, MB, SEQ = 4, 2, 2, 64
    step = F.make_fed_train_step(
        lambda p, b: T.lm_loss(p, b, cfg, remat=True, loss_chunk=512)[0],
        F.FedConfig(n_groups=G, local_steps=E, lr=1e-2, schedule="gather_q"))
    params = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (G * E * MB, SEQ),
                           generator=torch.Generator().manual_seed(1))
    bwd = K._backward
    backward = []

    def counted(*a):
        backward.append(a[0].shape)
        return bwd(*a)
    K._backward = counted
    try:
        step(params, {"tokens": tokens}, torch.tensor([0, 1, 2, 3]))
    finally:
        K._backward = bwd
    L = cfg.n_layers
    folded = (G * MB, SEQ, cfg.n_heads, cfg.d_model // cfg.n_heads)
    assert routed_here == [folded] * (2 * L * E)
    assert backward == [folded] * (L * E)


# ----------------------------------------------------------------------
# the kernel on the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    """The CUDA device, decided when the test runs (skip without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel D runs only on the card "
                    "(python3 chip_smoke.py --phases 50 times it there)")
    return torch.device("cuda")


def _close(got, want, tol, what):
    got, want = got.detach().float(), want.detach().float()
    assert got.shape == want.shape, what
    assert bool(torch.isfinite(got).all()), f"{what}: not finite"
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    torch.testing.assert_close(got, want, atol=tol * scale, rtol=tol,
                               msg=lambda m: f"{what}: {m}")


def _kernel_and_plain(qkv, do):
    """(o, grads) of the kernel and of the plain form on the same
    tensors, and the kernel's forward and backward calls."""
    before = (K.FWD_LAUNCHES, K.BWD_LAUNCHES)
    o, vjp = torch.func.vjp(K.causal_attention, *qkv)
    grads = vjp(do)
    calls = (K.FWD_LAUNCHES - before[0], K.BWD_LAUNCHES - before[1])
    wo, wvjp = torch.func.vjp(K.causal_attention_plain, *qkv)
    return (o, grads), (wo, wvjp(do)), calls


CARD_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CARD_DTYPES)
@pytest.mark.parametrize("S", [1, 17, 255, 2048, 4096])
@pytest.mark.parametrize("rep", [1, 3, 8])
@pytest.mark.parametrize("hd", K.HEAD_DIMS)
def test_kernel_matches_plain_on_card(card, hd, rep, S, dtype):
    G = 1 if rep == 8 else 2
    B = 2 if S <= 255 else 1
    qkv, do = _qkv(B, S, G * rep, G, hd, 11 + S, dtype)
    qkv, do = [t.to(card) for t in qkv], do.to(card)
    (o, grads), (wo, wgrads), calls = _kernel_and_plain(qkv, do)
    assert calls == (1, 1)
    tol = F32_TOL if dtype == torch.float32 else BF16_STEP
    where = f"hd {hd}, rep {rep}, S {S}, {dtype}"
    assert o.dtype == dtype
    _close(o, wo, tol, f"o ({where})")
    for name, g, w in zip(("dq", "dk", "dv"), grads, wgrads):
        assert g.dtype == dtype, name
        _close(g, w, tol, f"{name} ({where})")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CARD_DTYPES)
@pytest.mark.parametrize("S", [255, 2048])
def test_kernel_under_vmap_on_card(card, S, dtype):
    """vmap over 4 groups of grad_and_value, SmolLM's heads (9 on 3,
    hd 64): one forward and one backward call for the 4 groups, equal to
    the plain form's vmapped gradients."""
    qkv, w = _qkv(2, S, 9, 3, 64, 5 + S, dtype, n=4)
    qkv, w = [t.to(card) for t in qkv], w[0].float().to(card)
    before = (K.FWD_LAUNCHES, K.BWD_LAUNCHES)
    grads, loss = _vmapped(K.causal_attention, qkv, w)
    assert (K.FWD_LAUNCHES - before[0], K.BWD_LAUNCHES - before[1]) == \
        (1, 1)
    wgrads, wloss = _vmapped(K.causal_attention_plain, qkv, w)
    tol = F32_TOL if dtype == torch.float32 else BF16_STEP
    _close(loss, wloss, tol, "loss")
    for name, g, wg in zip(("dq", "dk", "dv"), grads, wgrads):
        _close(g, wg, tol, f"{name} (S {S}, {dtype})")


@pytest.mark.cuda
def test_kernel_gives_the_same_bits_twice(card):
    """No float atomics: the output, the log-sum-exp and the gradients
    come back bit for bit on a second call."""
    qkv, do = _qkv(2, 2048, 9, 3, 64, 3)
    qkv, do = [t.to(card) for t in qkv], do.to(card)
    runs = []
    for _ in range(2):
        o, lse = K.CausalAttention.apply(*qkv)
        runs.append((o, lse) + K.CausalAttentionBwd.apply(*qkv, o, lse, do))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
