"""Kernel C's backward (``kernels/ssd_scan.py``) against autograd and the
JAX package, on the CPU.

The plain backward ``ssd_intra_chunk_bwd_plain`` writes the
vector-Jacobian product of the intra-chunk step out; here it is held
against ``torch.func.vjp`` of the plain forward, against ``jax.vjp`` of
the JAX package's oracle ``repro.kernels.ref.ssd_chunk_ref`` (the JAX
package has no backward kernel: ``jax.vjp`` cannot differentiate its
Pallas call), and, through ``ssd_chunked_kernel``, against ``jax.vjp`` of
its model's ``ssd_chunked``.  The autograd Function that routes the
gradient (``SSDIntraChunkBwd``) runs the plain backward on CPU and meta
tensors, so it is held here under ``torch.func.vmap`` of
``grad_and_value`` and under the recompute of ``models/transformer.py``.
The CUDA kernel itself runs only on a card (``cuda``-marked test, skipped
here; ``python3 chip_smoke.py`` phase 27 holds it there).  The JAX
package is imported inside the tests that use it, so that the card's
machine, which has no JAX, can collect this file and run the ``cuda``
test.

Tolerance: 1e-5, relative to each gradient's largest magnitude (and
1e-5 relative elementwise).  dcum is a difference of row and column sums
of Q = dW o W, whose terms are far larger than many of its elements, so
an f32 sum in another order moves an element by a share of the terms'
scale, not of its own.  Gradients of bf16 b and c are rounded to bf16
once, so two f32 sums a few ulps apart may round one bf16 step apart:
those are held within one step (2^-8 to 2^-7 of the value, so 2^-7).
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ssd_scan as K
from repro_torch.models import transformer as T

from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
BF16_STEP = 2.0 ** -7


def _close(got, want, tol=TOL, what=""):
    got, want = got.detach().float(), want.detach().float()
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    torch.testing.assert_close(got, want, atol=tol * scale, rtol=tol,
                               msg=lambda m: f"{what}: {m}")


def _close_grads(got, want, bf16=False, tol=TOL):
    for name, g, w in zip(("dxb", "db", "dc", "dcum"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.shape,
                                                           w.shape)
        low = bf16 and name in ("db", "dc")
        _close(g, w, BF16_STEP if low else tol, name)


def _cells(G, heads, L, P, N, seed, dtype=torch.float32):
    """Seeded cells (xb, b, c, cum) and cotangents (gy, gs, ga) as
    numpy-made tensors; cum is a decreasing cumulative log-decay."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    xb, b, c = f(G, L, P), f(G // heads, L, N), f(G // heads, L, N)
    cum = np.cumsum(-np.abs(f(G, L)) * 0.1, axis=1)[:, None, :]
    gy, gs, ga = f(G, L, P), f(G, N, P), f(G, 1)
    ins = [torch.from_numpy(a) for a in (xb, b, c, cum)]
    ins[1], ins[2] = ins[1].to(dtype), ins[2].to(dtype)
    return ins, [torch.from_numpy(a) for a in (gy, gs, ga)]


def _plain_vjp(ins, cot, heads):
    _, vjp = torch.func.vjp(
        lambda *a: K.ssd_intra_chunk_plain(*a, heads), *ins)
    return vjp(tuple(cot))


# ----------------------------------------------------------------------
# the plain backward
# ----------------------------------------------------------------------
@pytest.mark.parametrize("zero", [None, "gy", "gs", "ga"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [8, 64])
@pytest.mark.parametrize("N", [8, 16])
@pytest.mark.parametrize("heads", [1, 2, 4])
def test_bwd_plain_matches_vjp_of_plain_forward(heads, N, L, dtype, zero):
    """The written-out backward equals ``torch.func.vjp`` of the plain
    forward; with each cotangent zeroed in turn, so that a slip in one of
    dcum's terms (the row and column sums of Q, d r, ga a at L - 1) cannot
    hide behind another."""
    ins, cot = _cells(2 * heads, heads, L, 16, N, 100 + L + N + heads,
                      dtype)
    if zero is not None:
        i = ("gy", "gs", "ga").index(zero)
        cot[i] = torch.zeros_like(cot[i])
    got = K.ssd_intra_chunk_bwd_plain(*ins, *cot, heads)
    _close_grads(got, _plain_vjp(ins, cot, heads),
                 bf16=dtype == torch.bfloat16)


def test_dcum_terms_land_where_they_should():
    """dcum alone, each term by itself: with gy = gS = 0 only ga·a at
    position L - 1; with gy = ga = 0 the d r terms, which cancel at L - 1
    and sum to zero over the cell."""
    ins, (gy, gs, ga) = _cells(3, 1, 12, 8, 8, 7)
    zy, zs, za = (torch.zeros_like(t) for t in (gy, gs, ga))
    *_, dcum = K.ssd_intra_chunk_bwd_plain(*ins, zy, zs, ga, 1)
    want = torch.zeros_like(dcum)
    want[..., -1] = ga * torch.exp(ins[3][..., -1])
    _close(dcum, want, what="ga alone")
    *_, dcum = K.ssd_intra_chunk_bwd_plain(*ins, zy, gs, za, 1)
    _close(dcum.sum(-1), torch.zeros(3, 1), what="d r terms")
    assert float(dcum.abs().max()) > 1e-2
    _close(dcum, _plain_vjp(ins, (zy, gs, za), 1)[3], what="gS alone")
    *_, dcum = K.ssd_intra_chunk_bwd_plain(*ins, gy, zs, za, 1)
    _close(dcum.sum(-1), torch.zeros(3, 1), what="Q terms")
    _close(dcum, _plain_vjp(ins, (gy, zs, za), 1)[3], what="gy alone")


@pytest.mark.parametrize("heads", [1, 2, 4])
def test_bwd_plain_matches_jax_ssd_chunk_ref(heads):
    """Against ``jax.vjp`` of the JAX package's oracle, one cell at a time
    under ``jax.vmap``; the heads' gradients of b and c summed, as cells
    of one (batch, chunk) share them."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jax_ref
    G, L, P, N = 2 * heads, 32, 16, 8
    ins, cot = _cells(G, heads, L, P, N, 40 + heads)
    xb, b, c, cum = (t.numpy() for t in ins)
    bb = np.repeat(b, heads, axis=0)
    cc = np.repeat(c, heads, axis=0)
    _, vjp = jax.vjp(jax.vmap(jax_ref.ssd_chunk_ref), jnp.asarray(xb),
                     jnp.asarray(bb), jnp.asarray(cc),
                     jnp.asarray(cum[:, 0, :]))
    gy, gs, ga = (t.numpy() for t in cot)
    dx, db, dc, dcum = vjp((jnp.asarray(gy), jnp.asarray(gs),
                            jnp.asarray(ga[:, 0])))
    want = [torch.from_numpy(np.array(a)) for a in (
        dx, np.asarray(db).reshape(G // heads, heads, L, N).sum(1),
        np.asarray(dc).reshape(G // heads, heads, L, N).sum(1),
        np.asarray(dcum)[:, None, :])]
    _close_grads(K.ssd_intra_chunk_bwd_plain(*ins, *cot, heads), want)


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_chunked_kernel_grads_match_jax_ssd_chunked(chunk):
    """The gradients of ``ssd_chunked_kernel`` (its intra-chunk step
    through the Function, so through the plain backward here) against
    ``jax.vjp`` of the JAX package's ``ssd_chunked``, ``init_state``
    included, for a cotangent of y and of the final state."""
    import jax
    import jax.numpy as jnp
    from repro.models import ssm as JS
    rng = np.random.RandomState(5)
    B, S, H, P, N = 2, 64, 2, 16, 8
    xh = rng.randn(B, S, H, P).astype(np.float32)
    b = (rng.randn(B, S, N) * 0.3).astype(np.float32)
    c = (rng.randn(B, S, N) * 0.3).astype(np.float32)
    dt = (np.abs(rng.randn(B, S, H)) * 0.1).astype(np.float32)
    la = (-np.abs(rng.randn(B, S, H)) * 0.05).astype(np.float32)
    h0 = rng.randn(B, H, P, N).astype(np.float32)
    gy = rng.randn(B, S, H, P).astype(np.float32)
    gh = rng.randn(B, H, P, N).astype(np.float32)
    arrs = (xh, b, c, dt, la, h0)
    _, vjp = jax.vjp(lambda *a: JS.ssd_chunked(*a[:5], chunk, a[5]),
                     *(jnp.asarray(a) for a in arrs))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    _, tvjp = torch.func.vjp(
        lambda *a: K.ssd_chunked_kernel(*a[:5], chunk, a[5]),
        *(torch.from_numpy(a) for a in arrs))
    got = tvjp((torch.from_numpy(gy), torch.from_numpy(gh)))
    for name, g, w in zip(("xh", "b", "c", "dt", "la", "init_state"), got,
                          want):
        _close(g, torch.from_numpy(np.array(w)), what=name)


# ----------------------------------------------------------------------
# the Function under torch.func and the recompute
# ----------------------------------------------------------------------
def _loss(cot, heads):
    gy, gs, ga = cot

    def loss(xb, b, c, cum):
        y, s, a = K.ssd_intra_chunk(xb, b, c, cum, heads=heads)
        return (y * gy).sum() + (s * gs).sum() + (a * ga).sum()
    return loss


@pytest.mark.parametrize("mapped", ["xb", "all"])
def test_function_under_vmap_of_grad_and_value_equals_a_loop(mapped):
    """``torch.func.vmap(torch.func.grad_and_value(...))`` through
    ``SSDIntraChunk`` and its backward Function (each with its own vmap
    rule, the mapped axis folded into the cells) equals a loop over the
    mapped axis, as the federated round and the cohort loss run it."""
    heads = 2
    ins, cot = _cells(4, heads, 8, 8, 8, 21)
    loss = _loss(cot, heads)
    n = 3
    scale = torch.tensor([1.0, 0.5, -2.0])
    if mapped == "xb":
        batched = [torch.stack([ins[0] * s for s in scale])] + ins[1:]
        dims = (0, None, None, None)
    else:
        batched = [torch.stack([t * s for s in scale]) for t in ins[:3]] + [
            torch.stack([ins[3] * (1 + 0.1 * i) for i in range(n)])]
        dims = (0, 0, 0, 0)
    fn = torch.func.grad_and_value(loss, argnums=(0, 1, 2, 3))
    grads, vals = torch.func.vmap(fn, in_dims=dims)(*batched)
    for i in range(n):
        one = [t[i] if d == 0 else t for t, d in zip(batched, dims)]
        g, v = fn(*one)
        _close(vals[i], v, what="value")
        for name, a, w in zip(("dxb", "db", "dc", "dcum"), grads, g):
            _close(a[i], w, what=f"{name} of copy {i}")


def test_function_through_the_recompute():
    """``models/transformer.py::_Recompute`` (the remat of ``lm_loss``)
    around a step through the Function: the gradient equals the one
    without the recompute, under ``torch.func.grad`` (the inner
    ``vjp(create_graph=False)``) and under plain autograd."""
    heads = 2
    ins, cot = _cells(4, heads, 8, 8, 8, 22)
    gy, gs, ga = cot

    def step(xb, b, c, cum):
        return K.ssd_intra_chunk(xb, b, c, cum, heads=heads)

    def loss(recompute):
        def f(xb, b, c, cum):
            y, s, a = (T._recompute(step, xb, b, c, cum) if recompute
                       else step(xb, b, c, cum))
            return (y * gy).sum() + (s * gs).sum() + (a * ga).sum()
        return f

    want = torch.func.grad(loss(False), argnums=(0, 1, 2, 3))(*ins)
    got = torch.func.grad(loss(True), argnums=(0, 1, 2, 3))(*ins)
    for name, g, w in zip(("dxb", "db", "dc", "dcum"), got, want):
        _close(g, w, what=name)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    auto = torch.autograd.grad(loss(True)(*leaves), leaves)
    for name, g, w in zip(("dxb", "db", "dc", "dcum"), auto, want):
        _close(g, w, what=f"autograd {name}")
    # under vmap of grad, as the federated round runs a remat loss
    xs = torch.stack([ins[0], 2 * ins[0]])
    vm = torch.func.vmap(torch.func.grad(loss(True)),
                         in_dims=(0, None, None, None))(xs, *ins[1:])
    _close(vm[1], torch.func.grad(loss(False))(xs[1], *ins[1:]),
           what="vmap of grad through the recompute")


def test_graph_through_the_backward_builds_and_its_own_backward_raises():
    """``create_graph=True`` (as ``grad_and_value`` differentiates) builds
    a graph through the backward Function without raising; only
    differentiating the gradient itself raises."""
    ins, cot = _cells(2, 1, 8, 8, 8, 23)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    out = K.ssd_intra_chunk(*leaves, heads=1)
    g = torch.autograd.grad(out, leaves, cot, create_graph=True)
    _close_grads(g, _plain_vjp(ins, cot, 1))
    assert g[0].requires_grad
    with pytest.raises(RuntimeError, match="no gradient of its own"):
        torch.autograd.grad(g[0].sum(), leaves[0])


def test_meta_tensors_take_the_plain_backward():
    """The dry run's meta tensors differentiate through the Function (the
    plain backward), with the gradients' shapes and dtypes."""
    G, heads, L, P, N = 4, 2, 16, 8, 8
    ins = [torch.empty(s, device="meta", dtype=d) for s, d in (
        ((G, L, P), torch.float32), ((G // heads, L, N), torch.bfloat16),
        ((G // heads, L, N), torch.bfloat16), ((G, 1, L), torch.float32))]
    leaves = [t.requires_grad_(True) for t in ins]
    out = K.ssd_intra_chunk(*leaves, heads=heads)
    grads = torch.autograd.grad(out, leaves, [torch.ones_like(o)
                                              for o in out])
    for g, t in zip(grads, ins):
        assert g.device.type == "meta"
        assert (g.shape, g.dtype) == (t.shape, t.dtype)


def test_backward_on_another_device_raises():
    """The backward runs on cuda (the kernel), cpu or meta (the plain
    version); any other device raises, with no fallback."""
    ins, cot = _cells(2, 1, 8, 8, 8, 24)
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        K._intra_chunk_bwd(other, *ins[1:], *cot, 1)


@pytest.mark.parametrize("G,heads,L", [(320, 4, 8), (64, 32, 256),
                                       (256, 32, 256), (16, 2, 256),
                                       (3, 3, 12), (1024, 128, 256)])
def test_bwd_plan_covers_every_head_once(G, heads, L):
    """Route 1's head groups: equal groups covering every head once, and
    enough of them for a CTA on each SM where heads allow."""
    per, groups = K.bwd_plan(G, heads, L)
    assert 1 <= per <= heads and per * groups == heads
    assert sorted(h for g in range(groups) for h in
                  range(g * per, (g + 1) * per)) == list(range(heads))
    tiles = -(-L // K.BWD_TILE)
    ctas = (G // heads) * tiles
    if ctas * heads >= K.BWD_CTAS:
        assert ctas * groups >= K.BWD_CTAS or groups == heads


@pytest.mark.parametrize("heads,L,P,N,route", [
    (4, 8, 16, 8, 2),           # ssm_lm's local step
    (4, 16, 16, 8, 2),
    (4, 32, 16, 8, 1),          # past the crossover
    (32, 256, 64, 128, 1),      # Mamba2-370M's chunk
    (32, 8, 64, 128, 1),        # its widths at a small chunk: work too large
    (128, 256, 64, 16, 1),      # Jamba's
    (1, 64, 64, 128, 1),        # route 2's shared memory would not fit
    (1, 1, 4, 4, 2)])
def test_bwd_route_picks_by_shape(heads, L, P, N, route):
    """The route depends on the shape alone: small chunks (one CTA's work
    at most ``SMALL_MAX_WORK`` and its shared memory within an SM's) take
    route 2, everything else the tensor cores."""
    assert K.bwd_route(heads, L, P, N) == route
    work = heads * L * (L + N) * P
    fits = K.small_smem_bytes(L, P, N) <= K.SMEM_MAX
    assert (route == 2) == (work <= K.SMALL_MAX_WORK and fits)


def test_bwd_route_crossover_is_the_work_bound():
    """Just below and above ``SMALL_MAX_WORK`` the route changes, at a
    width where route 2's shared memory fits on both sides."""
    P, N, L = 16, 8, 8
    per_head = L * (L + N) * P
    h = K.SMALL_MAX_WORK // per_head
    assert K.bwd_route(h, L, P, N) == 2
    assert K.bwd_route(h + 1, L, P, N) == 1


@pytest.mark.parametrize("L,P,N", [(8, 16, 8), (1, 4, 4), (33, 64, 128),
                                   (64, 64, 128)])
def test_small_smem_is_sized_to_the_shape(L, P, N):
    """Route 2's shared memory counts each of its parts at the launch's
    shape and batch of heads, rounded to 16 bytes; at ``ssm_lm``'s shape
    its 4 heads run at once in little enough for several CTAs on an SM
    (the 80 (batch, chunk) groups of a step in one wave); at Mamba2's
    widths and L = 64 not even one head fits."""
    r4 = lambda n: -(-n // 4) * 4
    common = [L * N] * 3 + [L * L] * 2
    head = [L * P] * 2 + [N * P] + [L] * 3 + [L * L] * 3 + [L * N]
    for hb in (1, 3):
        want = sum(r4(n) for n in common) + hb * sum(r4(n) for n in head)
        assert K.small_smem_bytes(L, P, N, hb) == 4 * want
    hb = K.small_heads(4, L, P, N)
    assert 1 <= hb <= 4
    if hb > 1 or K.small_smem_bytes(L, P, N, 1) <= K.SMALL_SMEM_TARGET:
        assert K.small_smem_bytes(L, P, N, hb) <= K.SMALL_SMEM_TARGET
    if (L, P, N) == (8, 16, 8):
        assert hb == 4 and K.small_smem_bytes(L, P, N, hb) * 4 <= K.SMEM_MAX
    if (L, P, N) == (64, 64, 128):
        assert K.small_smem_bytes(L, P, N) > K.SMEM_MAX


@pytest.mark.parametrize("G,heads,L,P,N,bf16", [
    (320, 4, 8, 16, 8, False), (64, 32, 256, 64, 128, False),
    (256, 32, 256, 64, 128, True), (16, 2, 200, 64, 128, False),
    (6, 3, 65, 16, 8, True), (1024, 128, 256, 64, 16, False)])
def test_bwd_layout_parts_are_aligned_and_disjoint(G, heads, L, P, N, bf16):
    """The call's buffers: the four outputs and, on route 1, the six
    workspace parts each start 16-byte aligned, hold their shape's floats
    and do not overlap; the launcher's 14 shape arguments say the route
    and the head groups."""
    gb = G // heads
    for route in (1, 2):
        lay = K.bwd_layout(G, heads, L, P, N, bf16, route)
        outs = [(lay.dx, G * L * P), (lay.db, gb * L * N),
                (lay.dc, gb * L * N), (lay.dcum, G * L)]
        for (a, n), (b, _) in zip(outs, outs[1:] + [(lay.out_floats, 0)]):
            assert a % 4 == 0 and a + n <= b
        flag, g, h, l, p, n, r, per, *offs = lay.args
        assert (flag, g, h, l, p, n, r) == (int(bf16), G, heads, L, P, N,
                                            route)
        if route == 2:
            assert lay.ws_floats == 0 and per == K.small_heads(heads, L, P, N)
            continue
        assert per == K.bwd_plan(G, heads, L)[0]
        groups, tiles = heads // per, -(-L // K.BWD_TILE)
        Lp, Np = tiles * 64, -(-N // 64) * 64
        sizes = [groups * gb * Lp * Lp, groups * gb * Lp * Np,
                 G * tiles * Lp, G * Lp, G * tiles,
                 gb * tiles * tiles * 64 * 64]
        ends = offs[1:] + [lay.ws_floats]
        for a, n, b in zip(offs, sizes, ends):
            assert a % 4 == 0 and a + n <= b


# ----------------------------------------------------------------------
# the kernel on the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    """The CUDA device, decided when the test runs (skip without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the backward kernel runs only on "
                    "the card (python3 chip_smoke.py phase 27 holds it "
                    "there)")
    return torch.device("cuda")


# the card's cases: the paths' shapes, then both routes and their
# boundaries (L of 1 to 256 around the 64-row tiles, P 16 and 64, N 8, 16
# and 128, 1 to 32 heads, f32 and bf16)
CARD_CASES = [
    (320, 4, 8, 16, 8, torch.float32), (64, 32, 256, 64, 128, torch.float32),
    (16, 2, 256, 64, 128, torch.float32), (8, 1, 200, 64, 128, torch.float32),
    (64, 32, 256, 64, 16, torch.bfloat16), (6, 3, 12, 16, 8, torch.bfloat16)]
CARD_CASES += [
    (G, heads, L, P, N, dtype)
    for i, L in enumerate((1, 8, 31, 32, 33, 63, 64, 65, 200, 256))
    for G, heads, P, N, dtype in (
        (8 * (1, 2, 4, 32)[i % 4], (1, 2, 4, 32)[i % 4], (16, 64)[i % 2],
         (8, 16, 128)[i % 3], (torch.float32, torch.bfloat16)[i % 2]),
        (4 * (4, 1, 2)[i % 3], (4, 1, 2)[i % 3], (64, 16)[i % 2],
         (128, 8, 16)[i % 3], (torch.bfloat16, torch.float32)[i % 2]))]


@pytest.mark.cuda
@pytest.mark.parametrize("route", [None, 1, 2])
@pytest.mark.parametrize("G,heads,L,P,N,dtype", CARD_CASES)
def test_backward_kernel_matches_plain_on_card(card, G, heads, L, P, N,
                                               dtype, route):
    """The CUDA backward against the plain backward on the same card
    tensors (1e-5 at L <= 8, 1e-4 above, as phase 27), launched once, the
    plain backward not counted as a path's: on the route the shape picks
    (through the Function's route) and on each route forced, route 2
    where its shared memory fits; the same bits on a second launch."""
    if route == 2 and K.small_smem_bytes(L, P, N) > K.SMEM_MAX:
        pytest.skip("route 2's shared memory does not fit this shape")
    ins, cot = _cells(G, heads, L, P, N, 31, dtype)
    ins = [t.to(card) for t in ins]
    cot = [t.to(card) for t in cot]

    def run():
        if route is None:
            return K._intra_chunk_bwd(*ins, *cot, heads)
        dx, db, dc, dcum = K._ssd_intra_chunk_bwd_cuda(*ins, *cot, heads,
                                                       route=route)
        return dx, db.to(dtype), dc.to(dtype), dcum
    before = K.BWD_LAUNCHES
    got = run()
    assert K.BWD_LAUNCHES == before + 1
    want = K.ssd_intra_chunk_bwd_plain(*ins, *cot, heads)
    torch.cuda.synchronize()
    tol = 1e-5 if L <= 8 else 1e-4
    _close_grads(got, want, bf16=dtype == torch.bfloat16, tol=tol)
    again = run()
    for a, b in zip(got, again):
        assert torch.equal(a, b), "the backward is not the same run to run"
