"""The threshold channel: the port's in-graph primitives and kernel B's
channel form against the JAX package's, on the CPU.

The JAX side runs under ``jax.jit``, as the cohort trainer and
``ThresholdGraphCodec.encode`` run it: XLA turns each division by a
constant into a product with its f32 reciprocal (the kept fraction
``count * f32(1/n)``, the value ``(level * scale) * f32(1/L)``), and the
port computes the same expressions.  Everything here is exact (tolerance
zero, compared as bit patterns).  The CUDA kernel runs only on a card:
its test carries the ``cuda`` marker and skips here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.core.codecs import ThresholdGraphCodec as JThresholdGraphCodec
from repro.core.dynamic import DEFAULT_SET_Q, DEFAULT_SET_S
from repro_torch.core import compression as tcomp
from repro_torch.core.codecs import ThresholdGraphCodec
from repro_torch.kernels import topk_quant as ttq
from repro_torch.kernels.ops import threshold_channel_leaves

from torch_threads import one_torch_thread  # noqa: F401

CNN_SHAPES = {"b1": (32,), "b2": (32,), "bf1": (128,), "bf2": (10,),
              "conv1": (2, 2, 1, 32), "conv2": (2, 2, 32, 32),
              "fc1": (1568, 128), "fc2": (128, 10)}


def _bits(a):
    """f32 bit patterns of a numpy, JAX or torch array (bf16 widened)."""
    if isinstance(a, torch.Tensor):
        a = a.to(torch.float32).numpy()
    else:
        a = np.asarray(jnp.asarray(a).astype(jnp.float32))
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _same_bits(a, b):
    """Two tensors of one dtype hold the same bit patterns."""
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def _input(seed, shape=(37, 29)):
    """Normal values at scale 0.05, every 7th of magnitude 1/16 (ties)."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 0.05).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = np.float32(0.0625) * rng.choice([-1, 1], flat[::7].size)
    return x


def _cnn_stack(c, seed):
    """The CNN's 8 leaves stacked over ``c`` devices, with ties in conv2."""
    rng = np.random.RandomState(seed)
    tree = {k: (rng.randn(c, *s) * 0.05).astype(np.float32)
            for k, s in CNN_SHAPES.items()}
    tree["conv2"] = np.round(tree["conv2"] * 64) / 64
    return tree


# ----------------------------------------------------------------------
# in-graph primitives
# ----------------------------------------------------------------------
@pytest.mark.parametrize("p_s", DEFAULT_SET_S)
def test_in_graph_primitives_match_jitted_jax(p_s):
    """sparsify_quantize_threshold over Set_q x iters {12, 6} (f32 and
    bf16) and sparsify_quantize_dense over Set_q, bit for bit with the
    jitted JAX functions; p_s = 1 and p_q = 32 take the reference's own
    branches."""
    x = _input(int(p_s * 100))
    points = [(p_q, iters) for p_q in DEFAULT_SET_Q for iters in (12, 6)]

    def jax_all(x32, x16):
        out = [jcomp.sparsify_quantize_threshold(xx, p_s, p_q, iters)
               for p_q, iters in points for xx in (x32, x16)]
        return out + [jcomp.sparsify_quantize_dense(x32, p_s, p_q)
                      for p_q in DEFAULT_SET_Q]

    want = jax.jit(jax_all)(jnp.asarray(x), jnp.asarray(x, jnp.bfloat16))
    tx = torch.from_numpy(x)
    got = [tcomp.sparsify_quantize_threshold(xx, p_s, p_q, iters)
           for p_q, iters in points for xx in (tx, tx.to(torch.bfloat16))]
    got += [tcomp.sparsify_quantize_dense(tx, p_s, p_q)
            for p_q in DEFAULT_SET_Q]
    assert len(got) == len(want) == 20
    for i, (w, g) in enumerate(zip(want, got)):
        bf16 = i < 16 and i % 2 == 1
        assert g.dtype == (torch.bfloat16 if bf16 else torch.float32)
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=str(i))
    if p_s >= 1.0:            # nothing sparsified, nothing quantized: x
        assert tcomp.sparsify_quantize_threshold(tx, 1.0, 32) is tx


def test_in_graph_pieces_match_jitted_jax():
    """topk_mask (ties kept by >=), quantize_levels, dequantize_levels and
    approx_topk_threshold one by one, f32 and bf16."""
    x = _input(5)
    for dt in ("float32", "bfloat16"):
        jx = jnp.asarray(x).astype(dt)
        tx = torch.from_numpy(x).to(getattr(torch, dt))
        for p_s in (0.01, 0.1, 0.5, 1.0):
            want = jax.jit(jcomp.topk_mask, static_argnums=1)(jx, p_s)
            np.testing.assert_array_equal(tcomp.topk_mask(tx, p_s).numpy(),
                                          np.asarray(want))
        for bits in (2, 4, 8, 16, 32):
            jl, js = jax.jit(jcomp.quantize_levels,
                             static_argnums=1)(jx, bits)
            tl, ts = tcomp.quantize_levels(tx, bits)
            np.testing.assert_array_equal(_bits(tl), _bits(jl))
            np.testing.assert_array_equal(_bits(ts), _bits(js))
            jd = jax.jit(jcomp.dequantize_levels, static_argnums=2)(
                jl, js, bits)
            np.testing.assert_array_equal(
                _bits(tcomp.dequantize_levels(tl, ts, bits)), _bits(jd))
    ax = np.abs(x)
    for p_s, iters in ((0.25, 12), (0.05, 6), (0.5, 0)):
        want = jax.jit(jcomp.approx_topk_threshold,
                       static_argnums=(1, 2))(jnp.asarray(ax), p_s, iters)
        got = tcomp.approx_topk_threshold(torch.from_numpy(ax), p_s, iters)
        assert got.shape == () and _bits(got) == _bits(want)
    # with a key the rounding is stochastic: each level is floor(y) or
    # floor(y) + 1 of y = x / scale * L (its distribution is held in
    # tests/test_torch_fed_step.py)
    tx = torch.from_numpy(x)
    lv, sc = tcomp.quantize_levels(tx, 8, key=torch.Generator().manual_seed(0))
    low = torch.floor(tx / sc * 127)
    assert bool(((lv == low) | (lv == low + 1)).all())


# ----------------------------------------------------------------------
# the channel form: plain version, launch plan, kernel emulation
# ----------------------------------------------------------------------
@pytest.mark.parametrize("c", [1, 3, 8])
def test_threshold_channel_plain_matches_jitted_vmap(c):
    """The cohort trainer's channel on the CNN's leaves stacked over C
    devices: ``threshold_channel_leaves`` on CPU tensors equals
    ``jax.jit(jax.vmap(ThresholdGraphCodec(...).apply_tree))`` bit for
    bit, so masks and values are identical."""
    tree = _cnn_stack(c, c)
    names = sorted(tree)
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    xs = [torch.from_numpy(tree[k]) for k in names]
    points = ((0.25, 8, 12), (0.1, 4, 6), (1.0, 8, 12), (0.05, 32, 12),
              (0.5, 16, 12))
    wants = jax.jit(lambda t: [
        jax.vmap(JThresholdGraphCodec(*pt).apply_tree)(t)
        for pt in points])(jt)
    for (p_s, p_q, iters), want in zip(points, wants):
        before = ttq.LAUNCHES
        got = threshold_channel_leaves(xs, p_s, p_q, iters)
        assert ttq.LAUNCHES == before            # CPU: the plain version
        for k, g in zip(names, got):
            assert g.shape == tree[k].shape and g.dtype == torch.float32
            np.testing.assert_array_equal(
                _bits(g), _bits(want[k]), err_msg=f"{k} {(p_s, p_q, iters)}")
    # (1, 32): the leaves themselves, no copy
    assert all(a is b for a, b in zip(
        threshold_channel_leaves(xs, 1.0, 32), xs))


def test_threshold_codec_matches_jax_encode():
    """ThresholdGraphCodec on one (unstacked) dict, as the serial trainer
    runs it: each leaf one row, equal to the JAX codec's jitted encode,
    and the same wire size."""
    tree = {k: v[0] for k, v in _cnn_stack(1, 4).items()}
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    for p_s, p_q in ((0.25, 8), (0.01, 2), (1.0, 16)):
        jw = JThresholdGraphCodec(p_s, p_q, 12).encode(
            {k: jnp.asarray(v) for k, v in tree.items()})
        tw = ThresholdGraphCodec(p_s, p_q, 12).encode(ttree, rng=None)
        assert tw.nbytes == jw.nbytes
        for k in tree:
            assert tw.payload[k].shape == tree[k].shape
            np.testing.assert_array_equal(_bits(tw.payload[k]),
                                          _bits(jw.payload[k]))


@pytest.mark.parametrize("row_len", [1, 10, 32, 128, 1280, 4096, 60001,
                                     200704])
@pytest.mark.parametrize("p_s", [0.01, 0.05, 0.1, 1 / 3, 0.5, 0.9])
def test_channel_need_is_the_reciprocal_rule(row_len, p_s):
    """The kernel decides count >= need: the same decision as XLA's
    ``f32(count) * f32(1/n) > p_s`` for every count around need and at the
    ends."""
    need = ttq.channel_need(row_len, p_s)
    r, ps = np.float32(1) / np.float32(row_len), np.float32(p_s)
    counts = {0, row_len, need - 2, need - 1, need, need + 1}
    for c in sorted(c for c in counts if 0 <= c <= row_len):
        assert (c >= need) == bool(np.float32(np.float32(c) * r) > ps), c


def test_channel_plan_groups_by_cluster_size():
    """The CNN's 8 leaves take 2 launches: the seven small ones one CTA a
    row, fc1's rows on 8-CTA clusters; a ragged list takes one launch per
    cluster size (and per MAX_LEAVES leaves), each leaf once, its rows
    consecutive from its first."""
    names = sorted(CNN_SHAPES)
    lens = [int(np.prod(CNN_SHAPES[k])) for k in names]
    plan = ttq.channel_plan(lens, [8] * len(lens))
    assert [(s, [names[i] for i in part]) for s, part, _, _ in plan] == [
        (1, [k for k in names if k != "fc1"]), (8, ["fc1"])]
    assert plan[0][2] == [0, 8, 16, 24, 32, 40, 48] and plan[0][3] == 56
    assert plan[1][2:] == ([0], 8)
    lens = [5, 4097, 131073, 8192, 3, 12288] + [7] * (ttq.MAX_LEAVES + 2)
    rows = [3, 1, 2, 4, 1, 2] + [1] * (ttq.MAX_LEAVES + 2)
    plan = ttq.channel_plan(lens, rows)
    assert [s for s, _, _, _ in plan] == [1, 1, 2, 3, 8]
    seen = sorted(i for _, part, _, _ in plan for i in part)
    assert seen == list(range(len(lens)))
    for slices, part, firsts, total in plan:
        assert len(part) <= ttq.MAX_LEAVES
        assert all(ttq.slices_for(lens[i]) == slices for i in part)
        assert firsts == list(np.cumsum([0] + [rows[i] for i in part])[:-1])
        assert total == sum(rows[i] for i in part)


def _emulate_launch(xs, outs, part, firsts, total, slices, p_s, p_q, iters):
    """One channel-form launch of csrc/topk_quant.cu in numpy f32: each of
    its ``total`` rows finds its leaf by the kernel's search over the
    first rows, takes its row of the leaf's own length, the max over the
    cluster's slices, 8 bisection steps a pass decided by count >= need
    (the midpoints by the sequential recursion), then writes the
    dequantized value into the leaf's output."""
    keep_all = p_s >= 1.0
    for row in range(total):
        lf = 0
        step = ttq.MAX_LEAVES // 2
        while step:
            if lf + step < len(part) and firsts[lf + step] <= row:
                lf += step
            step //= 2
        x = xs[part[lf]].reshape(-1)
        n = x.size // xs[part[lf]].shape[0]
        start = (row - firsts[lf]) * n
        seg = x[start:start + n].astype(np.float32)
        ax = np.abs(seg)
        size = n if slices == 1 else (-(-n // slices) + 3) // 4 * 4
        amax = np.float32(max(float(ax[r * size:(r + 1) * size].max())
                              if ax[r * size:(r + 1) * size].size else 0.0
                              for r in range(slices)))
        need = ttq.channel_need(n, p_s) if not keep_all else 0
        lo, hi = np.float32(0), np.float32(amax + np.float32(1e-12))
        done = 0 if not keep_all else iters
        while done < iters:
            depth = min(8, iters - done)
            nb = 1 << depth
            mids = np.zeros(nb + 1, np.float32)
            mids[0], mids[nb] = lo, hi
            stride = nb
            while stride > 1:
                half = stride >> 1
                for j in range(half, nb, stride):
                    mids[j] = np.float32(np.float32(0.5) * np.float32(
                        mids[j - half] + mids[j + half]))
                stride = half
            counts = np.array([(ax >= m).sum() for m in mids[1:nb]])
            k = int((counts >= need).sum())
            lo, hi = mids[k], mids[k + 1]
            done += depth
        thr = np.float32(0) if keep_all else np.float32(
            np.float32(0.5) * np.float32(lo + hi))
        scale = np.float32(max(amax if amax >= thr else np.float32(0),
                               np.float32(1e-12)))
        keep = ax >= thr
        if p_q >= 32:
            val = np.where(keep, seg, np.float32(0))
        else:
            L = np.float32(2 ** (p_q - 1) - 1)
            q = np.clip(np.round(np.float32(np.float32(seg / scale) * L)),
                        -L, L)
            inv_l = np.float32(1) / L
            val = np.where(keep, np.float32(np.float32(q * scale) * inv_l),
                           np.float32(0))
        out = outs[part[lf]].reshape(-1)
        assert np.all(np.isnan(out[start:start + n]))     # written once
        out[start:start + n] = val


@pytest.mark.parametrize("point", [(0.25, 8, 12), (0.05, 4, 6),
                                   (1.0, 16, 12), (0.1, 32, 12)])
def test_channel_launch_plan_emulation_gives_the_plain_channel(point):
    """The kernel's launch plan, row search, offsets and needs, emulated
    in numpy over a ragged list (3 cluster sizes, ties in the large row),
    write every value once and give the plain channel bit for bit."""
    p_s, p_q, iters = point
    rng = np.random.RandomState(int(p_s * 1000) + p_q)
    big = rng.choice(np.float32([0.5, -0.5, 0.25, -0.25, 0.0]), (2, 9001))
    xs = [(rng.randn(3, 40) * 0.1).astype(np.float32), big,
          (rng.randn(2, 5000) * 0.1).astype(np.float32),
          (rng.randn(4, 2, 5) * 0.1).astype(np.float32)]
    outs = [np.full(x.shape, np.nan, np.float32) for x in xs]
    lens = [x.size // x.shape[0] for x in xs]
    plan = ttq.channel_plan(lens, [x.shape[0] for x in xs])
    assert sorted(s for s, _, _, _ in plan) == [1, 2, 3]
    for slices, part, firsts, total in plan:
        _emulate_launch(xs, outs, part, firsts, total, slices, p_s, p_q,
                        iters)
    want = ttq.threshold_channel_plain([torch.from_numpy(x) for x in xs],
                                       p_s, p_q, iters)
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o.view(np.uint32), _bits(w))


def test_threshold_channel_refuses_bad_arguments():
    x = torch.zeros(2, 10)
    with pytest.raises(ValueError):
        threshold_channel_leaves([x, x.to(torch.bfloat16)], 0.25, 8)
    with pytest.raises(ValueError):
        threshold_channel_leaves([x], 0.25, 17)
    with pytest.raises(TypeError):
        threshold_channel_leaves([x.double()], 0.25, 8)
    with pytest.raises(ValueError):
        threshold_channel_leaves([], 0.25, 8)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.mark.cuda
def test_threshold_channel_wire_matches_plain_on_card():
    """The channel form's wire on the card (the federated round's mesh
    compressor): values, int8 levels and f32 scales bit-identical to the
    plain version's, the CNN's leaves over C = 1 and 8 devices, p_q 8 and
    4, over Set_s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the "
                    "card (python3 chip_smoke.py drives them there)")
    for c in (1, 8):
        tree = _cnn_stack(c, 40 + c)
        xs = [torch.from_numpy(tree[k]).cuda() for k in sorted(tree)]
        for p_s in DEFAULT_SET_S:
            for p_q in (8, 4):
                got = threshold_channel_leaves(xs, p_s, p_q, 12, wire=True)
                want = ttq.threshold_channel_plain(xs, p_s, p_q, 12,
                                                   wire=True)
                for part, (g, w) in enumerate(zip(got, want)):
                    for a, b in zip(g, w):
                        same = torch.equal(a, b) if part == 1 else \
                            _same_bits(a, b)
                        assert same, (c, p_s, p_q, part)


@pytest.mark.cuda
def test_threshold_channel_kernel_matches_plain_on_card():
    """The channel form on the card against its plain version on the same
    inputs: the CNN's leaves over C = 1, 8 and 16 devices at every
    (p_s, p_q) of Set_s x Set_q, iters 12 and 6, f32 and bf16; at most 2
    launches per application for the CNN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the "
                    "card (python3 chip_smoke.py drives them there)")
    for c in (1, 8, 16):
        tree = _cnn_stack(c, 20 + c)
        for dtype in (torch.float32, torch.bfloat16):
            xs = [torch.from_numpy(tree[k]).cuda().to(dtype)
                  for k in sorted(tree)]
            for p_s in DEFAULT_SET_S:
                for p_q in DEFAULT_SET_Q:
                    for iters in (12, 6):
                        before = ttq.LAUNCHES
                        got = threshold_channel_leaves(xs, p_s, p_q, iters)
                        n = ttq.LAUNCHES - before
                        assert n == (0 if (p_s, p_q) == (1.0, 32) else 2)
                        want = ttq.threshold_channel_plain(xs, p_s, p_q,
                                                           iters)
                        for g, w in zip(got, want):
                            assert _same_bits(g, w), (c, dtype, p_s, p_q,
                                                      iters)
