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
@pytest.mark.parametrize("c", [1, 3, 8, "2x400000"])
def test_threshold_channel_plain_matches_jitted_vmap(c):
    """The cohort trainer's channel on the CNN's leaves stacked over C
    devices (and on 2 rows of 400,000 values, past the wide route's
    boundary): ``threshold_channel_leaves`` on CPU tensors equals
    ``jax.jit(jax.vmap(ThresholdGraphCodec(...).apply_tree))`` bit for
    bit, so masks and values are identical."""
    if c == "2x400000":
        assert 400_000 >= ttq.WIDE_MIN
        tree = {"w": _input(400, (2, 400_000))}
    else:
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


def test_kept_fraction_past_2_24_is_not_the_exact_count_under_jit():
    """Where the channel form's bit-exact claim ends.  Past 2^24 kept
    values the reference's jitted mean of the mask (an f32 sum) is not the
    count, so near the need it can decide otherwise than the port's exact
    count (``channel_need``).  On a row of 18,000,000 values at p_s = 0.99
    (need 17,820,002 > 2^24; the kept positions from a seeded
    permutation) the jitted mean keeps at one below the need, where the
    port does not; the same construction under 2^24 (16,000,000 values,
    need 15,840,001) decides as the port at every count around the need.
    The smallest row found: at 17,000,000 values (p_s 0.99) and
    16,800,000 (p_s 0.9995) no count within 3 of the need disagreed; at
    20,000,000 (p_s 0.9) one did."""
    mean = jax.jit(lambda m: jnp.mean(m.astype(jnp.float32)))
    total = jax.jit(lambda m: jnp.sum(m.astype(jnp.float32)))

    def decisions(n, p_s, counts):
        need = ttq.channel_need(n, p_s)
        perm = np.random.default_rng(0).permutation(n)
        mask = np.zeros(n, bool)
        out = []
        for d in counts:
            mask[perm[:need + d]] = True
            jax_keeps = bool(np.float32(mean(mask)) > np.float32(p_s))
            out.append((need + d, float(total(mask)), jax_keeps,
                        need + d >= need))
        return need, out

    need, past = decisions(18_000_000, 0.99, (-2, -1, 0))
    assert need > 2 ** 24
    (_, _, jk2, pk2), (c1, s1, jk1, pk1), (_, _, jk0, pk0) = past
    assert s1 != c1                          # the f32 sum is not the count
    assert jk1 and not pk1                   # the reference keeps, the port
    assert (jk2, pk2) == (False, False)      # does not; around it both
    assert (jk0, pk0) == (True, True)        # decide alike
    need, under = decisions(16_000_000, 0.99, (-2, -1, 0, 1))
    assert need <= 2 ** 24
    assert all(s == c and jk == pk for c, s, jk, pk in under)


def test_channel_plan_groups_by_cluster_size():
    """The CNN's 8 leaves take 2 launches: the seven small ones one CTA a
    row, fc1's rows on 8-CTA clusters; a ragged list takes one launch per
    cluster size (and per MAX_LEAVES leaves), each leaf once, its rows
    consecutive from its first."""
    names = sorted(CNN_SHAPES)
    lens = [int(np.prod(CNN_SHAPES[k])) for k in names]
    plan = ttq.channel_plan(lens, [8] * len(lens))
    assert [(e.slices, [names[i] for i in e.part]) for e in plan] == [
        (1, [k for k in names if k != "fc1"]), (8, ["fc1"])]
    assert plan[0].firsts == [0, 8, 16, 24, 32, 40, 48] and plan[0].rows == 56
    assert (plan[1].firsts, plan[1].rows) == ([0], 8)
    lens = [5, 4097, 131073, 8192, 3, 12288] + [7] * (ttq.MAX_LEAVES + 2)
    rows = [3, 1, 2, 4, 1, 2] + [1] * (ttq.MAX_LEAVES + 2)
    plan = ttq.channel_plan(lens, rows)
    assert [e.slices for e in plan] == [1, 1, 2, 3, 8]
    seen = sorted(i for e in plan for i in e.part)
    assert seen == list(range(len(lens)))
    for slices, part, firsts, total, *_ in plan:
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
    assert sorted(e.slices for e in plan) == [1, 2, 3]
    for e in plan:
        _emulate_launch(xs, outs, e.part, e.firsts, e.rows, e.slices, p_s,
                        p_q, iters)
    want = ttq.threshold_channel_plain([torch.from_numpy(x) for x in xs],
                                       p_s, p_q, iters)
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o.view(np.uint32), _bits(w))


# the wide route: rows of at least ``wide_min`` values, tiles of ``tile``
@pytest.mark.parametrize("tile", [1000, 4096, None])
def test_channel_plan_wide_entries_tile_each_row_once(tile):
    """Rows of at least ``wide_min`` values go to wide entries, one per
    group of ``MAX_LEAVES`` leaves, after the cluster entries, each with
    the tile asked for (by default ``wide_tile_len`` of its values); the
    kernel's search over the first tiles gives every CTA one tile, and the
    tiles cover each row exactly once; each wide entry's rows of the
    workspace are its own."""
    wide_min = 5000
    lens = [40, 9001, 5000, 4999, 12289, 6000] + [7000] * (ttq.MAX_LEAVES
                                                           + 1)
    rows = [3, 2, 2, 4, 1, 3] + [1] * (ttq.MAX_LEAVES + 1)
    plan = ttq.channel_plan(lens, rows, tile, wide_min)
    wide = [e for e in plan if e.slices == ttq.WIDE]
    assert [e.slices for e in plan] == [1, 2, ttq.WIDE, ttq.WIDE]
    assert sorted(i for e in wide for i in e.part) == [
        i for i, n in enumerate(lens) if n >= wide_min]
    assert all(ttq.slices_for(lens[i]) == e.slices
               for e in plan if e.slices != ttq.WIDE for i in e.part)
    ws = []
    for e in wide:
        assert len(e.part) <= ttq.MAX_LEAVES
        assert e.tile == (tile or ttq.wide_tile_len(
            sum(rows[i] * lens[i] for i in e.part)))
        assert e.tiles == sum(rows[i] * -(-lens[i] // e.tile)
                              for i in e.part)
        spans = {}
        for b in range(e.tiles):
            lf, row, g0, n = _wide_tile(e, [lens[i] for i in e.part], b)
            assert e.firsts[lf] <= row < e.firsts[lf] + rows[e.part[lf]]
            spans.setdefault(e.part[lf], []).append((g0, n))
        for i in e.part:
            cover = sorted(spans[i])
            assert cover[0][0] == 0 and all(
                a + n == b for (a, n), (b, _) in zip(cover, cover[1:]))
            assert sum(n for _, n in cover) == rows[i] * lens[i]
            assert all(0 < n <= e.tile for _, n in cover)
        ws.append((e.ws_row, e.ws_row + e.rows))
    assert ws == sorted(ws) and ws[0][0] == 0 and all(
        a[1] == b[0] for a, b in zip(ws, ws[1:]))     # disjoint, packed
    assert ws[-1][1] == sum(e.rows for e in wide)


@pytest.mark.parametrize("values, tile", [
    (1, 8192), (2 ** 19, 8192), (2 ** 21, 8192), (2 ** 21 + 1, 16384),
    (2 ** 23, 32768), (2 ** 25, 131072), (2 ** 27, 131072),
    (538_060_032, 131072)])
def test_wide_tile_len_is_a_256th_of_the_entry(values, tile):
    """The wide route's default tile: the power of two at or above a
    256th of the entry's values (about one CTA a slot of the card), from
    8,192 to 131,072 values (the sweep of chip_smoke.py phase 35)."""
    assert ttq.wide_tile_len(values) == tile


def test_channel_plan_refuses_rows_past_the_kernels_limits():
    """Rows of 2^31 values or more, and wide launches of 2^31 tiles or
    more, are a ValueError naming the limit."""
    with pytest.raises(ValueError, match="2\\^31"):
        ttq.channel_plan([2 ** 31], [1])
    with pytest.raises(ValueError, match="2\\^31 tiles"):
        ttq.channel_plan([2 ** 30], [4], tile=1)
    with pytest.raises(ValueError, match="tile"):
        ttq.channel_plan([10], [1], tile=0)


def _wide_tile(entry, lens, b):
    """CTA ``b`` of a wide entry as topk_quant.cu::wide_tile finds it: (its
    leaf in the entry, its row in the entry, its first value in the leaf,
    its length)."""
    lf, step = 0, ttq.MAX_LEAVES // 2
    while step:
        if lf + step < len(entry.part) and entry.tile_firsts[lf + step] <= b:
            lf += step
        step //= 2
    n, tile = lens[lf], entry.tile
    r, t = divmod(b - entry.tile_firsts[lf], -(-n // tile))
    return lf, entry.firsts[lf] + r, r * n + t * tile, min(tile, n - t * tile)


def _channel_values(seg, thr, scale, p_q):
    """The channel form's value and level of each of ``seg`` (f32) at
    (thr, scale), as csrc/topk_quant.cu::channel_value writes them."""
    keep = np.abs(seg) >= thr
    if p_q >= 32:
        return np.where(keep, seg, np.float32(0)), np.zeros_like(seg)
    L = np.float32(2 ** (p_q - 1) - 1)
    q = np.clip(np.round(np.float32(np.float32(seg / scale) * L)), -L, L)
    val = np.where(keep, np.float32(np.float32(q * scale) * (np.float32(1)
                                                             / L)),
                   np.float32(0))
    return val, np.where(keep, q, np.float32(0))


def _emulate_wide(xs, outs, lvls, scales, entry, p_s, p_q, iters):
    """One wide entry of csrc/topk_quant.cu in numpy f32: every CTA's tile
    found by the kernel's search, the row's max merged from the tiles'
    maxima, 12 bisection steps a pass (its 4,095 midpoints by the
    sequential recursion), each pass's bins summed over the tiles (each
    tile binned by the number of midpoints <= |x| in [lo, hi), |x| >= hi
    in the last bin), K from the row's sums, then each tile's values (and
    the wire) from the row's final (lo, hi)."""
    keep_all = p_s >= 1.0
    lens = [xs[i].size // xs[i].shape[0] for i in entry.part]
    tiles = [_wide_tile(entry, lens, b) for b in range(entry.tiles)]

    def seg(lf, g0, n):
        return xs[entry.part[lf]].reshape(-1)[g0:g0 + n].astype(np.float32)
    amax = np.zeros(entry.rows, np.float32)
    for lf, row, g0, n in tiles:
        amax[row] = max(amax[row], np.abs(seg(lf, g0, n)).max())
    lo = np.zeros(entry.rows, np.float32)
    hi = (amax + np.float32(1e-12)).astype(np.float32)
    done = iters if keep_all else 0
    while done < iters:
        depth = min(ttq.WIDE_BITS, iters - done)
        nb = 1 << depth
        mids = []
        for r in range(entry.rows):
            m = np.zeros(nb + 1, np.float32)
            m[0], m[nb] = lo[r], hi[r]
            stride = nb
            while stride > 1:
                half = stride >> 1
                m[half:nb:stride] = np.float32(0.5) * (
                    m[0:nb - half:stride] + m[stride:nb + 1:stride])
                stride = half
            mids.append(m)
        bins = np.zeros((entry.rows, nb), np.int64)
        for lf, row, g0, n in tiles:          # each CTA's histogram
            a = np.abs(seg(lf, g0, n))
            inside = a[(a >= lo[row]) & (a < hi[row])]
            t = np.searchsorted(mids[row][1:nb], inside, side="right")
            np.add.at(bins[row], t[t > 0], 1)
            bins[row, nb - 1] += int((a >= hi[row]).sum())
        for r in range(entry.rows):           # the last CTA's decision
            lf = max(j for j, f in enumerate(entry.firsts) if f <= r)
            need = ttq.channel_need(lens[lf], p_s)
            counts = np.cumsum(bins[r][::-1])[::-1][1:]
            k = int((counts >= need).sum())
            lo[r], hi[r] = mids[r][k], mids[r][k + 1]
        done += depth
    for lf, row, g0, n in tiles:              # the store
        thr = np.float32(0) if keep_all else np.float32(
            np.float32(0.5) * np.float32(lo[row] + hi[row]))
        scale = np.float32(max(amax[row] if amax[row] >= thr
                               else np.float32(0), np.float32(1e-12)))
        val, q = _channel_values(seg(lf, g0, n), thr, scale, p_q)
        out = outs[entry.part[lf]].reshape(-1)
        assert np.all(np.isnan(out[g0:g0 + n]))       # written once
        out[g0:g0 + n] = val
        if lvls is not None:
            lvls[entry.part[lf]].reshape(-1)[g0:g0 + n] = q
            scales[entry.part[lf]][row - entry.firsts[lf]] = scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("point", [(0.25, 8, 12), (0.05, 4, 6),
                                   (1.0, 16, 12), (0.1, 32, 12),
                                   (0.5, 8, 16)])
def test_channel_wide_route_emulation_gives_the_plain_channel(point, dtype):
    """Both routes of the kernel's plan at a small tile over a ragged list
    (cluster rows of 1 and 2 CTAs; wide rows of ties and of normal values,
    one exactly at the boundary, ragged last tiles), emulated in numpy:
    every value written once, bit for bit the plain channel's, and at
    p_q <= 8 the wire's levels and scales too."""
    p_s, p_q, iters = point
    tile, wide_min = 1000, 6000
    rng = np.random.RandomState(int(p_s * 1000) + p_q + 7)
    xs = [(rng.randn(3, 40) * 0.1).astype(np.float32),
          rng.choice(np.float32([0.5, -0.5, 0.25, -0.25, 0.0]), (2, 9001)),
          (rng.randn(2, 5000) * 0.1).astype(np.float32),
          (rng.randn(4, 2, 5) * 0.1).astype(np.float32),
          (rng.randn(1, 12289) * 0.1).astype(np.float32),
          (rng.randn(3, 6000) * 0.1).astype(np.float32)]
    ts = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs]
    xs = [t.to(torch.float32).numpy() for t in ts]     # the values read
    outs = [np.full(x.shape, np.nan, np.float32) for x in xs]
    wire = p_q <= 8
    lvls = [np.full(x.shape, np.nan, np.float32) for x in xs] if wire \
        else None
    scales = [np.full(x.shape[0], np.nan, np.float32) for x in xs]
    plan = ttq.channel_plan([x.size // x.shape[0] for x in xs],
                            [x.shape[0] for x in xs], tile, wide_min)
    assert [e.slices for e in plan] == [1, 2, ttq.WIDE]
    assert plan[-1].part == [1, 4, 5]
    for e in plan:
        if e.slices == ttq.WIDE:
            _emulate_wide(xs, outs, lvls, scales, e, p_s, p_q, iters)
        else:
            _emulate_launch(xs, outs, e.part, e.firsts, e.rows, e.slices,
                            p_s, p_q, iters)
    want = ttq.threshold_channel_plain(ts, p_s, p_q, iters, wire=wire)
    vals = want[0] if wire else want
    for o, w, t in zip(outs, vals, ts):
        assert not np.isnan(o).any()
        got = torch.from_numpy(o).to(t.dtype)
        assert _same_bits(got, w)
    if wire:
        for i in plan[-1].part:        # the wide rows' wire
            np.testing.assert_array_equal(lvls[i].astype(np.int8),
                                          want[1][i].numpy())
            np.testing.assert_array_equal(scales[i].view(np.uint32),
                                          _bits(want[2][i]))


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
def _long_rows(seed, dtype):
    """Rows for both routes on the card: a wide leaf of 2 rows just past
    the boundary, one of a row of 3,000,001 values (ragged tiles, an odd
    row start), a cluster leaf of 8-CTA rows and one of 1-CTA rows."""
    shapes = [(2, ttq.WIDE_MIN + 3), (1, 3_000_001), (4, 200_704), (4, 576)]
    return [torch.from_numpy(_input(seed + i, s)).cuda().to(dtype)
            for i, s in enumerate(shapes)]


def _card_inputs(seed):
    """(what, leaves, launches a call) on the card: the CNN's leaves over
    C = 1 and 8 devices in f32 and bf16, and the long rows."""
    for c in (1, 8):
        tree = _cnn_stack(c, seed + c)
        for dtype in (torch.float32, torch.bfloat16):
            yield ((c, dtype), [torch.from_numpy(tree[k]).cuda().to(dtype)
                                for k in sorted(tree)], 2)
    for dtype in (torch.float32, torch.bfloat16):
        xs = _long_rows(seed, dtype)
        n = len(ttq.channel_plan([x[0].numel() for x in xs],
                                 [x.shape[0] for x in xs]))
        yield (("long rows", dtype), xs, n)


@pytest.mark.cuda
def test_threshold_channel_wire_matches_plain_on_card():
    """The channel form's wire on the card (the federated round's mesh
    compressor): values, int8 levels and f32 scales bit-identical to the
    plain version's, the CNN's leaves over C = 1 and 8 devices and the
    long rows of both routes, f32 and bf16, p_q 8 and 4, over Set_s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the "
                    "card (python3 chip_smoke.py drives them there)")
    for what, xs, _ in _card_inputs(40):
        for p_s in DEFAULT_SET_S:
            for p_q in (8, 4):
                got = threshold_channel_leaves(xs, p_s, p_q, 12, wire=True)
                want = ttq.threshold_channel_plain(xs, p_s, p_q, 12,
                                                   wire=True)
                for part, (g, w) in enumerate(zip(got, want)):
                    for a, b in zip(g, w):
                        same = torch.equal(a, b) if part == 1 else \
                            _same_bits(a, b)
                        assert same, (what, p_s, p_q, part)


@pytest.mark.cuda
def test_threshold_channel_kernel_matches_plain_on_card():
    """The channel form on the card against its plain version on the same
    inputs: the CNN's leaves over C = 1, 8 and 16 devices at every
    (p_s, p_q) of Set_s x Set_q, iters 12 and 6, f32 and bf16 (at most 2
    launches per application for the CNN), and the long rows of both
    routes at iters 0, 5, 12 and 16 (one launch per plan entry)."""
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
    for what, xs, launches in list(_card_inputs(60))[4:]:
        for p_s, p_q in ((0.25, 8), (0.05, 16), (1.0, 4), (0.5, 32)):
            for iters in (0, 5, 12, 16):
                before = ttq.LAUNCHES
                got = threshold_channel_leaves(xs, p_s, p_q, iters)
                assert ttq.LAUNCHES - before == launches
                want = ttq.threshold_channel_plain(xs, p_s, p_q, iters)
                for g, w in zip(got, want):
                    assert _same_bits(g, w), (what, p_s, p_q, iters)
