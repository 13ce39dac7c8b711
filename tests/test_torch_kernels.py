"""The port's kernels against the JAX package's, on the CPU.

On the CPU the port's wrappers run the plain PyTorch versions of its CUDA
kernels; the JAX side runs its Pallas kernels in interpret mode, as
tests/test_kernels.py does.  Both kernels are exact: streams byte for
byte, levels and scales bit for bit (tolerance zero).  The CUDA kernels
themselves run only on a card: those tests carry the ``cuda`` marker and
skip here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dynamic import DEFAULT_SET_Q, DEFAULT_SET_S
from repro.kernels.fused_pack import fused_pack_leaf as jax_fused_pack_leaf
from repro.kernels.fused_pack import pack_leaves_host
from repro.kernels.ops import compress_roundtrip as jax_compress_roundtrip
from repro.kernels.topk_quant import topk_quant as jax_topk_quant
from repro_torch.core.compression import index_bits, topk_count
from repro_torch.kernels import fused_pack as tfp
from repro_torch.kernels.bitpack import words_to_bytes
from repro_torch.kernels import topk_quant as ttq
from repro_torch.kernels.fused_pack import (concat_bitstreams,
                                            fused_pack_leaf, fused_pack_plain,
                                            pack_leaves, stream_layout,
                                            words_to_stream)
from repro_torch.kernels.ops import (compress_roundtrip,
                                     compress_roundtrip_leaves,
                                     fused_wire_encode)
from repro_torch.kernels.topk_quant import (_pad_rows, dequant, topk_quant,
                                            topk_quant_plain)

from torch_threads import one_torch_thread  # noqa: F401

CNN_SHAPES = {"b1": (32,), "b2": (32,), "bf1": (128,), "bf2": (10,),
              "conv1": (2, 2, 1, 32), "conv2": (2, 2, 32, 32),
              "fc1": (1568, 128), "fc2": (128, 10)}


def _cnn_tree(seed):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) * 0.1).astype(np.float32)
            for k, s in CNN_SHAPES.items()}


@pytest.fixture
def card():
    """The CUDA device, decided when the test runs (skip without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the "
                    "card (python3 chip_smoke.py drives them there)")
    return torch.device("cuda")


# ----------------------------------------------------------------------
# kernel A: fused_pack
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n", [7, 1500, 4097])
@pytest.mark.parametrize("p_s", [0.05, 0.25, 1.0])
@pytest.mark.parametrize("p_q", [2, 8, 32])
def test_fused_pack_plain_matches_pallas_interpret(n, p_s, p_q):
    """Byte-identical to the Pallas kernel body (interpret mode) across odd
    sizes (n % 128 != 0), the k == n dense case and raw f32 values."""
    rng = np.random.RandomState(hash((n, int(p_s * 100), p_q)) % 2**31)
    x = rng.randn(n).astype(np.float32)
    want, want_bits = jax_fused_pack_leaf(x, p_s, p_q, interpret=True)
    got, got_bits = fused_pack_leaf(torch.from_numpy(x), p_s, p_q)
    assert got == want and got_bits == want_bits


@pytest.mark.parametrize("x", [
    np.zeros(300, np.float32),
    np.tile(np.float32([0.5, -0.5, 0.0]), 100),
    np.full(129, -0.25, np.float32),
    np.random.RandomState(5).choice(
        np.float32([1.0, -1.0, 0.5, 0.25]), 4000),
], ids=["zeros", "tied-thirds", "all-tied", "few-magnitudes"])
def test_fused_pack_plain_tie_and_zero_regimes(x):
    """Degenerate magnitudes: all-zero leaves (threshold 0, scale floor) and
    heavily tied leaves keep the smallest-index tie rule exactly."""
    for p_s in (0.1, 0.5):
        want, _ = jax_fused_pack_leaf(x, p_s, 8, interpret=True)
        assert fused_pack_leaf(torch.from_numpy(x), p_s, 8)[0] == want


@pytest.mark.parametrize("p_s", DEFAULT_SET_S)
def test_fused_pack_plain_matches_host_twin_on_cnn_tree(p_s):
    """The whole CNN tree in one stream, over the Alg. 5 grid (the
    uncompressed point excluded): byte-identical to pack_leaves_host."""
    tree = _cnn_tree(1)
    leaves = [tree[k] for k in sorted(tree)]
    for p_q in DEFAULT_SET_Q:
        if (p_s, p_q) == (1.0, 32):
            continue
        want = pack_leaves_host(leaves, p_s, p_q)
        got = fused_wire_encode({k: torch.from_numpy(v)
                                 for k, v in tree.items()}, p_s, p_q)
        assert got == want, (p_s, p_q)


def test_fused_pack_leaf_segments_concatenate_to_the_stream():
    tree = _cnn_tree(2)
    xs = [torch.from_numpy(tree[k]) for k in sorted(tree)]
    parts = [fused_pack_leaf(x, 0.1, 4) for x in xs]
    assert concat_bitstreams(parts) == pack_leaves(xs, 0.1, 4)
    offs, total = stream_layout([x.numel() for x in xs], 0.1, 4)
    assert offs == list(np.cumsum([0] + [nb for _, nb in parts])[:-1])
    assert total == sum(nb for _, nb in parts)


def test_fused_pack_wrapper_runs_the_plain_version_on_cpu():
    """A CPU tensor never reaches the CUDA kernel: the launch count stays."""
    tree = _cnn_tree(3)
    xs = [torch.from_numpy(tree[k]) for k in sorted(tree)]
    before = tfp.LAUNCHES
    words = tfp.fused_pack(xs, 0.25, 8)
    assert tfp.LAUNCHES == before
    assert torch.equal(words, fused_pack_plain(xs, 0.25, 8))
    with pytest.raises(TypeError):
        tfp.fused_pack([x.double() for x in xs], 0.25, 8)


@pytest.mark.cuda
def test_fused_pack_kernel_matches_plain_on_card(card):
    tree = _cnn_tree(4)
    rng = np.random.RandomState(14)
    # beside the CNN's leaves: a leaf of fc1's size, a ragged one (its last
    # slice one shorter), one whose ties at T span every slice, and a
    # ragged, tie-heavy one whose slices of 50,001 are more than a CTA's
    # shared memory holds (kMaxSlice in csrc/fused_pack.cu)
    tree["zz_big"] = (rng.randn(200704) * 0.1).astype(np.float32)
    tree["zz_ragged"] = rng.randn(200703).astype(np.float32)
    tree["zz_ties"] = rng.choice(np.float32([0.5, -0.5, 0.25, 0.0]), 60001)
    tree["zz_huge"] = (np.round(rng.randn(400003) * 8) / 8).astype(
        np.float32)
    leaves = [tree[k] for k in sorted(tree)]
    xs = [torch.from_numpy(v).to(card) for v in leaves]
    for p_s, p_q in ((0.25, 8), (0.01, 4), (1.0, 16), (0.5, 32)):
        before = tfp.LAUNCHES
        got = tfp.fused_pack(xs, p_s, p_q)
        assert tfp.LAUNCHES == before + 1
        assert torch.equal(got, fused_pack_plain(xs, p_s, p_q))
        _, total = stream_layout([x.numel() for x in xs], p_s, p_q)
        assert words_to_stream(got, total) == pack_leaves_host(leaves, p_s,
                                                               p_q)


# The CUDA kernel's decomposition, emulated in numpy: a leaf cut into
# slices (one per CTA of a cluster), each slice cut into thread runs; a
# 4-pass 8-bit radix select over summed slice histograms; tie ranks,
# survivor ranks and previous survivors from exclusive prefixes over
# per-run and per-slice totals; each slice's value and delta fields
# assembled in a window of words whose interior is stored and whose two
# boundary words are ORed.  Test-only: the port ships the CUDA kernel.
def _excl(v, op=np.add, init=0):
    out, acc = [], init
    for e in v:
        out.append(acc)
        acc = op(acc, e)
    return out, acc


def _binary_search_t(p, k):
    """The JAX kernel's 31-step greedy search for the k-th largest."""
    t = 0
    for bit in range(30, -1, -1):
        if int((p >= (t | (1 << bit))).sum()) >= k:
            t |= 1 << bit
    return t


def _radix_select(slice_pats, k):
    """(T, ties of T that survive, each slice's last-pass histogram)."""
    prefix, mask, kk = 0, 0, k
    for shift in (24, 16, 8, 0):
        hists = [np.bincount((q[(q & mask) == prefix] >> shift) & 255,
                             minlength=256) for q in slice_pats]
        tot = np.sum(hists, axis=0)
        suf = np.cumsum(tot[::-1])[::-1]           # count in bins >= d
        d = max(i for i in range(256) if suf[i] >= kk)
        prefix |= d << shift
        mask |= 255 << shift
        kk -= int(suf[d] - tot[d])
    return prefix, kk, [int(h[prefix & 255]) for h in hists]


def _or_fields(buf, offs, vals, width):
    v = vals.astype(np.uint64) << (64 - (offs & 31) - width).astype(
        np.uint64)
    np.bitwise_or.at(buf, offs >> 5, v >> np.uint64(32))
    np.bitwise_or.at(buf, (offs >> 5) + 1, v & np.uint64(0xFFFFFFFF))


def _emulate_leaf(words, x, base, p_s, p_q, slices, threads=7):
    n = x.size
    k = topk_count(n, p_s)
    select = k < n
    pat = x.view(np.uint32) & np.uint32(0x7FFFFFFF)
    part = -(-n // slices)
    bounds = [(min(n, r * part), min(n, (r + 1) * part))
              for r in range(slices)]
    gmax = max(int(pat[a:b].max()) if b > a else 0 for a, b in bounds)
    thr, need, last_bins = 0, 0, [0] * slices
    if select:
        thr, need, last_bins = _radix_select([pat[a:b] for a, b in bounds],
                                             k)
        assert thr == _binary_search_t(pat, k)
        assert need == k - int((pat > thr).sum())
    ties_before, _ = _excl(last_bins)
    quantized = p_q < 32
    vbits = min(p_q, 32)
    scale = np.float32(max(np.uint32(gmax).view(np.float32),
                           np.float32(1e-12))) if quantized \
        else np.float32(1.0)
    _or_fields(words, np.array([base]), np.array([scale]).view(np.uint32),
               32)
    # per slice, per run: survivors (global indices), counted serially
    kept, totals = [], []
    for r, (a, b) in enumerate(bounds):
        m = b - a
        run = -(-m // threads)
        runs = [(a + min(m, t * run), a + min(m, t * run + run))
                for t in range(threads)]
        ties = [int((pat[u:v] == thr).sum()) if select else 0
                for u, v in runs]
        tie0, _ = _excl(ties)
        per_run = []
        for (u, v), t0 in zip(runs, tie0):
            q = pat[u:v]
            keep = np.ones(v - u, bool)
            if select:
                tie = q == thr
                rank = ties_before[r] + t0 + np.cumsum(tie) - tie
                keep = (q > thr) | (tie & (rank < need))
            per_run.append(u + np.flatnonzero(keep))
        counts = [len(s) for s in per_run]
        lasts = [int(s[-1]) if len(s) else -1 for s in per_run]
        kept.append((per_run, _excl(counts)[0], _excl(lasts, max, -1)[0]))
        totals.append((sum(counts), max(lasts)))
    bases, _ = _excl([t[0] for t in totals])
    prevs, _ = _excl([t[1] for t in totals], max, -1)
    L = 2 ** (p_q - 1) - 1
    for r, (per_run, rank0, prev0) in enumerate(kept):
        for field in range(2 if select else 1):
            width = vbits if field == 0 else index_bits(n)
            start = base + 32 + (0 if field == 0 else k * vbits)
            first = start + bases[r] * width
            count = totals[r][0]
            if count == 0:
                continue
            w0, w1 = first >> 5, (first + count * width - 1) >> 5
            window = np.zeros(w1 - w0 + 2, np.uint64)
            for sel, r0, p0 in zip(per_run, rank0, prev0):
                if not len(sel):
                    continue
                if field == 0:
                    v = x[sel]
                    f = (np.clip(np.rint((v / scale) * np.float32(L)), -L, L)
                         .astype(np.int64) + L) if quantized \
                        else v.view(np.uint32)
                else:
                    p0 = p0 if p0 >= 0 else (prevs[r] if prevs[r] >= 0
                                             else 0)
                    f = np.diff(sel, prepend=p0)
                offs = start + (bases[r] + r0 + np.arange(len(sel))) * width
                _or_fields(window, offs - w0 * 32, np.asarray(f), width)
            assert window[-1] == 0
            # interior words belong to this slice alone: stored
            assert not words[w0 + 1:w1].any()
            words[w0 + 1:w1] = window[1:w1 - w0]
            words[w0] |= window[0]
            if w1 > w0:
                words[w1] |= window[w1 - w0]


def _emulated_stream(leaves, p_s, p_q, slices):
    offs, total = stream_layout([x.size for x in leaves], p_s, p_q)
    words = np.zeros((total + 31) // 32 + 1, np.uint64)
    for x, off in zip(leaves, offs):
        _emulate_leaf(words, x, off, p_s, p_q,
                      slices if x.size > 64 else 1)
    return words_to_bytes(words[:-1].astype(np.uint32), total)


def _leaf(kind):
    rng = np.random.RandomState(21)
    if kind == "ragged":
        return rng.randn(10007).astype(np.float32)
    if kind == "ties-straddle":
        # few magnitudes: T is a tied value whose ties fill every slice
        return rng.choice(np.float32([0.5, -0.5, 0.25, -0.25, 0.0]), 5003)
    # "late-survivors": large values only at both ends, so middle slices
    # keep nothing and the last slice's first delta reaches back slices
    x = (rng.randn(9001) * 1e-3).astype(np.float32)
    x[:200] = rng.randn(200) + 3.0
    x[-200:] = rng.randn(200) - 3.0
    return x


@pytest.mark.parametrize("slices", [1, 3, 8])
@pytest.mark.parametrize("kind", ["ragged", "ties-straddle",
                                  "late-survivors"])
def test_fused_pack_cluster_decomposition_gives_the_stream(slices, kind):
    """Radix select finds the binary search's T, and slices composed by
    exclusive prefixes give fused_pack_plain's stream and the JAX host
    pipeline's, byte for byte, between two small leaves."""
    rng = np.random.RandomState(22)
    leaves = [rng.randn(37).astype(np.float32), _leaf(kind),
              rng.randn(5).astype(np.float32)]
    for p_s, p_q in ((0.25, 8), (0.05, 4), (0.5, 32), (1.0, 16)):
        want = pack_leaves_host(leaves, p_s, p_q)
        _, total = stream_layout([x.size for x in leaves], p_s, p_q)
        plain = words_to_stream(fused_pack_plain(
            [torch.from_numpy(x) for x in leaves], p_s, p_q), total)
        assert plain == want
        assert _emulated_stream(leaves, p_s, p_q, slices) == want, (p_s, p_q)


def test_fused_pack_launch_rows_cover_each_leaf_once():
    """The kernel's CTA plan: big leaves first, CLUSTER slices each (the
    last one shorter where n is ragged), small leaves one CTA each, idle
    rows padding the last cluster; every element in exactly one slice."""
    sizes = [32, 200703, 4096, tfp.BIG_LEAF, tfp.BIG_LEAF + 1, 10]
    rows = tfp.launch_rows(sizes, 0.25, 8)
    offs, _ = stream_layout(sizes, 0.25, 8)
    assert len(rows) % tfp.CLUSTER == 0
    assert [r[0] for r in rows[:2 * tfp.CLUSTER]] == \
        [1] * tfp.CLUSTER + [4] * tfp.CLUSTER
    for i, n in enumerate(sizes):
        mine = [r for r in rows if r[0] == i]
        assert all(r[1:5] == [n, topk_count(n, 0.25), offs[i],
                              index_bits(n)] for r in mine)
        assert len(mine) == (tfp.CLUSTER if n > tfp.BIG_LEAF else 1)
        assert all(r[7] == len(mine) for r in mine)
        cover = np.concatenate([np.arange(r[5], r[5] + r[6]) for r in mine])
        np.testing.assert_array_equal(cover, np.arange(n))
    idle = [r for r in rows if r[0] < 0]
    assert len(idle) == -4 % tfp.CLUSTER and all(r[1] == -1 for r in idle)


# ----------------------------------------------------------------------
# kernel B: topk_quant
# ----------------------------------------------------------------------
@pytest.mark.parametrize("block", [1024, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_topk_quant_plain_matches_pallas_interpret(block, dtype, bits):
    """Levels and scales bit for bit (M = 4 rows).  Power-of-two blocks:
    there the kept fraction count / block is exact in f32, in any
    summation order, so both frameworks see the same bisection."""
    rng = np.random.RandomState(block + bits)
    x = rng.randn(4 * block).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    lv, sc = jax_topk_quant(jx, p_s=0.25, bits=bits, block=block)
    got_lv, got_sc = topk_quant(tx, p_s=0.25, bits=bits, block=block)
    assert got_lv.dtype == torch.int8 and got_sc.dtype == torch.float32
    np.testing.assert_array_equal(got_lv.numpy(), np.asarray(lv))
    np.testing.assert_array_equal(got_sc.numpy(), np.asarray(sc))


def test_compress_roundtrip_matches_jax_on_ragged_input():
    """The padded tail (n % block != 0) counts in the kept fraction and is
    cut off again after dequantization, exactly as in the JAX package."""
    rng = np.random.RandomState(9)
    x = rng.randn(3000).astype(np.float32)
    want = np.asarray(jax_compress_roundtrip(jnp.asarray(x), 0.25, 8,
                                             block=1024, interpret=True))
    got = compress_roundtrip(torch.from_numpy(x), 0.25, 8, block=1024)
    assert got.shape == (3000,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_topk_quant_wrapper_runs_the_plain_version_on_cpu():
    x = torch.from_numpy(np.random.RandomState(10).randn(5000).astype(
        np.float32))
    before = ttq.LAUNCHES
    lv, sc = topk_quant(x, block=2048)
    assert ttq.LAUNCHES == before
    lp, sp = topk_quant_plain(_pad_rows(x, 2048))
    assert torch.equal(lv, lp) and torch.equal(sc, sp)
    y = dequant(lv, sc, 8, 5000, (50, 100))
    assert y.shape == (50, 100)
    # no block limit: a block of 32,768 (above one CTA's row) equals the
    # JAX kernel in interpret mode
    lv, sc = topk_quant(x, block=32768)
    jl, js = jax_topk_quant(jnp.asarray(x.numpy()), block=32768)
    assert lv.shape == (1, 32768)
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(js))


def _mid(lo, hi):
    return np.float32(np.float32(0.5) * np.float32(lo + hi))


@pytest.mark.parametrize("block", [1, 7, 1000, 4096, 16384, 60001,
                                   200704, 2 ** 24 + 3])
@pytest.mark.parametrize("p_s", [0.0, 0.05, 0.1, 0.25, 1 / 3, 0.5, 1.0])
def test_topk_quant_least_kept_count_is_the_division_rule(block, p_s):
    """The kernel decides count >= need, with need searched once by the
    wrapper: the same decision as count / block > p_s in f32 for every
    count (checked around need, where the two could differ, and at the
    ends)."""
    need = ttq.least_kept_count(block, p_s)
    fb, ps = np.float32(block), np.float32(p_s)
    counts = {0, block, need - 2, need - 1, need, need + 1}
    for c in sorted(c for c in counts if 0 <= c <= block):
        assert (c >= need) == bool(np.float32(c) / fb > ps), (c, need)


def _kary_row(row, block, p_s, bits, iters, s, slices, visited=None):
    """csrc/topk_quant.cu's algorithm on one row (its ``row.size <= block``
    values; the rest of the block is pad, never read) in numpy f32: the
    max over ``slices`` contiguous slices, then passes of ``s`` bisection
    steps -- the tree of midpoints by the sequential f32 recursion, each
    |x| binned from its position in [lo, hi) and corrected against its
    neighbouring midpoints, bin 0 dropped and |x| >= hi counted apart,
    per-slice histograms summed, suffix counts, the walk of decisions --
    and the scale from max|x| without a kept-max pass.  Returns the
    levels (block,) int8 and the scale; appends the midpoint of each
    decision to ``visited``."""
    # the kernel's slice_len: over a cluster a multiple of 4 values
    part = block if slices == 1 else (-(-block // slices) + 3) // 4 * 4
    ax = np.abs(row.astype(np.float32))
    cuts = [ax[r * part:(r + 1) * part] for r in range(slices)]
    amax = max((float(c.max()) if c.size else 0.0) for c in cuts)
    amax = np.float32(amax)
    lo, hi = np.float32(0), np.float32(amax + np.float32(1e-12))
    done = 0
    while done < iters:
        depth = min(s, iters - done)
        nb = 1 << depth
        mids = np.zeros(nb + 1, np.float32)
        mids[0], mids[nb] = lo, hi
        step = nb
        while step > 1:
            half = step >> 1
            for j in range(half, nb, step):
                mids[j] = _mid(mids[j - half], mids[j + half])
            step = half
        assert np.all(np.diff(mids) >= 0)           # in order, sorted
        inv = np.float32(nb) / np.float32(hi - lo) if hi > lo else \
            np.float32(0)
        hist = np.zeros(nb, np.int64)
        for c in cuts:                              # one CTA's slice each
            a = c[c >= lo]
            top = int((a >= hi).sum())
            a = a[a < hi]
            with np.errstate(over="ignore", invalid="ignore"):
                est = np.floor(np.float32(a - lo) * inv)
            b = np.clip(np.nan_to_num(est, nan=0.0), 0, nb - 1).astype(
                np.int64)
            while True:                             # corrections
                up = (b < nb - 1) & (mids[np.minimum(b + 1, nb)] <= a)
                if not up.any():
                    break
                b += up
            while True:
                down = (b > 0) & (mids[b] > a)
                if not down.any():
                    break
                b -= down
            np.testing.assert_array_equal(
                b, np.searchsorted(mids[1:nb], a, side="right"))
            h = np.bincount(b[b > 0], minlength=nb)
            h[nb - 1] += top
            hist += h
        suffix = np.cumsum(hist[::-1])[::-1]        # values >= mids[j]
        # the kernel: K = the number of midpoints whose count >= need,
        # and (lo, hi) = (mids[K], mids[K + 1])
        need = ttq.least_kept_count(block, p_s)
        k = int((suffix[1:nb] >= need).sum())
        want = (mids[k], mids[k + 1])
        j, step = nb >> 1, nb >> 2
        for _ in range(depth):
            if visited is not None:
                visited.append(mids[j])
            frac = np.float32(suffix[j]) / np.float32(block)
            if frac > np.float32(p_s):
                lo, j = mids[j], j + step
            else:
                hi, j = mids[j], j - step
            step >>= 1
        assert (lo, hi) == want                     # the walk down the tree
        done += depth
    thr = _mid(lo, hi)
    scale = np.float32(max(amax if amax >= thr else np.float32(0),
                           np.float32(1e-12)))
    L = np.float32(2 ** (bits - 1) - 1)
    x = row.astype(np.float32)
    kept = np.where(np.abs(x) >= thr, x, np.float32(0))
    q = np.clip(np.round(np.float32(kept / scale) * L), -L, L)
    levels = np.zeros(block, np.int8)
    levels[:row.size] = q.astype(np.int8)
    return levels, scale


def _kary(x, block, p_s=0.25, bits=8, iters=16, s=8, slices=1):
    """:func:`_kary_row` over every row of flat ``x`` -> (levels (M,
    block), scales (M, 1))."""
    flat = x.reshape(-1)
    m = max(1, -(-flat.size // block))
    out = [_kary_row(flat[i * block:(i + 1) * block], block, p_s, bits,
                     iters, s, slices) for i in range(m)]
    return (np.stack([o[0] for o in out]),
            np.array([[o[1]] for o in out], np.float32))


def _rows_of(kind, n, seed):
    rng = np.random.RandomState(seed)
    if kind == "gauss":
        scale = 10.0 ** rng.uniform(-6, 2)
        return (rng.randn(n) * scale).astype(np.float32)
    if kind == "ties":
        return rng.choice(np.float32([0.5, -0.5, 0.25, -0.25, 0.0]), n)
    x = rng.randn(n).astype(np.float32)              # "half-zero"
    x[rng.rand(n) < 0.5] = 0.0
    return x


def _sequential_mids(row, block, p_s, iters):
    """The midpoints the sequential loop tries on one row, in numpy f32."""
    ax = np.abs(row.astype(np.float32))
    lo, hi = np.float32(0), np.float32(ax.max() + np.float32(1e-12))
    out = []
    for _ in range(iters):
        mid = _mid(lo, hi)
        out.append(mid)
        if np.float32((ax >= mid).sum()) / np.float32(block) > \
                np.float32(p_s):
            lo = mid
        else:
            hi = mid
    return out


@pytest.mark.parametrize("s", [4, 8])
@pytest.mark.parametrize("iters", [16, 12, 5])
@pytest.mark.parametrize("kind", ["gauss", "ties", "half-zero"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_quant_kary_bisection_is_the_sequential_one(s, iters, kind,
                                                         dtype):
    """The kernel's k-ary bisection (s steps a pass) gives the sequential
    loop's threshold, so levels and scales equal topk_quant_plain's and
    the JAX kernel's bit for bit; 5,000 values at block 4,096, the second
    row ragged."""
    x = _rows_of(kind, 5000, 100 * s + iters + len(kind))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
        x = tx.to(torch.float32).numpy()
    lv, sc = _kary(x, 4096, iters=iters, s=s)
    for r in range(2):               # the tree walks the loop's midpoints
        row, visited = x[r * 4096:(r + 1) * 4096], []
        _kary_row(row, 4096, 0.25, 8, iters, s, 1, visited)
        np.testing.assert_array_equal(
            np.float32(visited), np.float32(_sequential_mids(
                row, 4096, 0.25, iters)))
    lp, sp = topk_quant_plain(_pad_rows(tx, 4096), 0.25, 8, iters)
    np.testing.assert_array_equal(lv, lp.numpy())
    np.testing.assert_array_equal(sc, sp.numpy())
    jl, js = jax_topk_quant(jx, p_s=0.25, bits=8, iters=iters, block=4096)
    np.testing.assert_array_equal(lv, np.asarray(jl))
    np.testing.assert_array_equal(sc, np.asarray(js))


@pytest.mark.parametrize("slices", [1, 3, 8])
@pytest.mark.parametrize("kind", ["gauss", "ties", "half-zero"])
def test_topk_quant_cluster_slices_give_the_row(slices, kind):
    """A row over a cluster: per-slice maxima and histograms summed over
    1, 3 and 8 slices give the whole row's levels and scale, those of
    topk_quant_plain and of the JAX kernel -- one row of 60,001 values
    (block 60,001) and a ragged one of 50,000 at block 60,001, whose last
    slices hold only pad."""
    for n, seed in ((60001, 7), (50000, 8)):
        x = _rows_of(kind, n, seed + slices)
        want_l, want_s = _kary(x, 60001, slices=1)
        lv, sc = _kary(x, 60001, slices=slices)
        np.testing.assert_array_equal(lv, want_l)
        np.testing.assert_array_equal(sc, want_s)
        lp, sp = topk_quant(torch.from_numpy(x), block=60001)
        np.testing.assert_array_equal(lv, lp.numpy())
        np.testing.assert_array_equal(sc, sp.numpy())
        jl, js = jax_topk_quant(jnp.asarray(x), block=60001)
        np.testing.assert_array_equal(lv, np.asarray(jl))
        np.testing.assert_array_equal(sc, np.asarray(js))


@pytest.mark.parametrize("block", [32768, 60001])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_quant_large_blocks_match_pallas_interpret(block, dtype):
    """Blocks above one CTA's row (the kernel's cluster form): levels and
    scales bit for bit with the JAX kernel on a ragged 70,001-value input
    (60,001 is no power of two: count / block is one f32 division in
    both)."""
    x = (np.random.RandomState(block).randn(70001) * 0.1).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    for iters in (16, 12):
        jl, js = jax_topk_quant(jx, iters=iters, block=block)
        lv, sc = topk_quant(tx, iters=iters, block=block)
        assert lv.shape == (-(-70001 // block), block)
        np.testing.assert_array_equal(lv.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(sc.numpy(), np.asarray(js))


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_topk_quant_leaves_is_the_per_leaf_call(bits):
    """topk_quant_leaves on the CNN's 8 leaves equals topk_quant leaf by
    leaf and the JAX kernel on each leaf."""
    tree = _cnn_tree(12)
    names = sorted(tree)
    got = ttq.topk_quant_leaves([torch.from_numpy(tree[k]) for k in names],
                                bits=bits)
    assert len(got) == len(names)
    for k, (lv, sc) in zip(names, got):
        want = topk_quant(torch.from_numpy(tree[k]), bits=bits)
        assert torch.equal(lv, want[0]) and torch.equal(sc, want[1]), k
        jl, js = jax_topk_quant(jnp.asarray(tree[k]), bits=bits)
        np.testing.assert_array_equal(lv.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(sc.numpy(), np.asarray(js))


@pytest.mark.parametrize("block", [1024, 16384])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_roundtrip_leaves_is_the_per_leaf_call(block, dtype):
    """compress_roundtrip_leaves on the CNN's leaves: each result equals
    compress_roundtrip of its leaf and the JAX compress_roundtrip, with
    the leaf's shape and dtype."""
    tree = _cnn_tree(13)
    names = sorted(tree)
    tdt = getattr(torch, dtype)
    xs = [torch.from_numpy(tree[k]).to(tdt) for k in names]
    got = compress_roundtrip_leaves(xs, 0.25, 8, block=block)
    for k, x, y in zip(names, xs, got):
        assert y.shape == x.shape and y.dtype == tdt
        assert torch.equal(y, compress_roundtrip(x, 0.25, 8, block=block)), k
        want = jax_compress_roundtrip(
            jnp.asarray(x.to(torch.float32).numpy()).astype(getattr(
                jnp, dtype)), 0.25, 8, block=block, interpret=True)
        np.testing.assert_array_equal(
            y.to(torch.float32).numpy(),
            np.asarray(want.astype(jnp.float32)))


def test_topk_quant_launch_plan_covers_each_leaf_once():
    """The kernel's launches: each leaf's rows consecutive from its first
    row (a row for an empty leaf too), MAX_LEAVES leaves a launch, the
    launches' rows adding up to the total."""
    sizes = [32, 0, 16384, 16385, 200704] + [10] * (2 * ttq.MAX_LEAVES)
    firsts, total, launches = ttq.launch_plan(sizes, 16384)
    rows = [max(1, -(-n // 16384)) for n in sizes]
    assert firsts == list(np.cumsum([0] + rows[:-1]))
    assert total == sum(rows)
    assert [(a, b) for a, b, _ in launches] == [
        (0, 64), (64, 128), (128, len(sizes))]
    assert sum(r for _, _, r in launches) == total
    for a, b, r in launches:
        assert r == sum(rows[a:b])


@pytest.mark.parametrize("block,slices", [
    (1, 1), (1024, 1), (4096, 1), (4097, 2), (16384, 4), (32768, 8),
    (60001, 8), (200704, 8), (400003, 8)])
def test_topk_quant_row_takes_one_cta_per_4096_values(block, slices):
    """The kernel's CTAs per row (a cluster's size): one per CTA_ROW
    values, at most CLUSTER; the slices, a multiple of 4 values over a
    cluster, cover the row once."""
    assert ttq.slices_for(block) == slices
    part = block if slices == 1 else (-(-block // slices) + 3) // 4 * 4
    starts = [min(block, r * part) for r in range(slices)]
    ends = [min(block, s + part) for s in starts]
    assert starts[0] == 0 and ends[-1] == block
    assert all(a == b for a, b in zip(ends[:-1], starts[1:]))


def test_topk_quant_refuses_mixed_leaves_and_bad_arguments():
    x = torch.zeros(10)
    with pytest.raises(ValueError):
        ttq.topk_quant_leaves([x, x.to(torch.bfloat16)])
    with pytest.raises(ValueError):
        ttq.topk_quant_leaves([])
    with pytest.raises(TypeError):
        topk_quant(torch.zeros(10, dtype=torch.float64))
    with pytest.raises(ValueError):
        topk_quant(x, block=0)
    with pytest.raises(ValueError):
        topk_quant(x, bits=9)


# the card cases of chip_smoke.py phase 3: (values, block, dtype, bits,
# iters, kind)
CARD_TOPK_CASES = (
    [(206410, b, d, bits, 16, "gauss") for b in (4096, 16384)
     for d in ("float32", "bfloat16") for bits in (8, 4)]
    + [(206410, 1024, "float32", 8, 16, "gauss"),
       (206410, 16384, "float32", 2, 16, "gauss"),
       (206410, 16384, "float32", 8, 12, "gauss"),
       (206410, 16384, "bfloat16", 8, 5, "gauss"),
       (206410, 32768, "float32", 8, 16, "gauss"),
       (60001, 60001, "float32", 8, 16, "ties"),
       (200704, 200704, "float32", 8, 12, "gauss"),
       (200704, 200704, "bfloat16", 4, 16, "gauss"),
       (400003, 65536, "float32", 8, 16, "ties"),
       (400003, 400003, "float32", 8, 16, "ties")])


@pytest.mark.cuda
def test_topk_quant_kernel_matches_plain_on_card(card):
    """Phase 3's cases (blocks from 1,024 to 400,003: one-CTA rows,
    clusters, and cluster slices read from device memory) and the CNN's
    8 leaves in one launch, each identical to the plain version."""
    for n, block, dtype, bits, iters, kind in CARD_TOPK_CASES:
        x = torch.from_numpy(_rows_of(kind, n, n + block)).to(card).to(
            getattr(torch, dtype))
        before = ttq.LAUNCHES
        lv, sc = topk_quant(x, bits=bits, iters=iters, block=block)
        assert ttq.LAUNCHES == before + 1
        lp, sp = topk_quant_plain(_pad_rows(x, block), 0.25, bits, iters)
        where = (n, block, dtype, bits, iters, kind)
        assert torch.equal(lv, lp) and torch.equal(sc, sp), where
    tree = _cnn_tree(14)
    xs = [torch.from_numpy(tree[k]).to(card) for k in sorted(tree)]
    before = ttq.LAUNCHES
    got = ttq.topk_quant_leaves(xs)
    assert ttq.LAUNCHES == before + 1
    for x, (lv, sc) in zip(xs, got):
        lp, sp = topk_quant_plain(_pad_rows(x, ttq.DEFAULT_BLOCK))
        assert torch.equal(lv, lp) and torch.equal(sc, sp)
