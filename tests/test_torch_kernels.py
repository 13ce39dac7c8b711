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
from repro_torch.kernels import fused_pack as tfp
from repro_torch.kernels import topk_quant as ttq
from repro_torch.kernels.fused_pack import (concat_bitstreams,
                                            fused_pack_leaf, fused_pack_plain,
                                            pack_leaves, stream_layout,
                                            words_to_stream)
from repro_torch.kernels.ops import compress_roundtrip, fused_wire_encode
from repro_torch.kernels.topk_quant import (_pad_rows, dequant, topk_quant,
                                            topk_quant_plain)

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
    xs = [torch.from_numpy(tree[k]).to(card) for k in sorted(tree)]
    for p_s, p_q in ((0.25, 8), (0.01, 4), (1.0, 16), (0.5, 32)):
        before = tfp.LAUNCHES
        got = tfp.fused_pack(xs, p_s, p_q)
        assert tfp.LAUNCHES == before + 1
        assert torch.equal(got, fused_pack_plain(xs, p_s, p_q))
        _, total = stream_layout([x.numel() for x in xs], p_s, p_q)
        want = pack_leaves_host([tree[k] for k in sorted(tree)], p_s, p_q)
        assert words_to_stream(got, total) == want


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
    with pytest.raises(ValueError):
        topk_quant(x, block=2 * ttq.MAX_BLOCK)


@pytest.mark.cuda
def test_topk_quant_kernel_matches_plain_on_card(card):
    rng = np.random.RandomState(11)
    for block in (4096, 16384):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.randn(3 * block + 5).astype(
                np.float32)).to(card).to(dtype)
            before = ttq.LAUNCHES
            lv, sc = topk_quant(x, p_s=0.25, bits=8, block=block)
            assert ttq.LAUNCHES == before + 1
            lp, sp = topk_quant_plain(_pad_rows(x, block), 0.25, 8)
            assert torch.equal(lv, lp) and torch.equal(sc, sp)
