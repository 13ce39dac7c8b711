"""The port's host compression, bit-packing and codecs against the JAX
package's, on the CPU.

Everything here is exact (tolerance zero): the host half of the
compression is numpy in both packages, the packed streams are compared
byte for byte, and stochastic rounding draws from the same numpy
``RandomState`` stream in the same order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codecs as jcodecs
from repro.core import compression as jcomp
from repro.core import dynamic as jdyn
from repro.core import latency as jlat
from repro.kernels import bitpack as jbitpack
from repro_torch.core import codecs as tcodecs
from repro_torch.core import compression as tcomp
from repro_torch.core import dynamic as tdyn
from repro_torch.core import latency as tlat
from repro_torch.kernels import bitpack as tbitpack
from repro_torch.kernels import fused_pack as tfp

from torch_threads import one_torch_thread  # noqa: F401

CNN_SHAPES = {"b1": (32,), "b2": (32,), "bf1": (128,), "bf2": (10,),
              "conv1": (2, 2, 1, 32), "conv2": (2, 2, 32, 32),
              "fc1": (1568, 128), "fc2": (128, 10)}
POINTS = [(0.25, 8), (0.1, 4), (0.5, 16), (0.05, 32), (1.0, 8), (0.01, 2)]


def _tree(seed):
    rng = np.random.RandomState(seed)
    tree = {k: (rng.randn(*s) * 0.1).astype(np.float32)
            for k, s in CNN_SHAPES.items()}
    # a leaf with tied magnitudes at the Top-K boundary
    tree["conv1"][..., :8] = 0.125
    return tree


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("p_s,p_q", POINTS)
@pytest.mark.parametrize("stochastic", [False, True])
def test_compress_tensor_exact(p_s, p_q, stochastic):
    tree = _tree(0)
    for k in sorted(tree):
        rj = np.random.RandomState(7) if stochastic else None
        rt = np.random.RandomState(7) if stochastic else None
        want = jcomp.compress_tensor(tree[k], p_s, p_q, rj)
        got = tcomp.compress_tensor(torch.from_numpy(tree[k]), p_s, p_q, rt)
        np.testing.assert_array_equal(got["values"], want["values"])
        np.testing.assert_array_equal(got["indices"], want["indices"])
        assert got["scale"] == want["scale"]
        assert (got["shape"], got["n"]) == (want["shape"], want["n"])
        np.testing.assert_array_equal(tcomp.decompress_tensor(got),
                                      jcomp.decompress_tensor(want))


@pytest.mark.parametrize("p_s,p_q", POINTS)
def test_size_model_exact(p_s, p_q):
    tree = _tree(1)
    assert tcomp.expected_pytree_wire_bytes(_torch(tree), p_s, p_q) == \
        jcomp.expected_pytree_wire_bytes(_jax(tree), p_s, p_q)
    assert tcomp.pytree_dense_bytes(_torch(tree)) == \
        jcomp.pytree_dense_bytes(_jax(tree))
    c = tcomp.compress_pytree(_torch(tree), p_s, p_q)
    assert tcomp.pytree_wire_bytes(c) == jcomp.pytree_wire_bytes(
        jcomp.compress_pytree(_jax(tree), p_s, p_q))
    for n in (1, 2, 3, 1000, 200704):
        assert tcomp.index_bits(n) == jcomp.index_bits(n)
        assert tcomp.topk_count(n, p_s) == jcomp.topk_count(n, p_s)


def test_bitpack_exact():
    rng = np.random.RandomState(3)
    segs = [(rng.randint(0, 2 ** w, size=s).astype(np.uint32), w)
            for w, s in ((1, 17), (7, 5), (32, 3), (13, 40), (2, 0))]
    payload = tbitpack.pack_segments(segs)
    assert payload == jbitpack.pack_segments(segs)
    rt, rj = tbitpack.BitReader(payload), jbitpack.BitReader(payload)
    for v, w in segs:
        np.testing.assert_array_equal(rt.read(len(v), w), rj.read(len(v), w))
        np.testing.assert_array_equal(rj.read(0, w), rt.read(0, w))
    assert rt.bits_read == rj.bits_read


@pytest.mark.parametrize("p_s,p_q", POINTS)
@pytest.mark.parametrize("stochastic", [False, True])
def test_packed_stream_byte_identical(p_s, p_q, stochastic):
    """The port's packed stream equals the JAX package's byte for byte:
    under the same rng (host pipeline), and deterministically (the port's
    fused kernel path against the JAX host pipeline)."""
    tree = _tree(2)
    rj = np.random.RandomState(11) if stochastic else None
    rt = np.random.RandomState(11) if stochastic else None
    jc = jcodecs.PackedBitstreamCodec(p_s, p_q, fused=False)
    tc = tcodecs.PackedBitstreamCodec(p_s, p_q)
    jw, tw = jc.encode(_jax(tree), rng=rj), tc.encode(_torch(tree), rng=rt)
    assert tw.payload == jw.payload
    assert tw.nbytes == len(tw.payload) == tc.wire_bytes(_torch(tree))
    if p_s < 1.0 or p_q < 32:
        assert tw.nbytes == tcomp.expected_pytree_wire_bytes(
            _torch(tree), p_s, p_q)
    got, want = tc.decode(tw), jc.decode(jw)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("p_s,p_q", POINTS)
def test_dense_codec_matches_packed_and_jax(p_s, p_q):
    """The reference codec decodes to the same tree as the packed codec
    (same selection, same levels), and both equal the JAX package's."""
    tree = _tree(4)
    got, nbytes = tcodecs.DenseRefCodec(p_s, p_q).roundtrip(
        _torch(tree), rng=np.random.RandomState(5))
    want, jbytes = jcodecs.DenseRefCodec(p_s, p_q).roundtrip(
        _jax(tree), rng=np.random.RandomState(5))
    packed, pbytes = tcodecs.PackedBitstreamCodec(p_s, p_q).roundtrip(
        _torch(tree), rng=np.random.RandomState(5))
    assert nbytes == jbytes == pbytes
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert torch.equal(got[k], packed[k])


def test_fused_and_host_packed_encodes_agree():
    tree = _torch(_tree(6))
    before = tfp.LAUNCHES
    for p_s, p_q in POINTS:
        fused = tcodecs.PackedBitstreamCodec(p_s, p_q).encode(tree)
        host = tcodecs.PackedBitstreamCodec(p_s, p_q, fused=False).encode(tree)
        assert fused.payload == host.payload
    assert tfp.LAUNCHES == before          # CPU tensors: the plain version


def test_resolve_codec():
    assert isinstance(tcodecs.resolve_codec("packed", 1.0, 32),
                      tcodecs.IdentityCodec)
    assert tcodecs.resolve_codec("dense", 0.25, 8) is \
        tcodecs.resolve_codec("dense", 0.25, 8)
    assert sorted(tcodecs.CODECS) == ["dense", "identity", "packed",
                                      "threshold"]
    ident = tcodecs.IdentityCodec()
    tree = _torch(_tree(7))
    assert ident.roundtrip(tree)[1] == jcodecs.IdentityCodec().wire_bytes(
        _jax(_tree(7)))
    thr = tcodecs.resolve_codec("threshold", 0.25, 8, iters=6)
    assert thr == tcodecs.ThresholdGraphCodec(0.25, 8, 6)
    assert thr.wire_bytes(tree) == jcodecs.resolve_codec(
        "threshold", 0.25, 8, iters=6).wire_bytes(_jax(_tree(7)))
    with pytest.raises(ValueError):
        tcodecs.resolve_codec("nope", 0.25, 8)
    with pytest.raises(ValueError):
        tcodecs.PackedBitstreamCodec(0.5, 1)


def test_latency_and_schedule_copies_exact():
    """core/latency.py and core/dynamic.py are numpy in both packages."""
    cfg = jlat.WirelessConfig()
    dj = jlat.device_rates(50, cfg, np.random.RandomState(1))
    dt = tlat.device_rates(50, tlat.WirelessConfig(), np.random.RandomState(1))
    for a, b in zip(dj, dt):
        np.testing.assert_array_equal(a, b)
    rj, rt = np.random.RandomState(2), np.random.RandomState(2)
    assert jlat.sample_compute_latency(0.7, 3.0, 2.4, rj) == \
        tlat.sample_compute_latency(0.7, 3.0, 2.4, rt)

    def acc(p_s, p_q):           # a deterministic accuracy surface
        return 0.9 - 0.05 * (1 - p_s) - 0.004 * (32 - p_q)

    assert tdyn.greedy_search(acc, 0.05) == jdyn.greedy_search(acc, 0.05)
    js, ts = jdyn.make_schedule(2, 1, 40), tdyn.make_schedule(2, 1, 40)
    assert [js.at_round(t) for t in range(60)] == \
        [ts.at_round(t) for t in range(60)]
