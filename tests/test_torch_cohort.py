"""The cohort trainer: the port's cohort CNN, cohort round, deferred
buffer and cohort runs against a live run of the JAX package's, on the
CPU, from the same inputs (carried across as numpy).

Tolerances, and why:
* the cohort CNN's forward and loss: both frameworks compute the same
  batched matmuls, summed in other orders: within 1e-6 (``atol = rtol``);
  gradients within 1e-5;
* a cohort round without the channel (p_s 1, p_q 32): 4 steps of prox-SGD
  compound those differences: within 1e-5;
* the channel itself is exact (tests/test_torch_channel.py), so on
  identical inputs it is compared bit for bit.  After training, weights
  that differ by about 1e-6 can fall on the other side of a bisection
  midpoint or of a quantization step: a channel-on round may differ in at
  most 1e-3 of its values;
* the event columns of a run (time, round, bytes) are exact: arrivals are
  priced from shapes and drawn from numpy before training; accuracy
  within ``ACC_TOL`` absolute per entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.codecs import ThresholdGraphCodec as JThresholdGraphCodec
from repro.fl import engine as jengine
from repro.fl.protocols import make_setup as jax_make_setup
from repro.fl.protocols import make_sim as jax_make_sim
from repro.fl.protocols import run_method as jax_run_method
from repro.fl.simulator import SimConfig as JSimConfig
from repro.models import cnn as jcnn
from repro_torch.fl import engine as tengine
from repro_torch.fl.protocols import make_setup, make_sim, run_method
from repro_torch.fl.simulator import SimConfig
from repro_torch.kernels import topk_quant as ttq
from repro_torch.models import cnn as tcnn
from repro_torch.utils.tree import from_numpy

from conftest import TINY_RUN_KW, TINY_SETUP
from torch_threads import one_torch_thread  # noqa: F401

ACC_TOL = 0.025
COLUMNS = ("time", "round", "bytes_up", "bytes_down", "max_model_bytes_up",
           "max_model_bytes_down")


@pytest.fixture(scope="module")
def setups():
    """(JAX setup, port setup), the port's w0 carried over from JAX's."""
    jdata, jparts, jw0 = jax_make_setup(**TINY_SETUP)
    w_np = {k: np.asarray(v) for k, v in jw0.items()}
    port = make_setup(**TINY_SETUP, device="cpu", init_params=w_np)
    return (jdata, jparts, jw0), port


def _stacked_weights(c, seed):
    """``c`` devices' CNN weights: JAX's init plus seeded noise each."""
    w = {k: np.asarray(v) for k, v in
         jcnn.init_cnn(jax.random.PRNGKey(seed)).items()}
    rng = np.random.RandomState(seed)
    return {k: (v[None] + rng.randn(c, *v.shape) * 0.02).astype(np.float32)
            for k, v in w.items()}


def _images(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape, 28, 28, 1).astype(np.float32),
            rng.randint(0, 10, shape).astype(np.int32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


# ----------------------------------------------------------------------
# the cohort CNN
# ----------------------------------------------------------------------
def test_cohort_cnn_matches_jax():
    """Forward, features and loss within 1e-6, gradients within 1e-5, for
    3 devices of 5 examples with their own weights."""
    w = _stacked_weights(3, 1)
    x, y = _images((3, 5), 2)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    tw = from_numpy(w, "cpu")
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jfeat, jlogits, (jloss, jgrads) = jax.jit(lambda w, x, y: (
        jcnn.cnn_cohort_features(w, x), jcnn.cnn_cohort_forward(w, x),
        jax.value_and_grad(jcnn.cnn_cohort_loss)(w, x, y)))(
            jw, jnp.asarray(x), jnp.asarray(y))
    _close(tcnn.cnn_cohort_features(tw, tx), jfeat, 1e-6)
    _close(tcnn.cnn_cohort_forward(tw, tx), jlogits, 1e-6)
    names = sorted(tw)
    params = [tw[k].clone().requires_grad_(True) for k in names]
    loss = tcnn.cnn_cohort_loss(dict(zip(names, params)), tx, ty)
    _close(loss, jloss, 1e-6)
    for k, g in zip(names, torch.autograd.grad(loss, params)):
        _close(g, jgrads[k], 1e-5)


def test_cohort_loss_of_a_stacked_singleton_is_the_serial_loss():
    w = {k: v[0] for k, v in _stacked_weights(1, 3).items()}
    x, y = _images((1, 6), 4)
    tw = from_numpy(w, "cpu")
    one = tcnn.cnn_cohort_loss({k: v[None] for k, v in tw.items()},
                               torch.from_numpy(x), torch.from_numpy(y))
    serial = tcnn.cnn_loss(tw, {"images": torch.from_numpy(x[0]),
                                "labels": torch.from_numpy(y[0])})
    _close(one, serial.detach().numpy(), 1e-6)


# ----------------------------------------------------------------------
# the cohort round
# ----------------------------------------------------------------------
def _round_inputs(c_pad):
    """A flush group of 3 tasks (4, 3 and 4 steps of 8 examples, padded to
    t_max 4) from 2 model versions over 4 devices' data, padded to the
    cohort bucket ``c_pad`` as ``CohortTrainer._flush_group`` pads it."""
    rng = np.random.RandomState(7)
    versions = _stacked_weights(2, 5)
    xs, ys = _images((4, 32), 8)
    steps, bs = (4, 3, 4), 8
    bidx = np.zeros((c_pad, 4, bs), np.int64)
    valid = np.zeros((c_pad, 4), np.float32)
    for i, t in enumerate(steps):
        bidx[i, :t] = rng.permutation(32)[:t * bs].reshape(t, bs)
        valid[i, :t] = 1.0
    vidx = np.zeros(c_pad, np.int64)
    didx = np.zeros(c_pad, np.int64)
    vidx[:3], didx[:3] = (1, 0, 1), (2, 0, 3)
    return (versions, vidx, xs, ys, didx, np.swapaxes(bidx, 0, 1).copy(),
            np.swapaxes(valid, 0, 1).copy())


def _both_rounds(c_pad, p_s, p_q):
    versions, vidx, xs, ys, didx, bidx, valid = _round_inputs(c_pad)
    kw = dict(lr=0.08, mu=0.01, p_s=p_s, p_q=p_q, iters=12)
    want = jengine._cohort_round(
        {k: jnp.asarray(v) for k, v in versions.items()},
        jnp.asarray(vidx, jnp.int32), jnp.asarray(xs), jnp.asarray(ys),
        jnp.asarray(didx, jnp.int32), jnp.asarray(bidx, jnp.int32),
        jnp.asarray(valid), cohort_loss=jcnn.cnn_cohort_loss, **kw)
    t = torch.from_numpy
    got = tengine._cohort_round(
        from_numpy(versions, "cpu"), t(vidx), t(xs), t(ys), t(didx),
        t(bidx), t(valid), cohort_loss=tcnn.cnn_cohort_loss, **kw)
    return got, want


@pytest.mark.parametrize("c_pad", [4, 8])
def test_cohort_round_matches_jax(c_pad):
    """Three tasks in the bucket of 4 (cohort_size 4) and of 8
    (cohort_size 8, whose tail bucket is 2): trained weights without the
    channel within 1e-5; the channel on the JAX round's trained weights
    bit for bit; the channel-on round within 1e-5 on all but at most 1e-3
    of its values.  The padded slots keep the received model, and the
    bucket changes the numbers (the loss is a mean over the padded
    cohort)."""
    got, want = _both_rounds(c_pad, 1.0, 32)
    for k in want:
        assert got[k].shape == want[k].shape
        _close(got[k], want[k], 1e-5)
    # the channel alone, on identical inputs
    p_s, p_q = (0.25, 8) if c_pad == 4 else (0.05, 4)
    chan = jax.jit(jax.vmap(JThresholdGraphCodec(p_s, p_q,
                                                 12).apply_tree))(want)
    mine = tengine._channel({k: torch.from_numpy(np.array(v))
                             for k, v in want.items()}, p_s, p_q, 12)
    for k in want:
        np.testing.assert_array_equal(mine[k].numpy().view(np.uint32),
                                      np.asarray(chan[k]).view(np.uint32))
    got_on, want_on = _both_rounds(c_pad, 0.25, 8)
    total = sum(v.size for v in want_on.values())
    off = sum(int((~np.isclose(got_on[k].numpy(), np.asarray(want_on[k]),
                               atol=1e-5, rtol=1e-5)).sum())
              for k in want_on)
    assert off <= 1e-3 * total, (off, total)
    # a padded slot (valid 0 everywhere) is the received version 0
    versions = _round_inputs(c_pad)[0]
    for k in want:
        np.testing.assert_array_equal(got[k][c_pad - 1].numpy(),
                                      versions[k][0])
    if c_pad == 8:
        other, _ = _both_rounds(4, 1.0, 32)
        assert not torch.equal(other["fc1"][:3], got["fc1"][:3])


def test_zero_step_round_matches_jax():
    """The channel twice on each of 2 versions, bit for bit."""
    versions = _stacked_weights(2, 9)
    want = jengine._zero_step_round(
        {k: jnp.asarray(v) for k, v in versions.items()}, p_s=0.1, p_q=4,
        iters=12)
    got = tengine._zero_step_round(from_numpy(versions, "cpu"), p_s=0.1,
                                   p_q=4, iters=12)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy().view(np.uint32),
                                      np.asarray(want[k]).view(np.uint32))


def test_cohort_trainer_submit_matches_jax(setups):
    """The deferred buffer draws each task's minibatches from its own RNG
    in the JAX order (ragged partitions, one below the batch size: no
    step), dedupes versions by object identity, and flushes a full
    cohort."""
    (jdata, _, jw0), (data, _, w0) = setups
    sizes = (80, 120, 30, 95)
    parts = [np.arange(s, dtype=np.int64) + 10 * i
             for i, s in enumerate(sizes)]
    kw = dict(method="teastatic", n_devices=4, seed=5, epochs=2,
              cohort_size=3, p_s=0.25, p_q=8)
    jeng = jax_make_sim(jdata, parts, jw0, JSimConfig(**kw))
    teng = make_sim(data, parts, w0, SimConfig(**kw), device="cpu")
    w_other = {k: v + 0 for k, v in w0.items()}
    jw_other = {k: v + 0 for k, v in jw0.items()}
    for k, jw, tw in ((0, jw0, w0), (2, jw0, w0), (1, jw_other, w_other)):
        jt = jeng.trainer.submit(k, jw, 0, 0.25, 8)
        tt = teng.trainer.submit(k, tw, 0, 0.25, 8)
        np.testing.assert_array_equal(tt.bidx, jt.bidx)
        assert (tt.version, tt.n_k) == (jt.version, jt.n_k)
    assert teng.stats.flushes == jeng.stats.flushes == 1
    assert teng.stats.flushed_tasks == 3 and not teng.trainer.pending
    assert teng.trainer.buckets == jeng.trainer.buckets == [1, 3]
    w_local, n_k = teng.resolve_payload(tt)
    assert n_k == 120 and w_local["fc1"].shape == w0["fc1"].shape


# ----------------------------------------------------------------------
# whole runs against a live JAX run
# ----------------------------------------------------------------------
def _assert_parity(h_jax, h_port):
    assert len(h_jax) == len(h_port) > 1
    for a, b in zip(h_jax, h_port):
        for c in COLUMNS:
            assert getattr(a, c) == getattr(b, c), c
        assert abs(a.accuracy - b.accuracy) <= ACC_TOL


@pytest.mark.parametrize("method,cohort_size", [
    ("tea", 4), ("teas", 4), ("teaq", 4), ("teasq", 4), ("teasq", 8)])
def test_cohort_run_matches_live_jax(setups, method, cohort_size):
    """run_method on the cohort trainer (tail flushes in the small bucket
    included): the time, round and byte columns equal, accuracy within
    ACC_TOL."""
    (jdata, jparts, jw0), (data, parts, w0) = setups
    kw = dict(TINY_RUN_KW, p_s=0.25, p_q=8, cohort_size=cohort_size)
    h_jax = jax_run_method(method, jdata, jparts, jw0, **kw)
    h_port = run_method(method, data, parts, w0, device="cpu", **kw)
    _assert_parity(h_jax, h_port)
    assert h_port[-1].round >= 3


def test_threshold_codec_run_matches_live_jax(setups):
    """The serial trainer with codec="threshold": the channel (kernel B's
    channel form on the card, its plain version here) runs twice per
    dispatch inside the run."""
    (jdata, jparts, jw0), (data, parts, w0) = setups
    kw = dict(TINY_RUN_KW, p_s=0.25, p_q=8, codec="threshold")
    h_jax = jax_run_method("teasq", jdata, jparts, jw0, **kw)
    before = ttq.LAUNCHES
    h_port = run_method("teasq", data, parts, w0, device="cpu", **kw)
    assert ttq.LAUNCHES == before           # CPU: the plain version
    _assert_parity(h_jax, h_port)
