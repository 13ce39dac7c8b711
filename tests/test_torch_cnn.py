"""The port's CNN, local update and aggregation against the JAX package's,
on the CPU, from the same weights and inputs (carried across as numpy).

Float tolerances, and why:
* forward (logits, features): XLA and PyTorch sum the convolutions and
  matmuls in other orders, so f32 results differ in the last bits:
  ``atol=1e-5, rtol=1e-5`` on values of order 1;
* gradients: the same sums in backward, ``atol=1e-6, rtol=1e-4``;
* one epoch of local prox-SGD (15 steps): the step-by-step differences
  compound, ``atol=2e-5, rtol=1e-4``;
* aggregation: the same f32 expression in the same reduction order, but
  the normalized weights and alpha^t may differ in their last bit, and
  every term of the sum carries that difference: within 4 ulp of the
  leaf's largest magnitude (``_assert_few_ulp``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.client import local_update as jax_local_update
from repro.core.server import ServerConfig as JServerConfig
from repro.core.server import TeasqServer as JTeasqServer
from repro.core.staleness import aggregate_cache as jax_aggregate_cache
from repro.core.staleness import \
    stacked_staleness_weights as jax_stacked_weights
from repro.core.staleness import staleness_weight as jax_staleness_weight
from repro.models import cnn as jcnn
from repro_torch.core.client import local_update
from repro_torch.core.server import ServerConfig, TeasqServer, make_server
from repro_torch.core.staleness import (aggregate_cache,
                                        stacked_staleness_weights,
                                        staleness_weight)
from repro_torch.models import cnn as tcnn
from repro_torch.utils.tree import from_numpy, to_numpy

from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def weights():
    """JAX's own init, with nonzero biases so every leaf is exercised."""
    w = {k: np.asarray(v) for k, v in
         jcnn.init_cnn(jax.random.PRNGKey(3)).items()}
    rng = np.random.RandomState(0)
    for k in ("b1", "b2", "bf1", "bf2"):
        w[k] = (rng.randn(*w[k].shape) * 0.05).astype(np.float32)
    return w


def _images(n, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 28, 28, 1).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int32))


def test_forward_features_loss_accuracy(weights):
    x, y = _images(16)
    tw = from_numpy(weights, "cpu")
    jw = {k: jnp.asarray(v) for k, v in weights.items()}
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(tcnn.cnn_forward(tw, tx).numpy(),
                               np.asarray(jcnn.cnn_forward(jw, x)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tcnn.cnn_features(tw, tx).numpy(),
                               np.asarray(jcnn.cnn_features(jw, x)),
                               atol=1e-5, rtol=1e-5)
    batch_j = {"images": x, "labels": y}
    batch_t = {"images": tx, "labels": ty}
    np.testing.assert_allclose(float(tcnn.cnn_loss(tw, batch_t)),
                               float(jcnn.cnn_loss(jw, batch_j)),
                               atol=1e-5, rtol=1e-5)
    assert float(tcnn.cnn_accuracy(tw, tx, ty)) == \
        float(jcnn.cnn_accuracy(jw, x, y))
    module = tcnn.CNN(tw)
    with torch.no_grad():
        assert torch.equal(module(tx), tcnn.cnn_forward(tw, tx))
    assert sorted(module.params()) == sorted(weights)


def test_gradients(weights):
    x, y = _images(40, seed=2)
    jw = {k: jnp.asarray(v) for k, v in weights.items()}
    jg = jax.grad(jcnn.cnn_loss)(jw, {"images": x, "labels": y})
    tw = {k: v.requires_grad_(True)
          for k, v in from_numpy(weights, "cpu").items()}
    loss = tcnn.cnn_loss(tw, {"images": torch.from_numpy(x),
                              "labels": torch.from_numpy(y)})
    names = sorted(tw)
    tg = torch.autograd.grad(loss, [tw[k] for k in names])
    for k, g in zip(names, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]),
                                   atol=1e-6, rtol=1e-4, err_msg=k)


def test_init_cnn_shapes_and_bounds():
    w = tcnn.init_cnn(torch.Generator().manual_seed(0), device="cpu")
    jw = jcnn.init_cnn(jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in w.items()} == \
        {k: tuple(v.shape) for k, v in jw.items()}
    assert all(v.dtype == torch.float32 for v in w.values())
    for k in ("conv1", "conv2", "fc1", "fc2"):
        bound = float(np.abs(np.asarray(jw[k])).max())
        assert float(w[k].abs().max()) <= bound * 1.01 + 1e-3
    again = tcnn.init_cnn(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)


@pytest.mark.parametrize("make", ["init_cnn", "task"])
def test_cnn_init_follows_the_device_rule(make, monkeypatch):
    """With no device named the weights go to the card, and with no card
    the constructor raises (it never falls back to the CPU); a named
    device is used as given."""
    from repro_torch.fl.tasks import get_task
    init = (tcnn.init_cnn if make == "init_cnn"
            else get_task("fmnist_cnn").init_params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init(torch.Generator().manual_seed(0))
    w = init(torch.Generator().manual_seed(0), device="cpu")
    assert all(v.device.type == "cpu" for v in w.values())


def test_local_update_one_epoch(weights):
    """Same minibatch order (one rng.permutation per epoch), same Eq. 5
    update: the weights after one epoch of 15 steps agree."""
    x, y = _images(600, seed=3)
    jw = {k: jnp.asarray(v) for k, v in weights.items()}
    kw = dict(epochs=1, batch_size=40, lr=0.08, mu=0.01)
    jout, jloss, jsteps = jax_local_update(
        jw, x, y, jcnn.cnn_loss, rng=np.random.RandomState(4), **kw)
    tout, tloss, tsteps = local_update(
        from_numpy(weights, "cpu"), torch.from_numpy(x), torch.from_numpy(y),
        tcnn.cnn_loss, rng=np.random.RandomState(4), **kw)
    assert tsteps == jsteps == 15
    np.testing.assert_allclose(tloss, jloss, atol=2e-5, rtol=1e-4)
    for k in weights:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=2e-5, rtol=1e-4, err_msg=k)


def _assert_few_ulp(got, want):
    atol = 4 * np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _cache(weights, k=5, t=7):
    rng = np.random.RandomState(5)
    entries = []
    for i in range(k):
        upd = {n: (v + rng.randn(*v.shape).astype(np.float32) * 0.01)
               for n, v in weights.items()}
        entries.append((upd, int(rng.randint(0, t + 1)),
                        int(rng.randint(100, 700))))
    return entries


def test_aggregate_cache_within_a_few_ulp(weights):
    cache = _cache(weights)
    want = jax_aggregate_cache(
        {k: jnp.asarray(v) for k, v in weights.items()},
        [({k: jnp.asarray(v) for k, v in u.items()}, h, n)
         for u, h, n in cache], 7, 0.6, 0.5)
    got = aggregate_cache(from_numpy(weights, "cpu"),
                          [(from_numpy(u, "cpu"), h, n)
                           for u, h, n in cache], 7, 0.6, 0.5)
    for k in weights:
        _assert_few_ulp(got[k].numpy(), np.asarray(want[k]))


def test_staleness_weights():
    st = np.float32([0, 1, 3, 10])
    np.testing.assert_array_max_ulp(
        staleness_weight(torch.from_numpy(st), 0.5).numpy(),
        np.asarray(jax_staleness_weight(st, 0.5)), maxulp=1)
    n = np.float32([600, 300, 50, 1000])
    np.testing.assert_array_max_ulp(
        stacked_staleness_weights(torch.from_numpy(st), n, 0.5).numpy(),
        np.asarray(jax_stacked_weights(jnp.asarray(st), n, 0.5)), maxulp=2)


def test_server_rounds_match(weights):
    """The admission gate and cache fill are integer bookkeeping (exact);
    the aggregated weights agree to a few ulp."""
    jsrv = JTeasqServer({k: jnp.asarray(v) for k, v in weights.items()},
                        JServerConfig(20, 0.15, 0.1))
    tsrv = make_server("single", from_numpy(weights, "cpu"),
                       ServerConfig(20, 0.15, 0.1))
    assert isinstance(tsrv, TeasqServer)
    grants = [(jsrv.try_dispatch(), tsrv.try_dispatch()) for _ in range(4)]
    assert [g[1] is None for g in grants] == [g[0] is None for g in grants]
    for u, h, n in _cache(weights, k=4, t=0):
        done_j = jsrv.receive({k: jnp.asarray(v) for k, v in u.items()}, h, n)
        done_t = tsrv.receive(from_numpy(u, "cpu"), h, n)
        assert done_j == done_t
        assert (jsrv.t, jsrv.active) == (tsrv.t, tsrv.active)
    assert tsrv.t == 2
    for k, v in to_numpy(tsrv.w).items():
        _assert_few_ulp(v, np.asarray(jsrv.w[k]))
    # the sharded server outside a world is the same machine, bit for bit
    ssrv = make_server("sharded", from_numpy(weights, "cpu"),
                       ServerConfig(20, 0.15, 0.1))
    ssrv.active = tsrv.active
    for u, h, n in _cache(weights, k=4, t=0):
        ssrv.receive(from_numpy(u, "cpu"), h, n)
    assert ssrv.n_shards == 1 and ssrv.t == tsrv.t
    for k, v in ssrv.w.items():
        assert torch.equal(v, tsrv.w[k])
