"""The port's MLP (``fmnist_mlp``) against the JAX package's, on the CPU,
from the same weights and inputs (carried across as numpy).

Float tolerances, and why:
* forward, features, loss: XLA and PyTorch sum the 784-long and 64-long
  dot products in other orders: ``atol=1e-5, rtol=1e-5`` on values of
  order 1;
* gradients, serial and cohort: the same sums in backward, ``atol=1e-6,
  rtol=1e-4``;
* an engine run: the time, round and byte columns exact (numpy draws and
  shape-only sizes), accuracy within ``ACC_TOL`` absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl.protocols import make_setup as jax_make_setup
from repro.fl.protocols import run_method as jax_run_method
from repro.models import mlp as jmlp
from repro_torch.fl.protocols import make_setup, run_method
from repro_torch.fl.tasks import get_task
from repro_torch.models import mlp as tmlp
from repro_torch.utils.tree import from_numpy

from conftest import TINY_RUN_KW, TINY_SETUP
from torch_threads import one_torch_thread  # noqa: F401

ACC_TOL = 0.025
COLUMNS = ("time", "round", "bytes_up", "bytes_down", "max_model_bytes_up",
           "max_model_bytes_down")


@pytest.fixture(scope="module")
def weights():
    """JAX's own init, with nonzero biases so every leaf is exercised."""
    w = {k: np.asarray(v) for k, v in
         jmlp.init_mlp(jax.random.PRNGKey(3)).items()}
    rng = np.random.RandomState(0)
    for k in ("b1", "b2"):
        w[k] = (rng.randn(*w[k].shape) * 0.05).astype(np.float32)
    return w


def _images(shape, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape, 28, 28, 1).astype(np.float32),
            rng.randint(0, 10, shape).astype(np.int32))


def test_forward_features_loss_accuracy(weights):
    x, y = _images((16,))
    tw = from_numpy(weights, "cpu")
    jw = {k: jnp.asarray(v) for k, v in weights.items()}
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(tmlp.mlp_forward(tw, tx).numpy(),
                               np.asarray(jmlp.mlp_forward(jw, x)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tmlp.mlp_features(tw, tx).numpy(),
                               np.asarray(jmlp.mlp_features(jw, x)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        float(tmlp.mlp_loss(tw, {"images": tx, "labels": ty})),
        float(jmlp.mlp_loss(jw, {"images": x, "labels": y})),
        atol=1e-5, rtol=1e-5)
    assert float(tmlp.mlp_accuracy(tw, tx, ty)) == \
        float(jmlp.mlp_accuracy(jw, x, y))


def test_gradients(weights):
    x, y = _images((40,), seed=2)
    jw = {k: jnp.asarray(v) for k, v in weights.items()}
    jg = jax.grad(jmlp.mlp_loss)(jw, {"images": x, "labels": y})
    tw = {k: v.requires_grad_(True)
          for k, v in from_numpy(weights, "cpu").items()}
    loss = tmlp.mlp_loss(tw, {"images": torch.from_numpy(x),
                              "labels": torch.from_numpy(y)})
    names = sorted(tw)
    tg = torch.autograd.grad(loss, [tw[k] for k in names])
    for k, g in zip(names, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]),
                                   atol=1e-6, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("c", [1, 3])
def test_cohort_loss_and_gradients(weights, c):
    """Per-device weights (C, ...) on (C, B) examples: the loss and its
    gradients against the JAX cohort loss."""
    rng = np.random.RandomState(c)
    stacked = {k: np.stack([v + (rng.randn(*v.shape) * 0.01).astype(
        np.float32) for _ in range(c)]) for k, v in weights.items()}
    x, y = _images((c, 8), seed=3)
    jw = {k: jnp.asarray(v) for k, v in stacked.items()}
    jl, jg = jax.value_and_grad(jmlp.mlp_cohort_loss)(jw, x, y)
    tw = {k: v.requires_grad_(True)
          for k, v in from_numpy(stacked, "cpu").items()}
    tl = tmlp.mlp_cohort_loss(tw, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=1e-5,
                               rtol=1e-5)
    names = sorted(tw)
    tg = torch.autograd.grad(tl, [tw[k] for k in names])
    for k, g in zip(names, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]),
                                   atol=1e-6, rtol=1e-4, err_msg=k)


def test_init_mlp_shapes_bounds_and_device_rule(monkeypatch):
    w = tmlp.init_mlp(torch.Generator().manual_seed(0), device="cpu")
    jw = jmlp.init_mlp(jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in w.items()} == \
        {k: tuple(v.shape) for k, v in jw.items()}
    assert all(v.dtype == torch.float32 for v in w.values())
    assert float(w["w1"].abs().max()) <= 1 / np.sqrt(784)
    assert float(w["w2"].abs().max()) <= 1 / np.sqrt(64)
    assert not w["b1"].any() and not w["b2"].any()
    task = get_task("fmnist_mlp")
    assert task.cohort_loss is tmlp.mlp_cohort_loss
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        task.init_params(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("method,extra", [
    ("teasq", {}),
    ("fedasync", dict(p_s=1.0, p_q=32)),
    ("teasq", dict(cohort_size=4, codec="packed")),
    ("moon", {}),
], ids=["teasq", "fedasync", "teasq_cohort", "moon"])
def test_fmnist_mlp_runs_match_live_jax(method, extra):
    """The task end to end through ``run_method``: the serial and cohort
    trainers, and MOON's contrastive features."""
    setup = dict(TINY_SETUP, task="fmnist_mlp")
    jdata, jparts, jw0 = jax_make_setup(**setup)
    w_np = {k: np.asarray(v) for k, v in jw0.items()}
    data, parts, w0 = make_setup(**setup, device="cpu", init_params=w_np)
    np.testing.assert_array_equal(data["x_train"], jdata["x_train"])
    kw = dict(TINY_RUN_KW, task="fmnist_mlp", **extra)
    h_jax = jax_run_method(method, jdata, jparts, jw0, **kw)
    h_port = run_method(method, data, parts, w0, device="cpu", **kw)
    assert len(h_jax) == len(h_port) > 2
    for a, b in zip(h_jax, h_port):
        for c in COLUMNS:
            assert getattr(a, c) == getattr(b, c), c
        assert abs(a.accuracy - b.accuracy) <= ACC_TOL
