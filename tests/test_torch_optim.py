"""The port's functional optimizers against the JAX package's, on the CPU.

The same nested tree and the same five gradients (seeded numpy) go
through ``sgd`` (with and without momentum), ``adamw`` (with weight decay,
and under a cosine schedule) and ``clip_by_global_norm`` in both packages;
the params after five steps agree within 1e-6 relative.  The optimizer
state keeps the JAX layout: it crosses the port's ``save_pytree`` into the
JAX package's ``load_pytree``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jax_load_pytree
from repro.optim import optimizers as J
from repro_torch.checkpoint import save_pytree
from repro_torch.optim import optimizers as T
from repro_torch.utils.tree import from_numpy, leaves

from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-6
STEPS = 5


def _tree(rng):
    return {"w": rng.randn(6, 4).astype(np.float32),
            "blk": {"b": rng.randn(5).astype(np.float32),
                    "k": rng.randn(3, 2, 2).astype(np.float32)}}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    return _tree(rng), [_tree(rng) for _ in range(STEPS)]


OPTIMIZERS = {
    "sgd": lambda M: M.sgd(0.1),
    "sgd_momentum": lambda M: M.sgd(0.1, momentum=0.9),
    "adamw": lambda M: M.adamw(1e-2, weight_decay=0.1),
    "adamw_cosine": lambda M: M.adamw(M.cosine_schedule(1e-2, 2, STEPS)),
}


def _run_jax(make, params, grads, clip):
    opt = make(J)
    p = jax.tree.map(jnp.asarray, params)
    s = opt.init(p)
    for g in grads:
        g = jax.tree.map(jnp.asarray, g)
        if clip:
            g, _ = J.clip_by_global_norm(g, 1.0)
        u, s = opt.update(g, s, p)
        p = J.apply_updates(p, u)
    return p, s


def _run_port(make, params, grads, clip):
    opt = make(T)
    p = from_numpy(params, "cpu")
    s = opt.init(p)
    for g in grads:
        g = from_numpy(g, "cpu")
        if clip:
            g, _ = T.clip_by_global_norm(g, 1.0)
        u, s = opt.update(g, s, p)
        p = T.apply_updates(p, u)
    return p, s


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax(inputs, name, clip):
    params, grads = inputs
    pj, sj = _run_jax(OPTIMIZERS[name], params, grads, clip)
    pt, st = _run_port(OPTIMIZERS[name], params, grads, clip)
    for a, b in zip(jax.tree.leaves(pj), leaves(pt)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=1e-7)
    assert int(st["step"]) == int(sj["step"]) == STEPS
    assert st["step"].dtype == torch.int32
    assert sorted(st) == sorted(sj)
    for key in ("m", "v", "mu"):
        if key in sj and sj[key] is not None:
            for a, b in zip(jax.tree.leaves(sj[key]), leaves(st[key])):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=RTOL, atol=1e-7)
        elif key in sj:
            assert st[key] is None


def test_clip_by_global_norm_matches_jax(inputs):
    _, grads = inputs
    for max_norm in (0.5, 1e3):
        gj, nj = J.clip_by_global_norm(jax.tree.map(jnp.asarray, grads[0]),
                                       max_norm)
        gt, nt = T.clip_by_global_norm(from_numpy(grads[0], "cpu"),
                                       max_norm)
        assert float(nt) == pytest.approx(float(nj), rel=RTOL)
        for a, b in zip(jax.tree.leaves(gj), leaves(gt)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL)


def test_cosine_schedule_matches_jax():
    jf, tf = J.cosine_schedule(3e-4, 3, 10), T.cosine_schedule(3e-4, 3, 10)
    for step in range(13):
        want = float(jf(jnp.asarray(step, jnp.int32)))
        assert float(tf(torch.tensor(step, dtype=torch.int32))) == \
            pytest.approx(want, rel=RTOL)
        assert float(tf(step)) == pytest.approx(float(jf(step)), rel=RTOL)


@pytest.mark.parametrize("name", ["adamw", "sgd", "sgd_momentum"])
def test_state_crosses_into_the_jax_checkpoint(inputs, tmp_path, name):
    params, grads = inputs
    _, st = _run_port(OPTIMIZERS[name], params, grads, False)
    _, sj = _run_jax(OPTIMIZERS[name], params, grads, False)
    path = str(tmp_path / "opt.msgpack")
    save_pytree(path, st)
    back = jax_load_pytree(path, sj)
    assert int(back["step"]) == STEPS
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(sj)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                                   atol=1e-7)
