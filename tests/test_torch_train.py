"""The port's trainer (``launch/train.py``) against the JAX package's, on
the CPU.

``train.main([... "--smoke", "--device", "cpu"], params=...)`` from the
JAX package's weights, against the JAX trainer's own pieces on the same
arguments: its batch stream (one ``np.random.RandomState(seed)``: tokens,
then frames or patches), ``jax.jit`` of its AdamW step (``lm_loss``, its
gradient, ``clip_by_global_norm`` at 1.0) or of ``make_fed_train_step``.

* Every architecture the JAX trainer runs at ``--smoke`` (attention, MoE,
  hybrid, encoder-decoder, VLM, SSM, CNN): one federated round of E = 2
  local steps under each schedule, and two AdamW steps, with the params
  compared leaf by leaf.  ``gather_f32`` and ``psum`` within
  ``PARAM_TOL``; ``gather_q`` by ``tests/torch_fed_rules.py``'s rule
  (within a quantization step, a threshold flip on at most 0.1% of the
  elements); AdamW by the like rule for its per-element normalized step
  (past ``PARAM_TOL`` on at most 0.1% of the elements, all within 2 lr a
  step: the elements whose gradient is at float-noise level).  The round's learning rate is large enough that its
  update is far above ``PARAM_TOL`` (the test asserts so), and the SGD
  update is linear in the gradient, so a wrong gradient under the group
  ``vmap`` shows in the params.  The AdamW steps also compare the
  clipped gradient's global norm, which a gradient wrong by a scale
  would move.
* SmolLM-135M and Mamba2-370M: three steps in both modes, per-step losses
  within ``LOSS_TOL`` (the trainer's loop over the batch stream).
  Mamba2's fed round takes kernel C's plain version through its autograd
  Function under the group vmap.

The checkpoint of ``--ckpt`` loads in the JAX package.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jax_load_pytree
from repro.configs.base import ARCH_IDS
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core.fed_step import FedConfig as JFedConfig
from repro.core.fed_step import make_fed_train_step as jax_fed_step
from repro.data import make_token_batch
from repro.models import transformer as JT
from repro.optim import adamw, apply_updates, clip_by_global_norm
from repro_torch.configs.base import get_smoke_config
from repro_torch.core import fed_step as F
from repro_torch.kernels import ops
from repro_torch.kernels import topk_quant as B
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.utils.tree import from_numpy, leaves

from torch_fed_rules import (FLIP_SHARE, assert_gather_q_close,
                             port_quant_stats)
from torch_threads import one_torch_thread  # noqa: F401

LOSS_TOL = 1e-4
PARAM_TOL = 1e-5
ARGS = dict(batch=8, seq=16, lr=3e-4, groups=4, seed=0)
ROUND = dict(local_steps=2, lr=0.05)     # the every-arch fed round
SCHEDULES = ("gather_q", "gather_f32", "psum")


def _argv(arch, mode, steps, schedule="gather_q", local_steps=1,
          lr=ARGS["lr"]):
    return ["--arch", arch, "--smoke", "--mode", mode, "--steps",
            str(steps), "--batch", str(ARGS["batch"]), "--seq",
            str(ARGS["seq"]), "--fed-schedule", schedule, "--local-steps",
            str(local_steps), "--lr", str(lr), "--device", "cpu"]


@functools.lru_cache(maxsize=None)
def _init(arch):
    cfg = jax_smoke_config(arch)
    return cfg, JT.init_model(jax.random.PRNGKey(ARGS["seed"]), cfg)


def _batches(cfg, n):
    """The JAX trainer's first ``n`` batches."""
    rng = np.random.RandomState(ARGS["seed"])
    out = []
    for _ in range(n):
        b = make_token_batch(rng, ARGS["batch"], ARGS["seq"], cfg.vocab)
        batch = {"tokens": jnp.asarray(b["tokens"])}
        if cfg.is_encoder_decoder:
            batch["frames"] = jnp.asarray(rng.randn(
                ARGS["batch"], cfg.enc_seq, cfg.d_model), jnp.float32)
        if cfg.n_patches:
            batch["patches"] = jnp.asarray(rng.randn(
                ARGS["batch"], cfg.n_patches, cfg.d_model), jnp.float32)
        out.append(batch)
    return out


def _loss(cfg):
    return lambda p, b: JT.lm_loss(p, b, cfg)[0]


@functools.lru_cache(maxsize=None)
def _jax_rounds(arch):
    """The JAX trainer's jitted ``gather_q`` and ``gather_f32`` rounds at
    ``ROUND``.  Without a mesh the reference's ``psum`` round is its
    ``gather_f32`` one (the same dense combine, ``fed_step.py:221-225``),
    so the port's ``psum`` round is held against that."""
    cfg, _ = _init(arch)
    return {s: jax.jit(jax_fed_step(_loss(cfg), JFedConfig(
        n_groups=ARGS["groups"], schedule=s, **ROUND)))
        for s in ("gather_q", "gather_f32")}


@functools.lru_cache(maxsize=None)
def _jax_plain(arch, steps):
    """The JAX trainer's AdamW steps: per-step losses and clipped global
    norms, and the final params."""
    cfg, params = _init(arch)
    opt = adamw(ARGS["lr"])
    state = opt.init(params)

    @jax.jit
    def step(p, s, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda q: JT.lm_loss(q, batch, cfg), has_aux=True)(p)
        grads, gn = clip_by_global_norm(grads, 1.0)
        upd, s = opt.update(grads, s, p)
        return apply_updates(p, upd), s, loss, gn

    losses, norms = [], []
    for batch in _batches(cfg, steps):
        params, state, loss, gn = step(params, state, batch)
        losses.append(float(loss))
        norms.append(float(gn))
    return losses, norms, params


def _port(arch, argv):
    _, w0 = _init(arch)
    tw = from_numpy(jax.tree.map(np.asarray, w0), "cpu")
    return train.main(argv, params=tw)


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("mode", ["plain", "fed"])
@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-370m"])
def test_train_matches_jax(arch, mode, capsys):
    key = arch.replace("-", "_")     # shares the cached JAX runs below
    cfg, params = _init(key)
    if mode == "fed":
        step, want = _jax_rounds(key)["gather_q"], []
        stale = jnp.zeros((ARGS["groups"],), jnp.int32)
        for batch in _batches(cfg, 3):
            params, m = step(params, batch, stale)
            want.append(float(m["local_loss"]))
        argv = _argv(arch, mode, 3, **ROUND)
    else:
        want, argv = _jax_plain(key, 3)[0], _argv(arch, mode, 3)
    _, hist = _port(key, argv)
    got = [h["local_loss" if mode == "fed" else "loss"] for h in hist]
    assert len(got) == 3
    np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=0)
    out = capsys.readouterr().out
    tag = "[fed round   2]" if mode == "fed" else "[step   2]"
    assert tag in out and "[train]" in out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_trains_one_fed_round(arch):
    """One round of 2 local steps under each schedule, params leaf by leaf
    against the JAX round from the same weights and batch."""
    cfg, w0 = _init(arch)
    batch = _batches(cfg, 1)[0]
    stale = jnp.zeros((ARGS["groups"],), jnp.int32)
    want = {s: r(w0, batch, stale) for s, r in _jax_rounds(arch).items()}
    want["psum"] = want["gather_f32"]
    w0_np = _np_leaves(w0)
    update = max(float(np.abs(a - b).max()) for a, b in
                 zip(_np_leaves(want["gather_f32"][0]), w0_np))
    assert update > 100 * PARAM_TOL, update
    for s in SCHEDULES:
        params, hist = _port(arch, _argv(arch, "fed", 1, s, **ROUND))
        pj, mj = want[s]
        assert abs(hist[0]["local_loss"] - float(mj["local_loss"])) \
            <= LOSS_TOL
        assert hist[0]["alpha_t"] == float(mj["alpha_t"])
        got = [x.numpy() for x in leaves(params)]
        if s != "gather_q":
            for g, w in zip(got, _np_leaves(pj)):
                np.testing.assert_allclose(g, w, atol=PARAM_TOL, rtol=0)
            continue
        tcfg = get_smoke_config(arch)
        fed = F.FedConfig(n_groups=ARGS["groups"], **ROUND)
        stats = port_quant_stats(
            lambda p, b: T.lm_loss(p, b, tcfg)[0], fed,
            from_numpy(jax.tree.map(np.asarray, w0), "cpu"),
            {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
        assert_gather_q_close(got, _np_leaves(pj), stats, fed.p_q)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_trains_plain(arch):
    """Three AdamW steps: losses, the clipped gradient's global norm and
    the params leaf by leaf against the JAX trainer's."""
    losses, norms, pj = _jax_plain(arch, 3)
    params, hist = _port(arch, _argv(arch, "plain", 3))
    np.testing.assert_allclose([h["loss"] for h in hist], losses,
                               atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose([h["gnorm"] for h in hist], norms,
                               rtol=1e-5)
    # AdamW steps every element by about lr in the direction of its
    # gradient's moments, however small the gradient: where a gradient is
    # at float-noise level (about eps), the two packages' steps may differ
    # by up to 2 lr each.  So: within 2 lr a step everywhere, and past
    # PARAM_TOL on at most FLIP_SHARE of the elements.
    gap = 2 * ARGS["lr"] * len(hist) * (1 + 1e-6)
    far = total = 0
    for g, w in zip(leaves(params), _np_leaves(pj)):
        err = np.abs(g.numpy() - w)
        assert float(err.max()) <= gap, (float(err.max()), gap)
        far += int((err > PARAM_TOL).sum())
        total += err.size
    assert far <= FLIP_SHARE * total, (far, total)


def test_checkpoint_loads_in_the_jax_package(tmp_path):
    path = str(tmp_path / "smollm.msgpack")
    jp = _jax_plain("smollm_135m", 3)[2]
    params, _ = _port("smollm_135m", _argv("smollm_135m", "plain", 3) +
                      ["--ckpt", path])
    back = jax_load_pytree(path, jp)
    for a, b in zip(jax.tree.leaves(back), leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_without_a_device_it_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "smollm-135m", "--smoke", "--steps", "1"])


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="schedule"):
        train.main(_argv("smollm-135m", "fed", 1, "ring"))


# ----------------------------------------------------------------------
# on the card (skipped here)
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python3 chip_smoke.py phases 35 "
                    "and 36 check the fed round's compressor there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_round_compressor_on_card(card):
    """The gather_q round's compressor on SmolLM's smoke leaves as (4, n)
    delta rows: kernel B's channel form on the card equals its plain
    version, and launches."""
    w = from_numpy(jax.tree.map(np.asarray, JT.init_model(
        jax.random.PRNGKey(0), jax_smoke_config("smollm_135m"))), card)
    rng = np.random.RandomState(1)
    rows = [torch.from_numpy((rng.randn(4, x.numel()) * 1e-3).astype(
        np.float32)).to(card) for x in leaves(w)]
    fed = F.FedConfig(n_groups=4)
    before = B.LAUNCHES
    got = ops.threshold_channel_leaves(rows, fed.p_s, fed.p_q,
                                       fed.threshold_iters)
    assert B.LAUNCHES > before
    want = B.threshold_channel_plain(rows, fed.p_s, fed.p_q,
                                     fed.threshold_iters)
    for g, p in zip(got, want):
        assert torch.equal(g, p)
