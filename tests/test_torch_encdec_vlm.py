"""The port's encoder-decoder (Whisper-tiny) and VLM (InternVL2-2B)
branches of ``models/transformer.py`` against the JAX package's, on the
CPU at their smoke configs, from the JAX package's weights carried across
with ``utils.tree.from_numpy``.

Tolerances: logits, caches and losses within 1e-4 (atol = rtol) against
JAX, f32 products summed in another order through two encoder and two
decoder layers; gradients within ``atol=1e-5, rtol=1e-4``; the port's own
prefill-against-forward check at the JAX tests' 2e-5; greedy tokens
equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.launch import serve as JS
from repro.models import transformer as JT
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.launch.serve import generate
from repro_torch.models import transformer as T
from repro_torch.utils.tree import from_numpy, leaves, to_numpy

from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
CONSISTENCY_TOL = 2e-5
ARCHS = ["whisper_tiny", "internvl2_2b"]


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(port cfg, JAX cfg, JAX params, the same params in the port)."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    return cfg, jcfg, jp, from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _batch(cfg, B, S, seed):
    """numpy {tokens, frames | patches}."""
    rng = np.random.RandomState(seed)
    b = {"tokens": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        b["frames"] = rng.randn(B, cfg.enc_seq, cfg.d_model).astype(
            np.float32)
    else:
        b["patches"] = rng.randn(B, cfg.n_patches, cfg.d_model).astype(
            np.float32)
    return b


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.__dict__ == jcfg.__dict__
    assert get_smoke_config(arch).__dict__ == jax_smoke_config(arch).__dict__
    assert cfg.param_count() == jcfg.param_count() == {
        "whisper_tiny": 61_073_664, "internvl2_2b": 1_889_144_832}[arch]
    tcfg, _, jp, tp = _model(arch)
    assert jax.tree.map(lambda a: tuple(a.shape), to_numpy(tp)) == \
        jax.tree.map(lambda a: a.shape, jp)
    mine = T.init_model(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), to_numpy(mine)) == \
        jax.tree.map(lambda a: a.shape, jp)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    cfg, jcfg, jp, tp = _model(arch)
    b = _batch(cfg, 2, 8, 1)
    want, _ = JT.forward(jp, _j(b), jcfg)
    got, aux = T.forward(tp, _t(b), cfg)
    assert tuple(got.shape) == (2, 8, cfg.vocab)
    _close(got, want)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """``encdec_prefill`` (Whisper) or ``prefill`` with the patches (the
    VLM): last logits against JAX and against the port's own
    ``forward``, every cache leaf against JAX, ``extend_cache`` leaving
    the cross caches as they are, then three ``decode_step``s against
    JAX's."""
    cfg, jcfg, jp, tp = _model(arch)
    S, n = 8, 3
    b = _batch(cfg, 2, S + n, 2)
    full, _ = T.forward(tp, _t(b), cfg)
    pb = dict(b, tokens=b["tokens"][:, :S])
    if cfg.is_encoder_decoder:
        got, cache = T.encdec_prefill(tp, _t(pb), cfg, cache_len=S)
        want, jcache = JT.encdec_prefill(jp, _j(pb), jcfg, cache_len=S)
        assert sorted(cache) == ["k", "v", "xk", "xv"]
        offset = 0
    else:
        got, cache = T.prefill(tp, _t(pb), cfg)
        want, jcache = JT.prefill(jp, _j(pb), jcfg)
        offset = cfg.n_patches
    _close(got, want)
    _close(got[:, 0], T.forward(tp, _t(pb), cfg)[0][:, -1],
           CONSISTENCY_TOL)
    for a, w in zip(leaves(cache), jax.tree.leaves(jcache)):
        assert tuple(a.shape) == w.shape
        _close(a, w)
    L = offset + S + n
    ext = T.extend_cache(cache, L)
    jext = JT.extend_cache(jcache, L)
    assert ext["k"].shape[2] == L
    if cfg.is_encoder_decoder:
        assert ext["xk"] is cache["xk"] and ext["xv"] is cache["xv"]
    for i in range(n):
        tok = b["tokens"][:, S + i:S + i + 1]
        got, ext = T.decode_step(tp, torch.from_numpy(tok), offset + S + i,
                                 cfg, ext)
        want, jext = JT.decode_step(jp, jnp.asarray(tok),
                                    jnp.int32(offset + S + i), jcfg, jext)
        _close(got, want)
        _close(got[:, 0], full[:, S + i], CONSISTENCY_TOL)


def test_init_decode_state_encdec_layout():
    cfg, jcfg, _, _ = _model("whisper_tiny")
    got = T.init_decode_state(cfg, 2, 12, dtype=torch.float32, device="cpu")
    want = JT.init_decode_state(jcfg, 2, 12, dtype=jnp.float32)
    assert jax.tree.map(lambda a: tuple(a.shape), to_numpy(got)) == \
        jax.tree.map(lambda a: a.shape, want)
    assert got["xk"].shape[2] == cfg.enc_seq


def test_whisper_greedy_generate_matches_jax():
    """``generate(frames=)``: the encoder-decoder prefills through
    ``encdec_prefill``; greedy tokens equal the JAX ``generate``'s."""
    cfg, jcfg, jp, tp = _model("whisper_tiny")
    b = _batch(cfg, 2, 6, 3)
    want = np.asarray(JS.generate(jp, jcfg, jnp.asarray(b["tokens"]), 5,
                                  jnp.asarray(b["frames"])))
    got = generate(tp, cfg, b["tokens"], 5, frames=b["frames"])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("loss_chunk", [0, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradient_match_jax(arch, loss_chunk):
    """``lm_loss`` on both branches, dense and chunked (JAX
    ``tests/test_perf_variants.py::test_chunked_loss_vlm``'s 17 tokens),
    and its gradient."""
    cfg, jcfg, jp, tp = _model(arch)
    b = _batch(cfg, 2, 17, 4)
    (jl, _), jg = jax.value_and_grad(
        lambda p: JT.lm_loss(p, _j(b), jcfg, loss_chunk=loss_chunk),
        has_aux=True)(jp)
    tp = from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ws = [a.requires_grad_(True) for a in leaves(tp)]
    tl, _ = T.lm_loss(tp, _t(b), cfg, loss_chunk=loss_chunk)
    _close(float(tl.detach()), float(jl))
    for g, w in zip(torch.autograd.grad(tl, ws), jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4)
