"""The port's decoder-only families (dense, MoE, hybrid) against the JAX
package's, on the CPU: ``models/transformer.py`` and the serving front
door ``launch/serve.py``.

Every test takes the JAX package's weights from its ``init_model`` and
carries them across with ``utils.tree.from_numpy``, then holds the port
against a live call of the JAX package on the same numpy inputs, at the
smoke configs.  Tolerances: logits and caches within 1e-4 (atol = rtol)
against JAX (two layers of f32 products summed in another order); the
port's own consistency checks at the JAX tests' 2e-5 (3e-5 for the
rolling window); greedy tokens equal.
"""
import dataclasses
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
from repro_torch.configs.base import PORTED, get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch.serve import ContinuousBatcher, generate
from repro_torch.models import transformer as T
from repro_torch.utils.tree import from_numpy, to_numpy

from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
CONSISTENCY_TOL = 2e-5
LM_ARCHS = ["qwen3_1_7b", "smollm_135m", "granite_34b", "phi3_5_moe_42b",
            "moonshot_v1_16b", "llama4_scout_17b", "jamba_v0_1_52b"]
# dense with qk-norm, MQA with GELU, dense small, MoE top-2, MoE top-1,
# the hybrid
MODEL_ARCHS = ["qwen3_1_7b", "granite_34b", "smollm_135m", "phi3_5_moe_42b",
               "llama4_scout_17b", "jamba_v0_1_52b"]


@pytest.fixture
def card():
    """The CUDA device, decided when the test runs (skip without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python3 chip_smoke.py drives the "
                    "decoder-only families there)")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(port cfg, JAX cfg, JAX params, the same params in the port), made
    once per arch (no test writes into them)."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    return cfg, jcfg, jp, from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _close_tree(got, want, tol=TOL):
    assert set(got) == set(want)
    for k in got:
        if isinstance(got[k], dict):
            _close_tree(got[k], want[k], tol)
        else:
            assert tuple(got[k].shape) == want[k].shape, k
            _close(got[k], want[k], tol)


def _toks(cfg, shape, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab, shape).astype(
        np.int32)


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def _row(tree, b, axis=1):
    """Row ``b`` of a stacked cache (numpy or JAX), keeping its axis: the
    batch axis is the port's ``cache_batch_axis``."""
    return {k: _row(v, b, T.cache_batch_axis(k, axis))
            if isinstance(v, dict)
            else jnp.take(jnp.asarray(v), jnp.asarray([b]), axis=axis)
            for k, v in tree.items()}


# ----------------------------------------------------------------------
# configs and init
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(PORTED))
def test_configs_are_the_jax_packages(arch):
    want = jax_get_config(arch)
    assert get_config(arch).__dict__ == want.__dict__
    assert get_smoke_config(arch).__dict__ == jax_smoke_config(arch).__dict__
    assert get_config(arch).param_count() == want.param_count()


@pytest.mark.parametrize("arch", ["whisper_tiny", "internvl2_2b"])
def test_encoder_decoder_and_vlm_raise(arch):
    """The encoder-decoder and the VLM resolve and build now; what still
    raises is what the JAX package refuses too: ``prefill`` of an
    encoder-decoder (``encdec_prefill`` serves it), and the continuous
    batcher, which prefills tokens alone, for either family."""
    assert get_config(arch).__dict__ == jax_get_config(arch).__dict__
    jcfg = jax_smoke_config(arch)
    cfg = get_smoke_config(arch)
    params = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    want = jax.tree.map(lambda a: a.shape,
                        JT.init_model(jax.random.PRNGKey(0), jcfg))
    assert jax.tree.map(lambda a: tuple(a.shape), to_numpy(params)) == want
    if cfg.is_encoder_decoder:
        with pytest.raises(NotImplementedError, match="encdec_prefill"):
            T.prefill(params, {"tokens": torch.zeros((1, 2),
                                                     dtype=torch.int32)},
                      cfg)
    else:
        with pytest.raises(ValueError, match="prefill and decode_step"):
            generate(params, cfg, np.zeros((1, 2), np.int32), 2)
    with pytest.raises(ValueError, match="prefills tokens alone"):
        ContinuousBatcher(params, cfg)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_model_has_the_jax_layout(arch):
    """The same keys and stacked shapes as the JAX tree (the hybrid's
    groups included), f32, the initializers' bounds, and the same weights
    again from the same seed."""
    cfg, _, jp, _ = _model(arch)
    params = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), to_numpy(params)) == \
        jax.tree.map(lambda a: a.shape, jp)
    assert all(a.dtype == np.float32
               for a in jax.tree.leaves(to_numpy(params)))
    wq = params["layers"]["attn"]["wq"]
    assert float(wq.abs().max()) <= 1 / np.sqrt(cfg.d_model)
    again = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["layers"]["attn"]["wo"],
                       params["layers"]["attn"]["wo"])


# ----------------------------------------------------------------------
# forward, prefill, decode against JAX
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_forward_prefill_decode_match_jax(arch):
    """forward logits and aux, prefill logits and cache, extend_cache,
    then three decode steps at a scalar position."""
    cfg, jcfg, jp, params = _model(arch)
    toks = _toks(cfg, (2, 16), 1)
    logits, aux = T.forward(params, {"tokens": torch.from_numpy(toks)}, cfg)
    jlogits, jaux = JT.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    assert logits.shape == (2, 16, cfg.vocab)
    _close(logits, jlogits)
    _close(aux, jaux)
    assert (float(aux) > 0) == cfg.is_moe
    lp, cache = T.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg)
    jlp, jcache = JT.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    _close(lp, jlp)
    _close_tree(cache, jcache)
    cache, jcache = T.extend_cache(cache, 20), JT.extend_cache(jcache, 20)
    _close_tree(cache, jcache)
    for t in range(3):
        nxt = _toks(cfg, (2, 1), 10 + t)
        dl, cache = T.decode_step(params, torch.from_numpy(nxt), 16 + t,
                                  cfg, cache)
        jdl, jcache = JT.decode_step(jp, jnp.asarray(nxt), jnp.int32(16 + t),
                                     jcfg, jcache)
        _close(dl, jdl)
        _close_tree(cache, jcache)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_decode_with_row_positions_matches_jax(arch):
    """pos as a (B,) tensor: every row equals the JAX decode of that row
    alone at its own position (what the JAX batcher's vmap computes)."""
    cfg, jcfg, jp, params = _model(arch)
    toks = _toks(cfg, (3, 8), 2)
    _, jcache = JT.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    jcache = JT.extend_cache(jcache, 16)
    cache = from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    pos = np.array([8, 13, 10])
    nxt = _toks(cfg, (3, 1), 3)
    dl, new = T.decode_step(params, torch.from_numpy(nxt),
                            torch.from_numpy(pos), cfg, cache)
    for b in range(3):
        jdl, jrow = JT.decode_step(jp, jnp.asarray(nxt[b:b + 1]),
                                   jnp.int32(pos[b]), jcfg,
                                   _row(jcache, b))
        _close(dl[b:b + 1], jdl)
        _close_tree(_row(to_numpy(new), b), jrow)


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "phi3_5_moe_42b"])
def test_quantized_decode_state_matches_jax(arch):
    """init_decode_state(quantized=True): the int8 cache and its scales,
    four decode steps.  (Not the hybrid: after a Mamba layer's f32 noise a
    K value within that noise of a half-level rounds to the other int8
    level, 1/127 of its scale, which is no fault of either package.)"""
    cfg, jcfg, jp, params = _model(arch)
    cache = T.init_decode_state(cfg, 2, 6, torch.float32, device="cpu",
                                quantized=True)
    jcache = JT.init_decode_state(jcfg, 2, 6, jnp.float32, quantized=True)
    for t in range(4):
        nxt = _toks(cfg, (2, 1), 20 + t)
        dl, cache = T.decode_step(params, torch.from_numpy(nxt), t, cfg,
                                  cache)
        jdl, jcache = JT.decode_step(jp, jnp.asarray(nxt), jnp.int32(t),
                                     jcfg, jcache)
        _close(dl, jdl)
    kv = cache["attn"] if cfg.is_hybrid else cache
    jkv = jcache["attn"] if cfg.is_hybrid else jcache
    np.testing.assert_array_equal(kv["k"].numpy(), np.asarray(jkv["k"]))
    _close(kv["v_scale"], jkv["v_scale"], 1e-6)


@pytest.mark.parametrize("arch,quantized", [
    ("qwen3_1_7b", False), ("qwen3_1_7b", True), ("phi3_5_moe_42b", False),
    ("jamba_v0_1_52b", False), ("jamba_v0_1_52b", True),
    ("mamba2_370m", False)])
def test_init_decode_state_matches_jax(arch, quantized):
    cfg = get_smoke_config(arch)
    got = T.init_decode_state(cfg, 3, 10, torch.bfloat16, device="cpu",
                              quantized=quantized)
    want = JT.init_decode_state(jax_smoke_config(arch), 3, 10, jnp.bfloat16,
                                quantized=quantized)

    def layout(tree, dtype_name):
        return {k: layout(v, dtype_name) if isinstance(v, dict) else
                (tuple(v.shape), dtype_name(v)) for k, v in tree.items()}

    assert layout(got, lambda a: str(a.dtype).split(".")[-1]) == \
        layout(want, lambda a: str(a.dtype))
    assert not any(bool(a.any()) for a in _leaves(got))


def test_extend_cache_pads_only_the_kv_leaves():
    cfg, jcfg, jp, params = _model("jamba_v0_1_52b")
    toks = _toks(cfg, (2, 8), 4)
    _, cache = T.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg)
    _, jcache = JT.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, want = T.extend_cache(cache, 13), JT.extend_cache(jcache, 13)
    _close_tree(got, want)
    assert got["attn"]["k"].shape[2] == 13
    assert got["ssm"]["state"] is cache["ssm"]["state"]
    assert T.extend_cache(got, 5)["attn"]["k"].shape[2] == 13


# ----------------------------------------------------------------------
# the JAX package's own consistency checks (tests/test_models.py), in the
# port
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_decode_matches_forward(arch):
    cfg, _, _, params = _model(arch)
    S = 12
    toks = torch.from_numpy(_toks(cfg, (2, S), 1))
    full, _ = T.forward(params, {"tokens": toks}, cfg)
    cache = T.init_decode_state(cfg, 2, S, dtype=torch.float32,
                                device="cpu")
    for t in range(S):
        dl, cache = T.decode_step(params, toks[:, t:t + 1], t, cfg, cache)
        _close(dl[:, 0], full[:, t], CONSISTENCY_TOL)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_prefill_then_decode_continuation(arch):
    """prefill(prompt) + decode_step(next) == forward(prompt + next)."""
    cfg, _, _, params = _model(arch)
    S = 8
    toks = torch.from_numpy(_toks(cfg, (2, S + 1), 2))
    full, _ = T.forward(params, {"tokens": toks}, cfg)
    logits, cache = T.prefill(params, {"tokens": toks[:, :S]}, cfg)
    _close(logits[:, 0], full[:, S - 1], CONSISTENCY_TOL)
    cache = T.extend_cache(cache, S + 1)
    dl, _ = T.decode_step(params, toks[:, S:S + 1], S, cfg, cache)
    _close(dl[:, 0], full[:, S], CONSISTENCY_TOL)


def test_rolling_window_decode_matches_windowed_attention():
    """A rolling KV cache past its window == sliding-window attention."""
    cfg, _, _, params = _model("qwen3_1_7b")
    W, S = 8, 20
    toks = torch.from_numpy(_toks(cfg, (1, S), 4))
    full, _ = T.forward(params, {"tokens": toks}, cfg, window=W)
    cache = T.init_decode_state(cfg, 1, W, dtype=torch.float32,
                                device="cpu", rolling=True)
    for t in range(S):
        dl, cache = T.decode_step(params, toks[:, t:t + 1], t, cfg, cache,
                                  rolling=True)
        _close(dl[:, 0], full[:, t], 3e-5)


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3_1_7b", "granite_34b",
                                  "phi3_5_moe_42b", "jamba_v0_1_52b"])
def test_greedy_generate_matches_jax(arch):
    """Dense, MQA, MoE and hybrid: the port's greedy tokens are the JAX
    package's."""
    cfg, jcfg, jp, params = _model(arch)
    prompts = _toks(cfg, (2, 8), 5)
    want = np.asarray(JS.generate(jp, jcfg, jnp.asarray(prompts), 8))
    got = generate(params, cfg, prompts, 8)
    assert got.dtype == torch.int32 and got.shape == (2, 16)
    np.testing.assert_array_equal(got.numpy(), want)


P_LEN, GEN = 8, 6


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "phi3_5_moe_42b",
                                  "llama4_scout_17b", "jamba_v0_1_52b"])
def test_batcher_matches_solo_generate(arch):
    """5 requests of mixed prompt lengths through 2 slots (slots recycled),
    one more submitted mid-flight: every request's tokens equal its solo
    decode.  The hybrid at the smoke config's attn_every == 2."""
    cfg, _, _, params = _model(arch)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, cfg.vocab, n).astype(np.int32)
               for n in (8, 5, 8, 3, 7, 6)]
    solo = [generate(params, cfg, p[None], GEN)[0, len(p):].tolist()
            for p in prompts]
    cb = ContinuousBatcher(params, cfg, slots=2, cache_len=P_LEN + GEN)
    rids = [cb.submit(p, GEN) for p in prompts[:5]]
    for _ in range(3):
        cb.step()
    rids.append(cb.submit(prompts[5], GEN))       # mid-flight
    while cb.pending():
        cb.step()
    assert [cb.result(r) for r in rids] == solo
    assert cb.steps < 6 * (GEN - 1)


def test_batcher_free_slot_runs_past_the_cache():
    """A slot freed early keeps decoding garbage while its neighbour runs
    on: its position passes cache_len (the write slot is clamped, as XLA
    clamps it), and neither the neighbour nor the request admitted into
    the slot afterwards is disturbed."""
    cfg, _, _, params = _model("qwen3_1_7b")
    rng = np.random.RandomState(7)
    short = rng.randint(0, cfg.vocab, 8).astype(np.int32)
    long_ = rng.randint(0, cfg.vocab, 1).astype(np.int32)
    late = rng.randint(0, cfg.vocab, 4).astype(np.int32)
    cb = ContinuousBatcher(params, cfg, slots=2, cache_len=10)
    r_short = cb.submit(short, 2)
    r_long = cb.submit(long_, 9)
    seen = 0
    while cb.pending():
        cb.step()
        seen = max(seen, int(cb._pos.max()))
        if cb.steps == 6:
            r_late = cb.submit(late, 3)
    assert seen > cb.cache_len               # the free slot ran past it
    assert cb.result(r_short) == \
        generate(params, cfg, short[None], 2)[0, 8:].tolist()
    assert cb.result(r_long) == \
        generate(params, cfg, long_[None], 9)[0, 1:].tolist()
    assert cb.result(r_late) == \
        generate(params, cfg, late[None], 3)[0, 4:].tolist()


def test_decode_step_past_the_cache_matches_jax():
    """decode_step at positions at and past the cache length equals the
    JAX package's (XLA clamps the write); per-row positions too."""
    cfg, jcfg, jp, params = _model("qwen3_1_7b")
    toks = _toks(cfg, (2, 10), 8)
    _, jcache = JT.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    cache = from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    nxt = _toks(cfg, (2, 1), 9)
    for pos in (10, 14):
        dl, new = T.decode_step(params, torch.from_numpy(nxt), pos, cfg,
                                cache)
        jdl, jnew = JT.decode_step(jp, jnp.asarray(nxt), jnp.int32(pos),
                                   jcfg, jcache)
        _close(dl, jdl)
        _close_tree(new, jnew)
    rows, _ = T.decode_step(params, torch.from_numpy(nxt),
                            torch.tensor([14, 3]), cfg, cache)
    _close(rows[:1], jdl[:1])


def test_hybrid_batcher_past_attn_every_2_raises():
    """The port takes a hybrid into the batcher only where the JAX
    package's batcher works (attn_every == 2); generate serves it."""
    cfg = dataclasses.replace(get_smoke_config("jamba_v0_1_52b"),
                              n_layers=4, attn_every=4, ssm_chunk=8)
    params = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="Queue C"):
        ContinuousBatcher(params, cfg, slots=2, cache_len=16)
    out = generate(params, cfg, _toks(cfg, (2, 8), 10), 4)
    assert out.shape == (2, 12)


def test_jax_hybrid_batcher_fails_past_attn_every_2():
    """The reference's fault, pinned as it is (not repaired here): its
    batcher splices and vmaps a hybrid's SSM leaves, (groups, attn_every -
    1, B, ...), on axis 1, so at attn_every = 4 the admission fails."""
    jcfg = dataclasses.replace(jax_smoke_config("jamba_v0_1_52b"),
                               n_layers=4, attn_every=4, ssm_chunk=8)
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    cb = JS.ContinuousBatcher(jp, jcfg, slots=2, cache_len=16)
    with pytest.raises(TypeError, match="dynamic_update_slice update shape"):
        cb.run([np.arange(8, dtype=np.int32)] * 2, 4)


def test_main_serves_qwen3_by_default(capsys):
    serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "3", "--requests", "3"])
    out = capsys.readouterr().out
    assert "qwen3-1.7b/smoke on cpu" in out
    assert "continuous batching: 3 requests" in out


# ----------------------------------------------------------------------
# on the card (skipped here)
# ----------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_lm_on_card_matches_cpu(card, arch):
    """Prefill logits within 1e-4 and greedy tokens equal, card against
    CPU, from the same weights (the hybrid runs kernel C on the card)."""
    cfg, _, _, params = _model(arch)
    pd = from_numpy(to_numpy(params), card)
    toks = _toks(cfg, (2, 16), 11)
    want, _ = T.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg)
    got, _ = T.prefill(pd, {"tokens": torch.from_numpy(toks).to(card)}, cfg)
    _close(got.cpu(), want)
    assert torch.equal(generate(pd, cfg, toks, 6).cpu(),
                       generate(params, cfg, toks, 6))
