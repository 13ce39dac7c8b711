"""The port's federated round (``core/fed_step.py``) against the JAX
package's, on the CPU.

The round is ``jax.jit(make_fed_train_step(...))`` on SmolLM-135M's smoke
config with G = 4 groups and E = 1 or 2 local steps (as
``tests/test_fed_step.py`` sets it up), the JAX weights carried across.
Under ``jax.jit`` XLA multiplies by ``f32(1/n)`` and ``f32(1/L)`` where
the code divides by them; the port computes those forms, so the
compressor is held bit for bit (values: a kept value rounding to level
-0 is -0.0 in the port's channel and +0.0 after the reference's int
cast).  The ``gather_q`` round trip on the CPU is kernel B's channel
form's plain version.  Whole rounds: ``gather_f32`` and ``psum`` within
1e-5; ``gather_q`` by ``tests/torch_fed_rules.py``'s rule (within one
quantization step of its row, or the threshold plus a step where float
noise moves a group's threshold across a value, and past a step or past
1e-5 on at most 0.1% of the elements).  ``local_loss`` within 1e-5,
``alpha_t`` exact.  The server's Eqs. 7-10 helpers (``weighted_average``,
``mixing_alpha``, ``merge_global``) within 1e-6 of the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core import fed_step as J
from repro.core import staleness as JS
from repro.models import transformer as JT
from repro_torch.configs.base import get_smoke_config
from repro_torch.core import compression as C
from repro_torch.core.dynamic import DEFAULT_SET_Q, DEFAULT_SET_S
from repro_torch.core import fed_step as F
from repro_torch.core import staleness as S
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.utils.tree import from_numpy, leaves

from torch_fed_rules import F32_TOL, assert_gather_q_close, quant_stats
from torch_threads import one_torch_thread  # noqa: F401

G = 4
LOSS_TOL = 1e-5


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_smoke_config("smollm_135m")
    jw = JT.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, jw, get_smoke_config("smollm_135m")


def _batch(cfg, E, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, cfg.vocab, (G * E * 2, 32)).astype(np.int32)


def _jax_round(jcfg, fed):
    return jax.jit(J.make_fed_train_step(
        lambda p, b: JT.lm_loss(p, b, jcfg)[0], fed))


def _port_round(cfg, fed):
    return F.make_fed_train_step(lambda p, b: T.lm_loss(p, b, cfg)[0], fed)


# ----------------------------------------------------------------------
# the compressor
# ----------------------------------------------------------------------
def test_approx_topk_threshold_is_the_jitted_reference():
    x = np.abs(np.random.RandomState(1).randn(30011).astype(np.float32))
    for p_s, iters in ((0.25, 12), (0.05, 16), (0.5, 6)):
        want = jax.jit(J.approx_topk_threshold, static_argnums=(1, 2))(
            jnp.asarray(x), p_s, iters)
        got = F.approx_topk_threshold(torch.from_numpy(x), p_s, iters)
        assert _bits(got.numpy()) == _bits(want)


@pytest.mark.parametrize("p_s,p_q", [(0.25, 8), (0.1, 6), (0.5, 4),
                                     (0.05, 2)])
def test_compress_decompress_are_the_jitted_reference(p_s, p_q):
    fed_j = J.FedConfig(p_s=p_s, p_q=p_q)
    fed_t = F.FedConfig(p_s=p_s, p_q=p_q)
    x = (np.random.RandomState(2).randn(4099) * 0.03).astype(np.float32)
    lj, sj = jax.jit(lambda v: J.compress_delta(v, fed_j))(jnp.asarray(x))
    lt, st = F.compress_delta(torch.from_numpy(x), fed_t)
    assert lt.dtype == torch.int8
    np.testing.assert_array_equal(lt.numpy().astype(np.int32),
                                  np.asarray(lj).astype(np.int32))
    assert _bits(st.numpy()) == _bits(sj)
    dj = jax.jit(lambda l, s: J.decompress_delta(l, s, fed_j,
                                                 jnp.float32))(lj, sj)
    dt = F.decompress_delta(lt, st, fed_t, torch.float32)
    np.testing.assert_array_equal(_bits(dt.numpy()), _bits(dj))


@pytest.mark.parametrize("p_s", [s for s in DEFAULT_SET_S if s < 1.0])
@pytest.mark.parametrize("p_q", [q for q in DEFAULT_SET_Q if q <= 8])
def test_channel_wire_is_compress_delta(p_s, p_q):
    """Kernel B's channel form with its wire (the plain version here): the
    int8 levels and f32 scales of each row are the port's
    ``compress_delta`` and the jitted JAX ``compress_delta``, bit for bit,
    over Set_s x Set_q (the p_q of Set_q that an int8 wire takes; p_s = 1
    is the keep-all form, which the round gives to ``compress_delta``
    itself).  The values beside them are the round trip's."""
    fed_j = J.FedConfig(p_s=p_s, p_q=p_q)
    fed_t = F.FedConfig(p_s=p_s, p_q=p_q)
    rng = np.random.RandomState(int(p_s * 100) + p_q)
    rows = [(rng.randn(G, n) * 0.03).astype(np.float32)
            for n in (4099, 37, 1)]
    rows[0][:, :64] = np.round(rows[0][:, :64] * 64) / 64   # ties
    vals, lvls, scales = ops.threshold_channel_leaves(
        [torch.from_numpy(r) for r in rows], p_s, p_q, fed_t.threshold_iters,
        wire=True)
    comp = jax.jit(jax.vmap(lambda x: J.compress_delta(x, fed_j)))
    for r, v, lv, sc in zip(rows, vals, lvls, scales):
        lj, sj = comp(jnp.asarray(r))
        assert lv.dtype == torch.int8 and tuple(lv.shape) == r.shape
        np.testing.assert_array_equal(lv.numpy().astype(np.int32),
                                      np.asarray(lj).astype(np.int32))
        assert list(_bits(sc.numpy())) == list(_bits(sj))
        for i in range(G):
            lt, st = F.compress_delta(torch.from_numpy(r[i]), fed_t)
            assert torch.equal(lt, lv[i]) and _bits(st.numpy()) == \
                _bits(sc[i].numpy())
        np.testing.assert_array_equal(
            v.numpy(), F.decompress_delta(lv, sc[:, None], fed_t,
                                          torch.float32).numpy())
    with pytest.raises(ValueError, match="int8 wire"):
        ops.threshold_channel_leaves([torch.from_numpy(rows[1])], p_s, 16,
                                     wire=True)


def test_int4_wire_packs_two_levels_a_byte():
    lv = torch.from_numpy(np.random.RandomState(4).randint(
        -7, 8, (3, 11)).astype(np.int8))
    packed = F.pack_int4(lv)
    assert packed.dtype == torch.uint8 and tuple(packed.shape) == (3, 6)
    assert torch.equal(F.unpack_int4(packed, 11), lv)


def test_gather_q_combine_is_the_channel_form(model):
    """The round's compressor: the delta rows of every leaf, (G, n), through
    ``ops.threshold_channel_leaves`` (one call for the list) equal the
    jitted ``vmap(decompress ∘ compress)`` of the reference."""
    _, jw, _ = model
    fed = J.FedConfig(n_groups=G)
    rng = np.random.RandomState(3)
    rows = [(rng.randn(G, int(np.prod(x.shape))) * 1e-3).astype(np.float32)
            for x in jax.tree.leaves(jw)]

    @jax.jit
    def roundtrip(d):
        lv, sc = jax.vmap(lambda x: J.compress_delta(x, fed))(d)
        return jax.vmap(lambda l, s: J.decompress_delta(
            l, s, fed, jnp.float32))(lv, sc)

    got = ops.threshold_channel_leaves([torch.from_numpy(r) for r in rows],
                                       fed.p_s, fed.p_q,
                                       fed.threshold_iters)
    assert len(got) == len(rows)
    for r, g in zip(rows, got):
        want = np.asarray(roundtrip(jnp.asarray(r)))
        np.testing.assert_array_equal(g.numpy(), want)   # -0.0 == 0.0


def test_fed_wire_bytes_match_jax(model):
    _, jw, _ = model
    tw = from_numpy(jax.tree.map(np.asarray, jw), "cpu")
    for p_s, p_q, g in ((0.25, 8, 8), (0.1, 4, 4), (1.0, 8, 2)):
        assert F.fed_wire_bytes(tw, F.FedConfig(p_s=p_s, p_q=p_q), g) == \
            J.fed_wire_bytes(jw, J.FedConfig(p_s=p_s, p_q=p_q), g)


# ----------------------------------------------------------------------
# whole rounds
# ----------------------------------------------------------------------
@pytest.mark.parametrize("schedule,E,p_s", [
    ("gather_q", 1, 0.25), ("gather_q", 2, 0.25), ("gather_q", 1, 1.0),
    ("gather_f32", 1, 0.25), ("gather_f32", 2, 0.25), ("psum", 1, 0.25),
    ("psum", 2, 0.25)])
def test_fed_round_matches_jax(model, schedule, E, p_s):
    """At p_s = 1 the reference's bisection still drops the values below
    max / 2^(iters + 1) (max / 8 at 2 steps), which the port's keep-all
    branch reproduces (the channel form would keep them)."""
    jcfg, jw, cfg = model
    kw = dict(n_groups=G, local_steps=E, lr=1e-2, schedule=schedule,
              p_s=p_s, threshold_iters=2 if p_s >= 1.0 else 12)
    fed_j, fed_t = J.FedConfig(**kw), F.FedConfig(**kw)
    tokens = _batch(jcfg, E)
    stale = np.zeros(G, np.int32)
    loss = lambda p, b: JT.lm_loss(p, b, jcfg)[0]  # noqa: E731
    jround = J.make_fed_train_step(loss, fed_j)
    stats = quant_stats(loss, fed_j)

    @jax.jit
    def reference(w, b, st):   # one compile for the round and its stats
        quant = schedule == "gather_q"
        return jround(w, b, st) + ((stats(w, b),) if quant else ())

    pj, mj, *sj = reference(jw, {"tokens": jnp.asarray(tokens)},
                           jnp.asarray(stale))
    tw = from_numpy(jax.tree.map(np.asarray, jw), "cpu")
    pt, mt = _port_round(cfg, fed_t)(tw, {"tokens": torch.from_numpy(
        tokens)}, torch.from_numpy(stale))
    assert abs(float(mt["local_loss"]) - float(mj["local_loss"])) <= LOSS_TOL
    assert _bits(mt["alpha_t"].numpy()) == _bits(mj["alpha_t"])
    assert float(mt["delta_norm"]) == pytest.approx(
        float(mj["delta_norm"]), rel=1e-4)
    got = [x.numpy() for x in leaves(pt)]
    want = [np.asarray(x) for x in jax.tree.leaves(pj)]
    if schedule != "gather_q":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=F32_TOL, rtol=0)
        return
    assert_gather_q_close(got, want, sj[0], fed_j.p_q)


def test_staleness_shrinks_mixing_exactly(model):
    jcfg, jw, cfg = model
    kw = dict(n_groups=G, local_steps=1, lr=1e-2, schedule="gather_f32")
    tokens = _batch(jcfg, 1, seed=4)
    tw = from_numpy(jax.tree.map(np.asarray, jw), "cpu")
    jround = _jax_round(jcfg, J.FedConfig(**kw))
    tround = _port_round(cfg, F.FedConfig(**kw))
    for s, alpha in ((0, 0.6), (8, 0.6 * 9 ** -0.5)):
        stale = np.full(G, s, np.int32)
        _, mj = jround(jw, {"tokens": jnp.asarray(tokens)},
                       jnp.asarray(stale))
        _, mt = tround(tw, {"tokens": torch.from_numpy(tokens)},
                       torch.from_numpy(stale))
        assert _bits(mt["alpha_t"].numpy()) == _bits(mj["alpha_t"])
        assert float(mt["alpha_t"]) == pytest.approx(alpha, abs=1e-6)


def test_server_helpers_match_jax():
    """Eq. 7's ``weighted_average``, Eqs. 8-9's ``mixing_alpha`` and Eq.
    10's ``merge_global`` on a nested tree, at mixed staleness and sample
    counts."""
    rng = np.random.RandomState(8)

    def tree():
        return {"w": rng.randn(5, 3).astype(np.float32),
                "blk": {"b": rng.randn(7).astype(np.float32),
                        "k": rng.randn(2, 2, 3).astype(np.float32)}}

    ups, wg = [tree() for _ in range(4)], tree()
    stale, n = [0.0, 3.0, 1.0, 7.0], [40.0, 25.0, 60.0, 10.0]
    jax_ups = [jax.tree.map(jnp.asarray, u) for u in ups]
    t_ups = [from_numpy(u, "cpu") for u in ups]
    uj = JS.weighted_average(jax_ups, stale, n, 0.5)
    ut = S.weighted_average(t_ups, stale, n, 0.5)
    aj = JS.mixing_alpha(stale, 0.6, 0.5)
    at = S.mixing_alpha(stale, 0.6, 0.5)
    assert float(at) == pytest.approx(float(aj), rel=1e-6)
    mj = JS.merge_global(jax.tree.map(jnp.asarray, wg), uj, aj)
    mt = S.merge_global(from_numpy(wg, "cpu"), ut, at)
    for a, b in ((uj, ut), (mj, mt)):
        got, want = leaves(b), jax.tree.leaves(a)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


def test_fed_round_reduces_loss(model):
    _, jw, cfg = model
    fed = F.FedConfig(n_groups=G, local_steps=2, lr=1e-2)
    tround = _port_round(cfg, fed)
    p = from_numpy(jax.tree.map(np.asarray, jw), "cpu")
    batch = {"tokens": torch.from_numpy(_batch(cfg, 2))}
    stale = torch.zeros(G, dtype=torch.int32)
    losses = []
    for _ in range(6):
        p, m = tround(p, batch, stale)
        losses.append(float(m["local_loss"]))
    assert losses[-1] < losses[0] - 0.02


def test_an_unknown_schedule_raises():
    with pytest.raises(ValueError, match="schedule"):
        F.make_fed_train_step(lambda p, b: 0.0,
                              F.FedConfig(schedule="ring"))


# ----------------------------------------------------------------------
# the key path of quantize_levels, by distribution
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 4])
def test_stochastic_rounding_is_unbiased(bits):
    """With a ``torch.Generator`` the levels are floor(y) or floor(y) + 1
    of y = x / scale * L, and the mean of 2,000 dequantized draws lies
    within 4 sigma of x (sigma of the mean of Bernoulli roundings)."""
    draws = 2000
    x = torch.from_numpy((np.random.RandomState(5).randn(96) * 0.2).astype(
        np.float32))
    L = 2 ** (bits - 1) - 1
    scale = torch.clamp(x.abs().max(), min=1e-12)
    y = x / scale * L
    low = torch.floor(y)
    key = torch.Generator().manual_seed(7)
    total = torch.zeros_like(x, dtype=torch.float64)
    for _ in range(draws):
        lv, sc = C.quantize_levels(x, bits, key=key)
        assert torch.equal(sc, scale)
        assert bool(((lv == low) | (lv == low + 1)).all())
        total += C.dequantize_levels(lv, sc, bits).double()
    frac = (y - low).double()
    sigma = torch.sqrt(frac * (1 - frac) / draws) * float(scale) / L
    err = (total / draws - x.double()).abs()
    assert bool((err <= 4 * sigma + 1e-6).all())
    # a deterministic call rounds to nearest
    lv, _ = C.quantize_levels(x, bits)
    assert torch.equal(lv, torch.round(y))


def test_stochastic_dense_roundtrip_keeps_the_top_k():
    x = torch.from_numpy(np.random.RandomState(6).randn(400).astype(
        np.float32))
    key = torch.Generator().manual_seed(0)
    out = C.sparsify_quantize_dense(x, 0.25, 8, key=key)
    mask = C.topk_mask(x, 0.25)
    assert bool((out[~mask] == 0).all())
    step = float(x.abs().max()) / 127
    assert float((out[mask] - x[mask]).abs().max()) <= step * (1 + 1e-6)
