"""The port's attention and its layers against the JAX package's, on the CPU.

``rotary``, ``head_rmsnorm`` and ``mlp`` (``models/layers.py``) and
``models/attention.py`` of the port take the same inputs, made from a seed
with numpy, as the JAX package's functions; weights come from the JAX
package's own initializers and cross with ``utils.tree.from_numpy``.

Tolerances: 1e-5 (atol = rtol) for one layer's outputs and caches (f32
products summed in another order); rotary at positions up to 4,096 within
1e-5 (sin and cos of large f32 angles); int8 cache levels exactly equal,
their scales within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import attention as JA
from repro.models import layers as JL
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.utils.tree import from_numpy, to_numpy

from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


@pytest.fixture
def card():
    """The CUDA device, decided when the test runs (skip without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python3 chip_smoke.py drives the "
                    "attention path there)")
    return torch.device("cuda")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _attn(arch, seed=0, cross=False):
    """(port cfg, JAX cfg, JAX weights, the same weights in the port)."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    jp = JA.attn_init(jax.random.PRNGKey(seed), jcfg, cross=cross)
    return cfg, jcfg, jp, from_numpy(_np(jp), "cpu")


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _positions(B, S):
    return np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rotary_matches_jax(theta):
    """Halves of the head (not interleaved pairs), f32 frequencies, at
    positions up to 4,096."""
    x = _x((2, 7, 3, 16), 0)
    pos = np.random.RandomState(1).randint(0, 4096, (2, 7)).astype(np.int32)
    got = L.rotary(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = JL.rotary(jnp.asarray(x), jnp.asarray(pos), theta)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want)
    # position 0 is the identity
    zero = L.rotary(torch.from_numpy(x), torch.zeros((2, 7), dtype=torch.int64))
    _close(zero, x, 0)


def test_head_rmsnorm_matches_jax():
    x = _x((2, 5, 4, 32), 2)
    scale = (1 + 0.1 * _x((32,), 3)).astype(np.float32)
    got = L.head_rmsnorm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    want = JL.head_rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-5)
    _close(got, want)


@pytest.mark.parametrize("gated", [True, False], ids=["swiglu", "gelu"])
def test_mlp_matches_jax(gated):
    """SwiGLU, and the non-gated MLP with jax.nn.gelu's default tanh
    form (granite)."""
    jp = JL.mlp_init(jax.random.PRNGKey(4), 48, 96, gated=gated)
    p = from_numpy(_np(jp), "cpu")
    assert set(p) == set(jp)
    x = _x((2, 6, 48), 5)
    _close(L.mlp(p, torch.from_numpy(x)), JL.mlp(jp, jnp.asarray(x)))
    mine = L.mlp_init(torch.Generator().manual_seed(0), 48, 96,
                      gated=gated, lead=(3,))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: (3,) + v.shape for k, v in jp.items()}


# ----------------------------------------------------------------------
# init and the full-sequence forms
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch,cross", [("qwen3_1_7b", False),
                                        ("qwen3_1_7b", True),
                                        ("granite_34b", False)])
def test_attn_init_layout_matches_jax(arch, cross):
    """q_norm / k_norm only for a qk-norm self-attention; the same shapes
    and bounds as the JAX initializer."""
    cfg, _, jp, _ = _attn(arch, cross=cross)
    mine = A.attn_init(torch.Generator().manual_seed(0), cfg, cross=cross)
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: v.shape for k, v in jp.items()}
    assert ("q_norm" in mine) == (cfg.qk_norm and not cross)
    assert float(mine["wq"].abs().max()) <= 1 / np.sqrt(cfg.d_model)


@pytest.mark.parametrize("arch,window", [("qwen3_1_7b", 0),
                                         ("qwen3_1_7b", 5),
                                         ("granite_34b", 0),
                                         ("smollm_135m", 3)])
def test_attn_forward_plain_matches_jax(arch, window):
    """The plain branch (under the flash threshold): causal, windowed,
    GQA with qk-norm, MQA; with the returned K and V."""
    cfg, jcfg, jp, p = _attn(arch)
    x, pos = _x((2, 11, cfg.d_model), 6), _positions(2, 11)
    got, kv = A.attn_forward(p, torch.from_numpy(x), torch.from_numpy(pos),
                             cfg, window=window, return_kv=True)
    want, jkv = JA.attn_forward(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                                window=window, return_kv=True)
    _close(got, want)
    for k in ("k", "v"):
        _close(kv[k], jkv[k])


@pytest.mark.parametrize("S,q_chunk,kv_chunk,causal,window", [
    (50, 16, 12, True, 0),     # ragged both ways
    (10, 8, 3, True, 0),       # kv chunks past the padded end (clamped)
    (33, 8, 8, True, 7),       # a window
    (29, 16, 8, False, 0),     # not causal (the encoder's form)
    (40, 40, 40, True, 0),     # one chunk each
])
def test_flash_attention_matches_jax(S, q_chunk, kv_chunk, causal, window):
    """_flash_attention at small chunks: the padding, the causal chunk
    skip and the window, against the JAX online softmax; and against the
    port's own plain branch."""
    cfg = get_smoke_config("granite_34b")        # MQA: one kv head
    rng = np.random.RandomState(S)
    q = rng.randn(2, S, cfg.n_heads, cfg.head_dim).astype(np.float32)
    k = rng.randn(2, S, cfg.n_kv_heads, cfg.head_dim).astype(np.float32)
    v = rng.randn(2, S, cfg.n_kv_heads, cfg.head_dim).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=q_chunk,
              kv_chunk=kv_chunk)
    got = A._flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    want = JA._flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
    assert got.shape == q.shape
    _close(got, want)
    mask = None
    if causal:
        i, j = np.arange(S)[:, None], np.arange(S)[None, :]
        mask = (j <= i) & ((i - j) < window if window else True)
    plain = A._plain_attention(*map(torch.from_numpy, (q, k, v)),
                               None if mask is None else
                               torch.from_numpy(np.asarray(mask)))
    _close(got, plain)


def test_attn_forward_flash_branch_matches_jax():
    """Past flash_threshold attn_forward takes the flash form (default
    chunks), in both packages."""
    cfg, jcfg, jp, p = _attn("qwen3_1_7b", seed=2)
    x, pos = _x((1, 40, cfg.d_model), 7), _positions(1, 40)
    got = A.attn_forward(p, torch.from_numpy(x), torch.from_numpy(pos), cfg,
                         flash_threshold=16)
    want = JA.attn_forward(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                           flash_threshold=16)
    _close(got, want)
    plain = A.attn_forward(p, torch.from_numpy(x), torch.from_numpy(pos),
                           cfg)
    _close(got, plain)


def test_cross_attention_matches_jax():
    """enc_out supplies K and V (no rotary, no mask)."""
    cfg, jcfg, jp, p = _attn("qwen3_1_7b", seed=3, cross=True)
    x, pos = _x((2, 5, cfg.d_model), 8), _positions(2, 5)
    enc = _x((2, 9, cfg.d_model), 9)
    got = A.attn_forward(p, torch.from_numpy(x), torch.from_numpy(pos), cfg,
                         enc_out=torch.from_numpy(enc))
    want = JA.attn_forward(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                           enc_out=jnp.asarray(enc))
    _close(got, want)


# ----------------------------------------------------------------------
# the cache and decode
# ----------------------------------------------------------------------
@pytest.mark.parametrize("quantized,cross_len", [(False, 0), (True, 0),
                                                 (False, 6)])
def test_init_cache_matches_jax(quantized, cross_len):
    cfg, jcfg = get_smoke_config("qwen3_1_7b"), jax_smoke_config("qwen3_1_7b")
    got = A.init_cache(cfg, 2, 9, torch.float32, cross_len=cross_len,
                       quantized=quantized, device="cpu")
    want = JA.init_cache(jcfg, 2, 9, jnp.float32, cross_len=cross_len,
                         quantized=quantized)
    assert set(got) == set(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert not bool(got[k].any())


def _jax_cache(jcfg, quantized, seed, B=2, L_=12, filled=7):
    """A JAX cache with its first ``filled`` slots written by JAX decode
    steps, as numpy."""
    jp = JA.attn_init(jax.random.PRNGKey(seed + 10), jcfg)
    c = JA.init_cache(jcfg, B, L_, jnp.float32, quantized=quantized)
    for t in range(filled):
        x = _x((B, 1, jcfg.d_model), 100 + t)
        _, c = JA.attn_decode(jp, jnp.asarray(x), t, jcfg, c)
    return _np(c)


def _to_port_cache(c):
    return {k: torch.from_numpy(np.array(v)) for k, v in c.items()}


@pytest.mark.parametrize("mode", ["plain", "rolling", "quantized"])
def test_attn_decode_matches_jax(mode):
    """Five decode steps from the same cache: outputs and caches; the
    rolling buffer wraps past its length."""
    cfg, jcfg, jp, p = _attn("qwen3_1_7b", seed=4)
    quantized, rolling = mode == "quantized", mode == "rolling"
    jc = _jax_cache(jcfg, quantized, 4)
    c = _to_port_cache(jc)
    jc = jax.tree.map(jnp.asarray, jc)
    for t in range(7, 12 if not rolling else 17):
        x = _x((2, 1, cfg.d_model), t)
        o, c = A.attn_decode(p, torch.from_numpy(x), t, cfg, c,
                             rolling=rolling)
        jo, jc = JA.attn_decode(jp, jnp.asarray(x), t, jcfg, jc,
                                rolling=rolling)
        _close(o, jo)
        for k in c:
            if c[k].dtype == torch.int8:
                np.testing.assert_array_equal(c[k].numpy(),
                                              np.asarray(jc[k]))
            else:
                _close(c[k], jc[k], 1e-6 if "scale" in k else TOL)


def test_attn_decode_leaves_its_cache_as_it_was():
    cfg, jcfg, _, p = _attn("qwen3_1_7b")
    c = _to_port_cache(_jax_cache(jcfg, False, 5))
    before = {k: v.clone() for k, v in c.items()}
    A.attn_decode(p, torch.from_numpy(_x((2, 1, cfg.d_model), 1)), 7, cfg, c)
    assert all(torch.equal(c[k], before[k]) for k in c)


@pytest.mark.parametrize("quantized", [False, True])
def test_attn_decode_per_row_positions_match_jax(quantized):
    """pos as a (B,) tensor: each row equals the JAX decode of that row
    alone at its own position."""
    cfg, jcfg, jp, p = _attn("qwen3_1_7b", seed=6)
    jc = _jax_cache(jcfg, quantized, 6, B=3)
    pos = np.array([7, 3, 10])
    x = _x((3, 1, cfg.d_model), 11)
    o, c = A.attn_decode(p, torch.from_numpy(x), torch.from_numpy(pos), cfg,
                         _to_port_cache(jc))
    for b in range(3):
        row = {k: jnp.asarray(v[b:b + 1]) for k, v in jc.items()}
        jo, jrow = JA.attn_decode(jp, jnp.asarray(x[b:b + 1]),
                                  int(pos[b]), jcfg, row)
        _close(o[b:b + 1], jo)
        for k in c:
            _close(c[k][b:b + 1].to(torch.float32),
                   np.asarray(jrow[k], np.float32),
                   1e-6 if "scale" in k else TOL)


@pytest.mark.parametrize("pos", [12, 15, 40])
def test_attn_decode_past_the_cache_clamps_like_xla(pos):
    """A position at or past the cache length: XLA clamps the write to
    the last slot, rotates at the true position and masks nothing; the
    port's clamped index does the same (and does not raise)."""
    cfg, jcfg, jp, p = _attn("qwen3_1_7b", seed=7)
    jc = _jax_cache(jcfg, False, 7, L_=12, filled=12)
    x = _x((2, 1, cfg.d_model), 12)
    o, c = A.attn_decode(p, torch.from_numpy(x), pos, cfg,
                         _to_port_cache(jc))
    jo, jc2 = JA.attn_decode(jp, jnp.asarray(x), pos, jcfg,
                             jax.tree.map(jnp.asarray, jc))
    _close(o, jo)
    for k in c:
        _close(c[k], jc2[k])
    o2, _ = A.attn_decode(p, torch.from_numpy(x), torch.tensor([pos, 3]),
                          cfg, _to_port_cache(jc))
    _close(o2[:1], jo[:1])


def test_row_positions_rejects_a_wrong_shape():
    with pytest.raises(ValueError, match="pos"):
        A.row_positions(torch.tensor([1, 2, 3]), 2, "cpu")
    assert A.row_positions(5, 3, "cpu").tolist() == [5, 5, 5]


def test_seqshard_decode_waits_for_the_mesh():
    """Without sharding rules the sequence-sharded decode raises; on a
    (1, 1) mesh (a world of 1) the one rank owns every slot, and the
    decode equals ``attn_decode``'s within 1e-5; it takes one position
    for every row."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_world, make_host_mesh
    from repro_torch.sharding.rules import Rules, use_rules
    cfg, _, _, p = _attn("granite_34b", seed=9)
    x = torch.from_numpy(_x((2, 1, cfg.d_model), 14))
    cache = A.init_cache(cfg, 2, 8, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="rules"):
        A.attn_decode_seqshard(p, x, 0, cfg, cache)
    init_world("gloo")
    try:
        with use_rules(Rules(make_host_mesh(1, 1))):
            with pytest.raises(ValueError, match="one position"):
                A.attn_decode_seqshard(p, x, torch.tensor([0, 1]), cfg,
                                       cache)
            c_a = c_b = cache
            for pos in range(3):
                xs = torch.from_numpy(_x((2, 1, cfg.d_model), 20 + pos))
                oa, c_a = A.attn_decode(p, xs, pos, cfg, c_a)
                ob, c_b = A.attn_decode_seqshard(p, xs, pos, cfg, c_b)
                _close(ob, oa.numpy())
            for k in ("k", "v"):
                _close(c_b[k], c_a[k].numpy())
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# on the card (skipped here)
# ----------------------------------------------------------------------
@pytest.mark.cuda
def test_attention_on_card_matches_cpu(card):
    """Plain, flash and decode on the card, held to the CPU within 1e-5."""
    cfg, _, _, p = _attn("qwen3_1_7b", seed=8)
    pd = {k: v.to(card) for k, v in p.items()}
    x, pos = _x((2, 40, cfg.d_model), 13), _positions(2, 40)
    for thr in (2048, 16):
        want = A.attn_forward(p, torch.from_numpy(x), torch.from_numpy(pos),
                              cfg, flash_threshold=thr)
        got = A.attn_forward(pd, torch.from_numpy(x).to(card),
                             torch.from_numpy(pos).to(card), cfg,
                             flash_threshold=thr)
        _close(got.cpu(), want)
    c = A.init_cache(cfg, 2, 8, torch.float32, device="cpu")
    xd = _x((2, 1, cfg.d_model), 14)
    want, _ = A.attn_decode(p, torch.from_numpy(xd), torch.tensor([3, 9]),
                            cfg, c)
    got, _ = A.attn_decode(pd, torch.from_numpy(xd).to(card),
                           torch.tensor([3, 9], device=card), cfg,
                           {k: v.to(card) for k, v in c.items()})
    _close(got.cpu(), want)
    assert to_numpy(pd).keys() == p.keys()
