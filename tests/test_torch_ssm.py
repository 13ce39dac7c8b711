"""The port's SSM path against the JAX package's, on the CPU.

Kernel C (``kernels/ssd_scan.py``) and the Mamba2 model (``models/ssm.py``,
``models/transformer.py``) of the port take the same inputs, made from a
seed with numpy, as the JAX package's; its Pallas kernel runs in interpret
mode, as tests/test_kernels.py runs it.  On the CPU the port's kernel
wrapper runs the plain PyTorch version; the CUDA kernel itself runs only on
a card (``cuda``-marked test, skipped here).

Tolerances: 1e-5 (atol = rtol) for the SSD pieces, as the JAX package
holds its own kernel to its oracle; 2e-5 for whole-model logits and
caches (two layers of f32 matmuls summed in another order), the JAX
package's own decode-versus-forward tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.kernels import ref as jax_ref
from repro.kernels.ssd_scan import ssd_chunked_pallas
from repro.kernels.ssd_scan import ssd_intra_chunk as jax_ssd_intra_chunk
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as K
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.utils.tree import from_numpy, to_numpy

from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
MODEL_TOL = 2e-5


@pytest.fixture
def card():
    """The CUDA device, decided when the test runs (skip without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the "
                    "card (python3 chip_smoke.py drives them there)")
    return torch.device("cuda")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _cells(G, L, P, N, seed, gb=None):
    """Intra-chunk inputs as numpy: xb (G,L,P), b and c (gb,L,N), cum
    (G,1,L) a decreasing cumulative log-decay."""
    rng = np.random.RandomState(seed)
    gb = G if gb is None else gb
    xb = rng.randn(G, L, P).astype(np.float32)
    b = rng.randn(gb, L, N).astype(np.float32)
    c = rng.randn(gb, L, N).astype(np.float32)
    cum = np.cumsum(-np.abs(rng.randn(G, L)) * 0.1, axis=1).astype(
        np.float32)[:, None, :]
    return xb, b, c, cum


def _ssd_inputs(B, S_, H, P, N, seed=0):
    """tests/test_kernels.py's SSD inputs, as numpy."""
    rng = np.random.RandomState(seed)
    xh = rng.randn(B, S_, H, P).astype(np.float32)
    b = (rng.randn(B, S_, N) * 0.3).astype(np.float32)
    c = (rng.randn(B, S_, N) * 0.3).astype(np.float32)
    dt = (np.abs(rng.randn(B, S_, H)) * 0.1).astype(np.float32)
    la = (-np.abs(rng.randn(B, S_, H)) * 0.05).astype(np.float32)
    return xh, b, c, dt, la


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


# ----------------------------------------------------------------------
# (a) kernel C's function, cell by cell
# ----------------------------------------------------------------------
def test_ssd_intra_chunk_plain_matches_jax_kernel_and_oracle():
    """G=3, L=64, P=32, N=16: y, S and a of the plain version against the
    Pallas kernel (interpret mode) and against ref.ssd_chunk_ref."""
    xb, b, c, cum = _cells(3, 64, 32, 16, seed=7)
    y, s, a = K.ssd_intra_chunk_plain(*_t(xb, b, c, cum))
    jy, js, ja = jax_ssd_intra_chunk(*_j(xb, b, c, cum))
    assert y.shape == (3, 64, 32) and s.shape == (3, 16, 32)
    assert a.shape == (3, 1) and y.dtype == torch.float32
    _close(y, jy)
    _close(s, js)
    _close(a, ja)
    for g in range(3):
        ry, rs, ra = jax_ref.ssd_chunk_ref(*_j(xb[g], b[g], c[g],
                                               cum[g, 0]))
        _close(y[g], ry)
        _close(s[g], rs)
        _close(a[g, 0], ra)


def test_ssd_intra_chunk_shares_b_and_c_across_heads():
    """``heads=H``: b and c come once per (batch, chunk) and serve the H
    cells after it -- the JAX kernel given the per-head broadcast copy."""
    H = 4
    xb, b, c, cum = _cells(2 * H, 32, 16, 8, seed=8, gb=2)
    got = K.ssd_intra_chunk_plain(*_t(xb, b, c, cum), heads=H)
    bb, cb = np.repeat(b, H, axis=0), np.repeat(c, H, axis=0)
    want = jax_ssd_intra_chunk(*_j(xb, bb, cb, cum))
    for g_, w_ in zip(got, want):
        _close(g_, w_)


def test_ssd_intra_chunk_wrapper_runs_the_plain_version_on_cpu():
    xb, b, c, cum = _t(*_cells(4, 64, 32, 16, seed=9, gb=2))
    before = K.LAUNCHES
    got = K.ssd_intra_chunk(xb, b, c, cum, heads=2)
    assert K.LAUNCHES == before
    for g_, w_ in zip(got, K.ssd_intra_chunk_plain(xb, b, c, cum, heads=2)):
        assert torch.equal(g_, w_)


@pytest.mark.parametrize("bad", ["L", "P", "N", "heads", "xb_dtype",
                                 "bc_dtype", "cum_shape"])
def test_ssd_intra_chunk_rejects_what_the_kernel_does_not_take(bad):
    xb, b, c, cum = _t(*_cells(4, 64, 32, 16, seed=10))
    heads = 1
    if bad == "L":
        xb, b, c, cum = _t(*_cells(2, 257, 32, 16, seed=10))
    elif bad == "P":
        xb, b, c, cum = _t(*_cells(2, 64, 30, 16, seed=10))
    elif bad == "N":
        xb, b, c, cum = _t(*_cells(2, 64, 32, 132, seed=10))
    elif bad == "heads":
        heads = 3
    elif bad == "xb_dtype":
        xb = xb.to(torch.bfloat16)
    elif bad == "bc_dtype":
        b = b.to(torch.bfloat16)
    elif bad == "cum_shape":
        cum = cum[:, 0]
    err = TypeError if bad.endswith("dtype") else ValueError
    with pytest.raises(err):
        K.ssd_intra_chunk(xb, b, c, cum, heads=heads)


# ----------------------------------------------------------------------
# (b) the full-sequence SSD around it
# ----------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [32, 64, 128])
@pytest.mark.parametrize("N", [16, 32, 128])
def test_ssd_chunked_kernel_matches_jax(chunk, N):
    """ssd_chunked_kernel against the JAX package's ssd_chunked_pallas
    and its model ssd_chunked (the grid of tests/test_kernels.py), and the
    port's own plain ssd_chunked against the JAX one."""
    arrs = _ssd_inputs(2, 256, 2, 64, N)
    y, h = K.ssd_chunked_kernel(*_t(*arrs), chunk)
    yp, hp = ssd_chunked_pallas(*_j(*arrs), chunk)
    ym, hm = JS.ssd_chunked(*_j(*arrs), chunk)
    assert y.shape == (2, 256, 2, 64) and h.shape == (2, 2, 64, N)
    _close(y, yp)
    _close(h, hp)
    _close(y, ym)
    _close(h, hm)
    yo, ho = S.ssd_chunked(*_t(*arrs), chunk)
    _close(yo, ym)
    _close(ho, hm)


def test_ssd_chunked_init_state_matches_jax():
    """``init_state`` seeds the inter-chunk recurrence, as in the JAX
    package's ssd_chunked (its Pallas form has no such argument)."""
    arrs = _ssd_inputs(1, 128, 2, 64, 32, seed=3)
    h0 = np.random.RandomState(4).randn(1, 2, 64, 32).astype(np.float32)
    ym, hm = JS.ssd_chunked(*_j(*arrs), 64, jnp.asarray(h0))
    for fn in (K.ssd_chunked_kernel, S.ssd_chunked, ops.ssd):
        y, h = fn(*_t(*arrs), 64, torch.from_numpy(h0))
        _close(y, ym)
        _close(h, hm)


def test_ssd_chunk_size_invariance():
    """SSD output must not depend on the chunking."""
    arrs = _t(*_ssd_inputs(1, 128, 2, 64, 32, seed=9))
    y1, h1 = K.ssd_chunked_kernel(*arrs, 32)
    y2, h2 = K.ssd_chunked_kernel(*arrs, 128)
    _close(y1, y2, 2e-5)
    _close(h1, h2, 2e-5)


def test_ssd_kernel_bf16():
    """bf16 ``xh`` (y comes back in bf16, relative error < 0.05 against
    f32), and bf16 b and c, which widen exactly: equal to the JAX kernel
    given the same bf16 values."""
    xh, b, c, dt, la = _ssd_inputs(1, 128, 2, 64, 32, seed=11)
    y32, _ = K.ssd_chunked_kernel(*_t(xh, b, c, dt, la), 64)
    y16, _ = K.ssd_chunked_kernel(torch.from_numpy(xh).to(torch.bfloat16),
                                  *_t(b, c, dt, la), 64)
    assert y16.dtype == torch.bfloat16
    rel = float((y32 - y16.float()).abs().max() / (y32.abs().max() + 1e-9))
    assert rel < 0.05
    tb, tc = (torch.from_numpy(a).to(torch.bfloat16) for a in (b, c))
    y, h = K.ssd_chunked_kernel(torch.from_numpy(xh), tb, tc,
                                *_t(dt, la), 64)
    jb, jc = (jnp.asarray(a).astype(jnp.bfloat16) for a in (b, c))
    yj, hj = ssd_chunked_pallas(jnp.asarray(xh), jb, jc, *_j(dt, la), 64)
    _close(y, yj)
    _close(h, hj)


def test_ssd_rejects_a_sequence_the_chunk_does_not_divide():
    arrs = _t(*_ssd_inputs(1, 96, 2, 64, 16))
    with pytest.raises(ValueError, match="not divisible"):
        K.ssd_chunked_kernel(*arrs, 64)


# ----------------------------------------------------------------------
# (c) the Mamba2 model at the smoke config, on the JAX package's weights
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def mamba():
    """(port cfg, JAX cfg, JAX params, the same params in the port)."""
    cfg = get_smoke_config("mamba2-370m")
    jcfg = jax_smoke_config("mamba2_370m")
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    params = from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jcfg, jparams, params


def test_configs_are_the_jax_packages():
    cfg, jcfg = get_config("mamba2-370m"), get_config("mamba2_370m")
    assert cfg == jcfg
    from repro.configs.base import get_config as jax_get_config
    want = jax_get_config("mamba2_370m")
    assert cfg.__dict__ == want.__dict__
    assert (cfg.d_inner, cfg.ssm_heads) == (2048, 32)
    assert cfg.param_count() == want.param_count() == 368176128
    assert get_smoke_config("mamba2-370m").__dict__ == \
        jax_smoke_config("mamba2_370m").__dict__
    for arch in ("whisper_tiny", "internvl2-2b"):
        assert get_config(arch).__dict__ == jax_get_config(arch).__dict__
    with pytest.raises(ValueError):
        get_config("no-such-arch")


def test_init_model_has_the_jax_layout_and_bounds(mamba):
    cfg, _, jparams, _ = mamba
    params = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    want = jax.tree.map(lambda a: a.shape, jparams)
    got = jax.tree.map(lambda a: tuple(a.shape), to_numpy(params))
    assert got == want
    lp = params["layers"]["ssm"]
    assert float(lp["in_proj"].abs().max()) <= 1 / np.sqrt(cfg.d_model)
    assert float(lp["conv_w"].abs().max()) <= 0.5
    _close(lp["a_log"], np.asarray(jparams["layers"]["ssm"]["a_log"]))
    again = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["embed"], params["embed"])


def test_other_families_and_no_device_raise(mamba, monkeypatch):
    cfg = mamba[0]
    from repro.configs.base import get_smoke_config as jsc
    for arch in ("whisper_tiny", "internvl2_2b"):
        # the other families build, in the JAX package's layout
        params = T.init_model(jsc(arch), torch.Generator(), "cpu")
        want = jax.tree.map(lambda a: a.shape, JT.init_model(
            jax.random.PRNGKey(0), jsc(arch)))
        assert jax.tree.map(lambda a: tuple(a.shape),
                            to_numpy(params)) == want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_model(cfg, torch.Generator())


def test_ssm_forward_with_state_matches_jax(mamba):
    """One mixer, ``return_state``: output, SSD state and conv tail."""
    cfg, jcfg, jparams, params = mamba
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"]["ssm"])
    lp = {k: v[0] for k, v in params["layers"]["ssm"].items()
          if not isinstance(v, dict)}
    lp["gate_norm"] = {"scale": params["layers"]["ssm"]["gate_norm"]
                       ["scale"][0]}
    for S_ in (128, 3):                     # two chunks; the shortest
        x = np.random.RandomState(S_).randn(2, S_, cfg.d_model).astype(
            np.float32)
        o, st = S.ssm_forward(lp, torch.from_numpy(x), cfg,
                              return_state=True)
        jo, jst = JS.ssm_forward(jlp, jnp.asarray(x), jcfg,
                                 return_state=True)
        _close(o, jo, MODEL_TOL)
        _close(st["state"], jst["state"], MODEL_TOL)
        _close(st["conv"], jst["conv"], MODEL_TOL)
        assert st["conv"].shape == (2, cfg.ssm_conv_width - 1,
                                    cfg.d_inner + 2 * cfg.ssm_state)


def test_forward_prefill_decode_match_jax(mamba):
    """forward logits, prefill logits and cache, then three decode steps,
    on the same weights and tokens."""
    cfg, jcfg, jparams, params = mamba
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab, (2, 128)).astype(np.int32)
    logits, aux = T.forward(params, {"tokens": torch.from_numpy(toks)}, cfg)
    jlogits, _ = JT.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    assert logits.shape == (2, 128, cfg.vocab) and float(aux) == 0.0
    _close(logits, jlogits, MODEL_TOL)
    lp, cache = T.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg)
    jlp, jcache = JT.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    _close(lp, jlp, MODEL_TOL)
    assert set(cache) == {"state", "conv"}
    for k in cache:
        assert tuple(cache[k].shape) == jcache[k].shape
        _close(cache[k], jcache[k], MODEL_TOL)
    cache = T.extend_cache(cache, 140)
    for t in range(3):
        nxt = rng.randint(0, cfg.vocab, (2, 1)).astype(np.int32)
        dl, cache = T.decode_step(params, torch.from_numpy(nxt), 128 + t,
                                  cfg, cache)
        jdl, jcache = JT.decode_step(jparams, jnp.asarray(nxt),
                                     jnp.int32(128 + t), jcfg, jcache)
        _close(dl, jdl, MODEL_TOL)
        for k in cache:
            _close(cache[k], jcache[k], MODEL_TOL)


def test_decode_matches_forward(mamba):
    """Within the port: the one-token recurrence from a zero cache gives
    the chunked forward's logits at every position."""
    cfg, _, _, params = mamba
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab, (2, 12)).astype(np.int32))
    full, _ = T.forward(params, {"tokens": toks}, cfg)
    cache = T.init_decode_state(cfg, 2, 12, dtype=torch.float32,
                                device="cpu")
    for t in range(12):
        dl, cache = T.decode_step(params, toks[:, t:t + 1], t, cfg, cache)
        _close(dl[:, 0], full[:, t], MODEL_TOL)


def test_prefill_then_decode_continuation(mamba):
    """prefill(prompt) + decode_step(next) == forward(prompt + next)."""
    cfg, _, _, params = mamba
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab, (2, 9)).astype(np.int32))
    full, _ = T.forward(params, {"tokens": toks}, cfg)
    logits, cache = T.prefill(params, {"tokens": toks[:, :8]}, cfg)
    _close(logits[:, 0], full[:, 7], MODEL_TOL)
    dl, _ = T.decode_step(params, toks[:, 8:9], 8, cfg, cache)
    _close(dl[:, 0], full[:, 8], MODEL_TOL)


# ----------------------------------------------------------------------
# (d') the CUDA kernel's split-TF32 arithmetic, emulated in torch
# ----------------------------------------------------------------------
SSD_TOL_FULL = 1e-4      # chip_smoke.py: kernel C against its plain
                         # version at full width (SSD_TOL = TOL elsewhere)


def _tf32(x):
    """Round f32 to TF32 as cvt.rna.tf32.f32 does: 10 mantissa bits, to
    nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _trunc(x):
    """f64 to f32, rounding toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _mm(a, b, mode="split", tile=64):
    """a @ b as the tensor cores form it, one m64nNk8 MMA per 8 columns of
    K, each MMA adding its 8 exact products to its f32 accumulator and
    rounding the sum toward zero (a model of the tensor cores' truncating
    accumulation, not a bit-exact one).  Modes:
    "split": the kernel's split TF32 -- hi*hi in one accumulator, lo*hi
      and hi*lo in another, both fresh for each `tile` columns of K (None:
      all of K) and added to the running sum in f32 with round to nearest;
    "one": split TF32 with all three products in one accumulator over the
      whole of K (the usual 3xTF32);
    "1x": plain 1xTF32 in one accumulator."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    k_len = a.shape[-1]
    out = torch.zeros(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
                      + (a.shape[-2], b.shape[-1]))

    def mma(acc, x, y, s):
        return _trunc(acc.double() + x[..., s].double()
                      @ y[..., s, :].double())

    steps = [slice(k, k + 8) for k in range(0, k_len, 8)]
    if mode != "split":
        acc = out
        for s in steps:
            if mode == "one":
                acc = mma(mma(acc, al, bh, s), ah, bl, s)
            acc = mma(acc, ah, bh, s)
        return acc
    per = len(steps) if tile is None else tile // 8
    for t in range(0, len(steps), per):
        hh = corr = torch.zeros_like(out)
        for s in steps[t:t + per]:
            hh = mma(hh, ah, bh, s)
            corr = mma(mma(corr, al, bh, s), ah, bl, s)
        out = out + (hh + corr)
    return out


def _ssd_split_tf32(xb, b, c, cum, heads, mode="split"):
    """Kernel C's function with its products on the emulated tensor cores
    (:func:`_mm`): C Bt once per (batch, chunk) over all of N, scores
    masked in the exponent, y = scores Xb and S = Bt (d o Xb) with Xb
    scaled by the decay to the chunk's end, both folded per 64 positions;
    ragged L padded with zeros to a multiple of 8, as in shared memory."""
    G, L, P = xb.shape
    gb = G // heads
    pad = (-L) % 8
    x = torch.nn.functional.pad(xb.reshape(gb, heads, L, P),
                                (0, 0, 0, pad))
    bf, cf = b.float(), c.float()
    cm = cum.reshape(gb, heads, L)
    cb = _mm(cf, bf.transpose(1, 2), mode, tile=None)[:, None]
    tril = torch.ones((L, L), dtype=torch.bool).tril()
    diff = torch.where(tril, cm[..., :, None] - cm[..., None, :],
                       torch.tensor(float("-inf")))
    scores = torch.nn.functional.pad(cb * torch.exp(diff), (0, pad))
    y = _mm(scores, x, mode)[..., :L, :]
    d = torch.nn.functional.pad(torch.exp(cm[..., -1:] - cm), (0, pad))
    bt = torch.nn.functional.pad(bf.transpose(1, 2), (0, pad))[:, None]
    s = _mm(bt, x * d[..., None], mode)
    return (y.reshape(G, L, P), s.reshape(G, -1, P),
            torch.exp(cm[..., -1]).reshape(G, 1))


def _smoke_cells(G, heads, L, P, N, seed, dtype):
    """chip_smoke.py's ssd_cells inputs, on the CPU."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    xb = t(rng.randn(G, L, P))
    b = t(rng.randn(G // heads, L, N) * 0.3).to(dtype)
    c = t(rng.randn(G // heads, L, N) * 0.3).to(dtype)
    cum = t(np.cumsum(-np.abs(rng.randn(G, 1, L)) * 0.05, axis=-1))
    return xb, b, c, cum


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_split_tf32_holds_the_full_width_tolerance(dtype):
    """The full-width cell (one 512-token prompt of Mamba2-370M: G = 64,
    L=256, P=64, N=128) in split TF32 stays within SSD_TOL_FULL of the
    plain f32 version; plain 1xTF32 would not."""
    cfg = get_config("mamba2-370m")
    H, L, P, N = cfg.ssm_heads, cfg.ssm_chunk, cfg.ssm_head_dim, \
        cfg.ssm_state
    xb, b, c, cum = _smoke_cells(2 * H, H, L, P, N, 7, dtype)
    want = K.ssd_intra_chunk_plain(xb, b, c, cum, heads=H)
    for g_, w_ in zip(_ssd_split_tf32(xb, b, c, cum, H), want):
        torch.testing.assert_close(g_, w_, atol=SSD_TOL_FULL,
                                   rtol=SSD_TOL_FULL)
    y1 = _ssd_split_tf32(xb, b, c, cum, H, mode="1x")[0]
    assert not torch.allclose(y1, want[0], atol=SSD_TOL_FULL,
                              rtol=SSD_TOL_FULL)


@pytest.mark.parametrize("chunk", [32, 64, 128])
@pytest.mark.parametrize("N", [16, 32, 128])
def test_split_tf32_holds_the_jax_tests_tolerance(chunk, N):
    """At the JAX tests' sizes (B=2, H=2 over 256 positions, P=64) split
    TF32 stays within their 1e-5 of the plain version and of the Pallas
    kernel, f32 and bf16 b and c; also at ragged L."""
    for dtype in (torch.float32, torch.bfloat16):
        xb, b, c, cum = _smoke_cells(4 * (256 // chunk), 2, chunk, 64, N,
                                     chunk + N, dtype)
        got = _ssd_split_tf32(xb, b, c, cum, 2)
        for g_, w_ in zip(got, K.ssd_intra_chunk_plain(xb, b, c, cum, 2)):
            _close(g_, w_)
    xb, b, c, cum = _smoke_cells(6, 3, 200 if N == 128 else 12, 64, N, 5,
                                 torch.float32)
    bb, cb = (np.repeat(a.numpy(), 3, axis=0) for a in (b, c))
    want = jax_ssd_intra_chunk(*_j(xb.numpy(), bb, cb, cum.numpy()))
    for g_, w_ in zip(_ssd_split_tf32(xb, b, c, cum, 3), want):
        _close(g_, w_)


# The card test's cells (test_ssd_kernel_matches_plain_on_card): G,
# heads, L, P, N, with head counts the head group does not divide (3, 6),
# ragged L and N = 8.  Its inputs are of unit scale, where the tensor
# cores' truncation shows most.
CARD_CELLS = ((8, 2, 64, 64, 32), (64, 32, 256, 64, 128), (6, 3, 12, 16, 8),
              (12, 6, 200, 64, 8), (6, 3, 256, 32, 128), (6, 6, 100, 64, 16))


def _card_cell(G, heads, L, P, N, dtype):
    xb, b, c, cum = _t(*_cells(G, L, P, N, seed=L + N, gb=G // heads))
    return xb, b.to(dtype), c.to(dtype), cum, (1e-4 if L == 256 else TOL)


@pytest.mark.parametrize("cell", CARD_CELLS, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_split_tf32_per_tile_fold_holds_the_card_tolerance(cell, dtype):
    """On the emulated tensor cores the kernel's arithmetic (hi*hi and the
    corrections apart, folded per 64 positions in f32) holds the card
    test's tolerances at its unit-scale inputs."""
    xb, b, c, cum, tol = _card_cell(*cell, dtype)
    want = K.ssd_intra_chunk_plain(xb, b, c, cum, heads=cell[1])
    for g_, w_ in zip(_ssd_split_tf32(xb, b, c, cum, cell[1]), want):
        torch.testing.assert_close(g_, w_, atol=tol, rtol=tol)


@pytest.mark.parametrize("cell", [(8, 2, 64, 64, 32), (6, 6, 100, 64, 16)],
                         ids=str)
def test_split_tf32_one_accumulator_misses_the_card_tolerance(cell):
    """The usual 3xTF32, all three products in one accumulator over the
    whole sum, misses the same tolerance on the emulated tensor cores:
    what the per-tile fold is for."""
    xb, b, c, cum, tol = _card_cell(*cell, torch.float32)
    want = K.ssd_intra_chunk_plain(xb, b, c, cum, heads=cell[1])
    got = _ssd_split_tf32(xb, b, c, cum, cell[1], mode="one")
    assert not all(torch.allclose(g_, w_, atol=tol, rtol=tol)
                   for g_, w_ in zip(got, want))


# ----------------------------------------------------------------------
# (e) the CUDA kernel against its plain version, on the card
# ----------------------------------------------------------------------
@pytest.mark.cuda
def test_ssd_kernel_matches_plain_on_card(card):
    for dtype in (torch.float32, torch.bfloat16):
        for cell in CARD_CELLS:
            heads = cell[1]
            *cpu, tol = _card_cell(*cell, dtype)
            xb, b, c, cum = (t.to(card) for t in cpu)
            before = K.LAUNCHES
            got = K.ssd_intra_chunk(xb, b, c, cum, heads=heads)
            assert K.LAUNCHES == before + 1
            want = K.ssd_intra_chunk_plain(xb, b, c, cum, heads=heads)
            for g_, w_ in zip(got, want):
                torch.testing.assert_close(g_, w_, atol=tol, rtol=tol)
