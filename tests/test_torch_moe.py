"""The port's MoE FFN (``models/moe.py``) against the JAX package's, on the CPU.

The router, the top-k routing (ties included), the load-balance loss, the
dense reference and ``moe_apply`` take the same inputs, made from a seed
with numpy, and the JAX package's own weights carried across with
``utils.tree.from_numpy``.

Tolerances: routing weights and probabilities within 1e-6, the chosen
experts exactly equal; FFN outputs within 1e-5 (atol = rtol); the
load-balance loss within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import moe as JM
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import moe as M
from repro_torch.utils.tree import from_numpy

from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
ROUTE_TOL = 1e-6
# top-2 of 4 (phi3.5), top-2 of 4 with narrow experts (moonshot), top-1
# (llama4)
ARCHS = ["phi3_5_moe_42b", "moonshot_v1_16b", "llama4_scout_17b"]


@pytest.fixture
def card():
    """The CUDA device, decided when the test runs (skip without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python3 chip_smoke.py drives the "
                    "MoE path there)")
    return torch.device("cuda")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _moe(arch, seed=0):
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    jp = JM.moe_init(jax.random.PRNGKey(seed), jcfg)
    return cfg, jcfg, jp, from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_layout_matches_jax(arch):
    cfg, _, jp, _ = _moe(arch)
    mine = M.moe_init(torch.Generator().manual_seed(0), cfg, lead=(2,))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: (2,) + v.shape for k, v in jp.items()}
    assert mine["router"].dtype == torch.float32
    assert float(mine["e_down"].abs().max()) <= 1 / np.sqrt(cfg.d_ff)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch):
    cfg, _, jp, p = _moe(arch, seed=1)
    x = _x((24, cfg.d_model), 2)
    w, e, probs = M._route(p["router"], torch.from_numpy(x), cfg.moe_top_k)
    jw, je, jprobs = JM._route(jp["router"], jnp.asarray(x), cfg.moe_top_k)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    _close(w, jw, ROUTE_TOL)
    _close(probs, jprobs, ROUTE_TOL)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_tied_logits_go_to_the_lower_index_as_in_jax(k):
    """Router columns repeated so that logits tie exactly: the chosen
    experts are jax.lax.top_k's (the lower index first)."""
    rng = np.random.RandomState(3)
    cols = rng.randn(16, 3).astype(np.float32)
    router = cols[:, [0, 1, 0, 2, 1, 1, 0, 2]]          # (16, 8), tied
    x = rng.randn(10, 16).astype(np.float32)
    x[0] = 0.0                                           # every logit tied
    w, e, _ = M._route(torch.from_numpy(router), torch.from_numpy(x), k)
    jw, je, _ = JM._route(jnp.asarray(router), jnp.asarray(x), k)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    _close(w, jw, ROUTE_TOL)
    assert e[0].tolist() == list(range(k))
    vals = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    _, idx = M._top_k(vals, 3)
    assert idx.tolist() == [[1, 2, 4]]


def test_load_balance_loss_matches_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(30, 6).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    top_e = np.argsort(-logits, axis=-1)[:, :2]
    got = M._load_balance_loss(torch.from_numpy(probs),
                               torch.from_numpy(top_e), 6)
    want = JM._load_balance_loss(jnp.asarray(probs), jnp.asarray(top_e), 6)
    _close(got, want, ROUTE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_ref_matches_jax(arch):
    cfg, jcfg, jp, p = _moe(arch, seed=5)
    x = _x((20, cfg.d_model), 6)
    y, aux = M._moe_dense_ref(p, torch.from_numpy(x), cfg)
    jy, jaux = JM._moe_dense_ref(jp, jnp.asarray(x), jcfg)
    _close(y, jy)
    _close(aux, jaux, ROUTE_TOL)


def test_expert_ffn_matches_jax():
    cfg, _, jp, p = _moe("phi3_5_moe_42b", seed=7)
    xb = _x((cfg.n_experts, 5, cfg.d_model), 8)
    got = M._expert_ffn(p["e_gate"], p["e_up"], p["e_down"],
                        torch.from_numpy(xb))
    want = JM._expert_ffn(jp["e_gate"], jp["e_up"], jp["e_down"],
                          jnp.asarray(xb))
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch):
    """(B, S, D) through the no-mesh route, with the load-balance loss."""
    cfg, jcfg, jp, p = _moe(arch, seed=9)
    x = _x((2, 7, cfg.d_model), 10)
    y, aux = M.moe_apply(p, torch.from_numpy(x), cfg)
    jy, jaux = JM.moe_apply(jp, jnp.asarray(x), jcfg)
    assert y.shape == x.shape and aux.dim() == 0
    _close(y, jy)
    _close(aux, jaux, ROUTE_TOL)


@pytest.mark.cuda
def test_moe_on_card_matches_cpu(card):
    cfg, _, _, p = _moe("phi3_5_moe_42b", seed=11)
    x = _x((2, 7, cfg.d_model), 12)
    want, waux = M.moe_apply(p, torch.from_numpy(x), cfg)
    got, gaux = M.moe_apply({k: v.to(card) for k, v in p.items()},
                            torch.from_numpy(x).to(card), cfg)
    _close(got.cpu(), want)
    _close(gaux.cpu(), waux, ROUTE_TOL)
