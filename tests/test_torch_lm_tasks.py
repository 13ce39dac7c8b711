"""The port's LM FL tasks (``transformer_lm``, ``moe_lm``, ``ssm_lm``)
against the JAX package's, on the CPU: nested parameter trees in
``jax.tree.leaves`` order, ``lm_loss`` and its gradient, each task's
functions, TEASQ runs (serial packed and cohort), the four-family fleet,
and checkpoint blobs crossing between the two packages.

JAX weights come across with ``utils.tree.from_numpy``; the JAX side runs
as its own tests run it.  Tolerances, and why:

* losses within 1e-5 and gradients within ``atol=1e-5, rtol=1e-4`` (JAX
  ``tests/test_perf_variants.py``'s): the same f32 sums in another order;
* a task's cohort loss of a stacked singleton equals its serial loss
  within ``rtol=1e-6`` (JAX ``tests/test_tasks.py``);
* ``make_data``, the packed wire stream and checkpoint weights: exact;
* a run: time, round and byte columns exact, accuracy within
  ``ACC_TOL`` absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core.codecs import resolve_codec as jax_resolve_codec
from repro.fl import fleet as jfleet
from repro.fl import tasks as jtasks
from repro.fl.protocols import make_setup as jax_make_setup
from repro.fl.protocols import make_sim as jax_make_sim
from repro.fl.protocols import run_method as jax_run_method
from repro.fl.simulator import SimConfig as JSimConfig
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro_torch.checkpoint import io as tio
from repro_torch.configs.base import get_smoke_config
from repro_torch.core.codecs import resolve_codec
from repro_torch.fl.fleet import FleetConfig, build_fleet
from repro_torch.fl.protocols import make_setup, make_sim, run_method
from repro_torch.fl.simulator import SimConfig
from repro_torch.fl.tasks import LM_SEQ_LEN, get_task
from repro_torch.kernels import ssd_scan as K
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.utils.tree import (from_numpy, leaves, paths, to_numpy,
                                    unflatten)

from conftest import TINY_RUN_KW, TINY_SETUP
from torch_threads import one_torch_thread  # noqa: F401

LM_TASKS = ["transformer_lm", "moe_lm", "ssm_lm"]
ACC_TOL = 0.025
LOSS_TOL = 1e-5
COLUMNS = ("time", "round", "bytes_up", "bytes_down", "max_model_bytes_up",
           "max_model_bytes_down")


def _jax_weights(name, seed=0):
    """(JAX params, the same as numpy) of task ``name``'s model."""
    jp = jtasks.get_task(name).init_params(jax.random.PRNGKey(seed))
    return jp, jax.tree.map(np.asarray, jp)


def _tokens(shape, seed):
    return np.random.RandomState(seed).randint(0, 64, shape).astype(
        np.int32)


def _grads_close(got, want, atol=1e-5, rtol=1e-4):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol,
                                   rtol=rtol)


# ----------------------------------------------------------------------
# nested trees
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["transformer_lm", "jamba_v0_1_52b",
                                  "whisper_tiny"])
def test_nested_tree_order_is_jax_tree_leaves(arch):
    """``leaves``/``paths`` walk a nested dict in ``jax.tree.leaves``
    order, and ``unflatten`` inverts them."""
    if arch in LM_TASKS:
        _, np_w = _jax_weights(arch)
    else:
        np_w = jax.tree.map(np.asarray, JT.init_model(
            jax.random.PRNGKey(0), jax_smoke_config(arch)))
    want = [np.asarray(a) for a in jax.tree.leaves(np_w)]
    got = leaves(np_w)
    assert len(got) == len(want) > 8
    assert all(a is b or np.array_equal(a, b) for a, b in zip(got, want))
    names = paths(np_w)
    jpaths = [tuple(k.key for k in p) for p, _ in
              jax.tree_util.tree_flatten_with_path(np_w)[0]]
    assert names == jpaths
    back = unflatten(names, got)
    assert jax.tree.structure(back) == jax.tree.structure(np_w)


def test_flat_dict_order_is_unchanged():
    """A flat dict (the CNN's, the MLP's) keeps its sorted-key order:
    its paths are its sorted keys as 1-tuples."""
    w = get_task("fmnist_cnn").init_params(torch.Generator().manual_seed(0),
                                           "cpu")
    assert paths(w) == [(k,) for k in sorted(w)]
    assert [id(v) for v in leaves(w)] == [id(w[k]) for k in sorted(w)]
    back = unflatten(paths(w), leaves(w))
    assert list(back) == sorted(w) and all(back[k] is w[k] for k in w)


# ----------------------------------------------------------------------
# lm_loss and its gradient
# ----------------------------------------------------------------------
def _loss_pair(cfg_name):
    """(port cfg, JAX cfg, JAX params, port params) of an LM task's model
    or of a registry smoke config."""
    if cfg_name in LM_TASKS:
        jcfg = jtasks.get_task(cfg_name).model_cfg
        cfg = get_task(cfg_name).model_cfg
        jp, np_w = _jax_weights(cfg_name)
    else:
        jcfg, cfg = jax_smoke_config(cfg_name), get_smoke_config(cfg_name)
        jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
        np_w = jax.tree.map(np.asarray, jp)
    return cfg, jcfg, jp, from_numpy(np_w, "cpu")


@pytest.mark.parametrize("loss_chunk", [0, 4, 8])
@pytest.mark.parametrize("arch", LM_TASKS + ["qwen3_1_7b"])
def test_lm_loss_and_gradient_match_jax(arch, loss_chunk):
    """Dense and chunked (``loss_chunk`` 4 and 8, ragged at 32 / 8 + 1)
    next-token loss with MoE's load-balance term, and its gradient."""
    cfg, jcfg, jp, tp = _loss_pair(arch)
    S = 33 if arch == "qwen3_1_7b" else LM_SEQ_LEN
    toks = np.random.RandomState(2).randint(0, cfg.vocab, (2, S)).astype(
        np.int32)

    def jloss(p):
        return JT.lm_loss(p, {"tokens": jnp.asarray(toks)}, jcfg,
                          loss_chunk=loss_chunk)

    (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    ws = [a.requires_grad_(True) for a in leaves(tp)]
    tl, taux = T.lm_loss(tp, {"tokens": torch.from_numpy(toks)}, cfg,
                         loss_chunk=loss_chunk)
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    np.testing.assert_allclose(float(taux["nll"].detach()),
                               float(jaux["nll"]), atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(float(taux["lb"].detach()), float(jaux["lb"]),
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    _grads_close(torch.autograd.grad(tl, ws), jax.tree.leaves(jg))


# ----------------------------------------------------------------------
# the tasks
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", LM_TASKS)
def test_task_functions_match_jax(name):
    """``make_data`` bit-exact; ``loss``, ``eval_metric`` and ``forward``
    against the JAX task's on the JAX weights; the config is the JAX
    task's; ``init_params`` has its layout."""
    t, jt = get_task(name), jtasks.get_task(name)
    assert t.model_cfg.__dict__ == jt.model_cfg.__dict__
    d, jd = t.make_data(48, 24, 5), jt.make_data(48, 24, 5)
    for k in jd:
        assert d[k].dtype == jd[k].dtype
        np.testing.assert_array_equal(d[k], jd[k])
    jp, np_w = _jax_weights(name, seed=1)
    tp = from_numpy(np_w, "cpu")
    x, y = d["x_train"][:8], d["y_train"][:8]
    np.testing.assert_allclose(
        float(t.loss(tp, {"images": torch.from_numpy(x),
                          "labels": torch.from_numpy(y)})),
        float(jt.loss(jp, {"images": jnp.asarray(x), "labels": y})),
        atol=LOSS_TOL, rtol=LOSS_TOL)
    np.testing.assert_allclose(
        t.forward(tp, torch.from_numpy(x)).detach().numpy(),
        np.asarray(jt.forward(jp, jnp.asarray(x))), atol=1e-4, rtol=1e-4)
    xt = d["x_test"]
    assert float(t.eval_metric(tp, torch.from_numpy(xt), None)) == \
        pytest.approx(float(jt.eval_metric(jp, jnp.asarray(xt), None)),
                      abs=1e-6)
    w = t.init_params(torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), to_numpy(w)) == \
        jax.tree.map(lambda a: a.shape, np_w)


@pytest.mark.parametrize("name", LM_TASKS)
def test_cohort_loss_singleton_and_jax(name):
    """The cohort loss (``torch.func.vmap`` of the serial loss) of a
    stacked singleton equals the serial loss; over 3 devices with their
    own weights it and its gradient equal the JAX cohort loss's."""
    t, jt = get_task(name), jtasks.get_task(name)
    _, np_w = _jax_weights(name, seed=2)
    tp = from_numpy(np_w, "cpu")
    x = _tokens((8, LM_SEQ_LEN), 3)
    serial = float(t.loss(tp, {"images": torch.from_numpy(x),
                               "labels": None}))
    one = from_numpy(jax.tree.map(lambda a: a[None], np_w), "cpu")
    cohort = float(t.cohort_loss(one, torch.from_numpy(x)[None], None))
    np.testing.assert_allclose(cohort, serial, rtol=1e-6, atol=1e-7)

    rng = np.random.RandomState(4)
    stacked = jax.tree.map(lambda a: np.stack([
        a + (rng.randn(*a.shape) * 0.01).astype(np.float32)
        for _ in range(3)]), np_w)
    xs = _tokens((3, 8, LM_SEQ_LEN), 5)
    ys = np.zeros((3, 8), np.int32)
    jl, jg = jax.value_and_grad(jt.cohort_loss)(
        jax.tree.map(jnp.asarray, stacked), jnp.asarray(xs), ys)
    ts = from_numpy(stacked, "cpu")
    ws = [a.requires_grad_(True) for a in leaves(ts)]
    tl = t.cohort_loss(ts, torch.from_numpy(xs), torch.from_numpy(ys))
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    _grads_close(torch.autograd.grad(tl, ws), jax.tree.leaves(jg))


@pytest.mark.parametrize("name", LM_TASKS)
def test_codec_roundtrip_and_packed_stream(name):
    """Every LM tree survives the wire: packed and dense decode alike
    (stochastic rounding from one seed, in the nested draw order), and
    the deterministic packed stream (kernel A's plain version here) is
    byte-for-byte the JAX codec's on the same nested tree."""
    jp, np_w = _jax_weights(name, seed=3)
    tp = from_numpy(np_w, "cpu")
    dec_p, n_p = resolve_codec("packed", 0.25, 8).roundtrip(
        tp, rng=np.random.RandomState(7))
    dec_d, n_d = resolve_codec("dense", 0.25, 8).roundtrip(
        tp, rng=np.random.RandomState(7))
    assert n_p == n_d > 0
    assert paths(dec_p) == paths(tp) == paths(dec_d)
    for o, a, b in zip(leaves(tp), leaves(dec_p), leaves(dec_d)):
        assert a.shape == o.shape and torch.isfinite(a).all()
        assert torch.equal(a, b)
    jdec, jn = jax_resolve_codec("packed", 0.25, 8).roundtrip(
        jp, rng=np.random.RandomState(7))
    assert jn == n_p
    for a, b in zip(leaves(dec_p), jax.tree.leaves(jdec)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    wire = resolve_codec("packed", 0.25, 8).encode(tp)
    jwire = jax_resolve_codec("packed", 0.25, 8).encode(jp)
    assert bytes(wire.payload) == bytes(jwire.payload)


# ----------------------------------------------------------------------
# end to end
# ----------------------------------------------------------------------
def _setups(name):
    setup = dict(TINY_SETUP, task=name)
    jdata, jparts, jw0 = jax_make_setup(**setup)
    data, parts, w0 = make_setup(**setup, device="cpu",
                                 init_params=jax.tree.map(np.asarray, jw0))
    np.testing.assert_array_equal(data["x_train"], jdata["x_train"])
    return (jdata, jparts, jw0), (data, parts, w0)


def _histories_match(h_jax, h_port):
    assert len(h_jax) == len(h_port) > 2
    for a, b in zip(h_jax, h_port):
        for c in COLUMNS:
            assert getattr(a, c) == getattr(b, c), c
        assert abs(a.accuracy - b.accuracy) <= ACC_TOL


@pytest.mark.parametrize("path", ["serial_packed", "cohort"])
@pytest.mark.parametrize("name", LM_TASKS)
def test_teasq_runs_match_live_jax(name, path):
    """TEASQ on each LM task through ``run_method``: the serial trainer
    with the packed wire, and the cohort trainer (kernel B's channel
    form's plain version, the vmapped cohort loss)."""
    (jdata, jparts, jw0), (data, parts, w0) = _setups(name)
    extra = (dict(codec="packed") if path == "serial_packed"
             else dict(cohort_size=4, codec="packed"))
    kw = dict(TINY_RUN_KW, task=name, p_s=0.25, p_q=8, **extra)
    h_jax = jax_run_method("teasq", jdata, jparts, jw0, **kw)
    h_port = run_method("teasq", data, parts, w0, device="cpu", **kw)
    _histories_match(h_jax, h_port)


def _four_family(sim_config):
    """JAX ``tests/test_fleet.py``'s heterogeneous fleet: the CNN and the
    three LM families on one shared 8-device fleet."""
    return [sim_config(method="teasq", epochs=1, p_s=0.25, p_q=8),
            sim_config(method="fedasync", task="transformer_lm", epochs=1),
            sim_config(method="fedasync", task="moe_lm", epochs=1),
            sim_config(method="teasq", task="ssm_lm", epochs=1, p_s=0.25,
                       p_q=8)]


def test_four_family_fleet_matches_live_jax():
    common = dict(n_devices=8, seed=0, scheduler="batched",
                  assigner="adaptive")
    jf = jfleet.build_fleet(jfleet.FleetConfig(
        tasks=_four_family(JSimConfig), **common), n_train=320, n_test=128)
    w0s = [jax.tree.map(np.asarray, rt.server.w) for rt in jf.runtimes]
    tf = build_fleet(FleetConfig(tasks=_four_family(SimConfig), **common),
                     n_train=320, n_test=128, device="cpu", init_params=w0s)
    hj, ht = jf.run(time_budget=2.0), tf.run(time_budget=2.0)
    assert len(hj) == len(ht) == 4
    for a_h, b_h, jr, tr in zip(hj, ht, jf.runtimes, tf.runtimes):
        assert len(a_h) == len(b_h) >= 1
        for a, b in zip(a_h, b_h):
            for c in COLUMNS:
                assert getattr(a, c) == getattr(b, c), c
            assert abs(a.accuracy - b.accuracy) <= ACC_TOL
        assert tr.server.t == jr.server.t >= 1
        assert tr.stats.dispatches == jr.stats.dispatches
    assert all(rt.devices is tf.devices for rt in tf.runtimes)


# ----------------------------------------------------------------------
# checkpoints across the two packages, and the FL -> serve bridge
# ----------------------------------------------------------------------
def _trained_lm_engines(tmp_path):
    """A short transformer_lm TEASQ run in each package from the same
    weights, each ``state_dict`` saved by its own package's writer."""
    (jdata, jparts, jw0), (data, parts, w0) = _setups("transformer_lm")
    cfg = dict(n_devices=TINY_SETUP["n_devices"], task="transformer_lm",
               epochs=1, seed=3, p_s=0.25, p_q=8)
    jeng = jax_make_sim(jdata, jparts, jw0, JSimConfig(**cfg))
    jeng.run(2.0)
    teng = make_sim(data, parts, w0, SimConfig(**cfg), device="cpu")
    teng.run(2.0)
    jpath, tpath = str(tmp_path / "jax.msgpack"), str(tmp_path / "t.msgpack")
    jio.save_blob(jpath, jeng.state_dict())
    tio.save_blob(tpath, teng.state_dict())
    return jeng, teng, jpath, tpath


def test_engine_blobs_cross_into_load_task_params(tmp_path):
    """A JAX-written transformer_lm engine blob loads into the port's
    ``load_task_params`` with the JAX engine's weights, bit for bit, and
    the port's blob into the JAX package's; a port engine resumes from
    the JAX blob."""
    jeng, teng, jpath, tpath = _trained_lm_engines(tmp_path)
    params, cfg = serve.load_task_params(jpath, "transformer_lm",
                                         device="cpu")
    assert cfg is get_task("transformer_lm").model_cfg
    want = jax.tree.leaves(jeng.server.w)
    assert paths(params) == [tuple(k.key for k in p) for p, _ in
                             jax.tree_util.tree_flatten_with_path(
                                 jeng.server.w)[0]]
    for a, b in zip(leaves(params), want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jparams, _ = jserve.load_task_params(tpath, "transformer_lm")
    for a, b in zip(jax.tree.leaves(jparams), leaves(teng.server.w)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    teng.load_state(tio.load_blob(jpath))
    for a, b in zip(leaves(teng.server.w), want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fleet_blob_job_picks_its_weights(tmp_path, capsys):
    """``--job`` picks a fleet blob's job: the JAX four-family fleet's
    blob, served by the port for the transformer and the SSM jobs, and
    the port's fleet blob read by the JAX package's
    ``load_task_params``."""
    jf = jfleet.build_fleet(jfleet.FleetConfig(
        tasks=_four_family(JSimConfig), n_devices=8, seed=0,
        scheduler="batched", assigner="weighted"), n_train=160, n_test=64)
    jf.run(time_budget=1.0)
    path = str(tmp_path / "fleet.msgpack")
    jio.save_blob(path, jf.state_dict())
    for job, name in ((1, "transformer_lm"), (3, "ssm_lm")):
        params, _ = serve.load_task_params(path, name, job=job,
                                           device="cpu")
        for a, b in zip(leaves(params),
                        jax.tree.leaves(jf.runtimes[job].server.w)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        with pytest.raises(ValueError):
            serve.load_task_params(path, name, job=0, device="cpu")
    serve.main(["--from-sim", path, "--task", "ssm_lm", "--job", "3",
                "--device", "cpu", "--batch", "2", "--requests", "3",
                "--prompt-len", "8", "--gen", "3"])
    assert "fl-ssm-lm from" in capsys.readouterr().out
    # and the port's fleet blob into the JAX package's load_task_params
    tf = build_fleet(FleetConfig(
        tasks=_four_family(SimConfig), n_devices=8, seed=0,
        scheduler="batched", assigner="weighted"), n_train=160, n_test=64,
        device="cpu")
    tf.run(time_budget=1.0)
    tpath = str(tmp_path / "port_fleet.msgpack")
    tio.save_blob(tpath, tf.state_dict())
    for job, name in ((1, "transformer_lm"), (2, "moe_lm")):
        jparams, _ = jserve.load_task_params(tpath, name, job=job)
        for a, b in zip(jax.tree.leaves(jparams),
                        leaves(tf.runtimes[job].server.w)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ----------------------------------------------------------------------
# kernel C's gradient on the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python3 chip_smoke.py phase 27 "
                    "checks kernel C's gradient there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_c_gradient_on_card(card):
    """``ssm_lm``'s loss differentiated through kernel C on the card
    equals autograd through the plain version (within phase 27's
    ``SSD_TOL``): before the autograd Function, the intra-chunk terms'
    gradient was dropped on the card.  The kernel route runs C's forward
    and its backward kernel, the plain route neither."""
    t = get_task("ssm_lm")
    _, np_w = _jax_weights("ssm_lm", seed=6)
    x = torch.from_numpy(_tokens((8, LM_SEQ_LEN), 7)).to(card)
    grads = []
    for plain in (False, True):
        tp = from_numpy(np_w, card)
        ws = [a.requires_grad_(True) for a in leaves(tp)]
        before, bwd_before = K.LAUNCHES, K.BWD_LAUNCHES
        if plain:
            real = K.ssd_intra_chunk
            K.ssd_intra_chunk = K.ssd_intra_chunk_plain
        try:
            loss = t.loss(tp, {"images": x, "labels": None})
            grads.append(torch.autograd.grad(loss, ws))
        finally:
            if plain:
                K.ssd_intra_chunk = real
        assert (K.LAUNCHES > before) != plain
        assert (K.BWD_LAUNCHES > bwd_before) != plain
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
