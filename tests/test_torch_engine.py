"""The whole slice: the port's engine against a live run of the JAX
package's, on the CPU, from the same data, partitions and weights.

The workload is the canonical parity one of tests/conftest.py (8 devices,
seed 3).  Everything random is numpy in both packages and wire sizes are
shape-only, so the time, round and byte columns of the two ``LogEntry``
histories must be equal.  Accuracy moves with float arithmetic (see
tests/test_torch_cnn.py): it must agree within ``ACC_TOL`` absolute per
entry (8 of 320 test samples).  The comparison is against a live JAX run,
never against tests/data/pinned_histories.json.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.fl.engine import DeviceRegistry as JDeviceRegistry
from repro.fl.protocols import make_setup as jax_make_setup
from repro.fl.protocols import \
    profile_compression as jax_profile_compression
from repro.fl.protocols import run_method as jax_run_method
from repro.fl.simulator import ScenarioConfig as JScenarioConfig
from repro.fl.simulator import SimConfig as JSimConfig
from repro_torch.fl import engine as tengine
from repro_torch.fl.protocols import (make_setup, make_sim,
                                      profile_compression, run_method)
from repro_torch.fl.simulator import ScenarioConfig, SimConfig
from repro_torch.utils.tree import to_numpy

from conftest import TINY_RUN_KW, TINY_SETUP
from torch_threads import one_torch_thread  # noqa: F401

ACC_TOL = 0.025
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLUMNS = ("time", "round", "bytes_up", "bytes_down", "max_model_bytes_up",
           "max_model_bytes_down")


@pytest.fixture(scope="module")
def setups():
    """(JAX setup, port setup), the port's w0 carried over from JAX's."""
    jdata, jparts, jw0 = jax_make_setup(**TINY_SETUP)
    w_np = {k: np.asarray(v) for k, v in jw0.items()}
    port = make_setup(**TINY_SETUP, device="cpu", init_params=w_np)
    return (jdata, jparts, jw0), port


def _assert_parity(h_jax, h_port):
    assert len(h_jax) == len(h_port) > 1
    for a, b in zip(h_jax, h_port):
        for c in COLUMNS:
            assert getattr(a, c) == getattr(b, c), c
        assert abs(a.accuracy - b.accuracy) <= ACC_TOL


def test_data_partitions_and_weights_bit_equal(setups):
    (jdata, jparts, jw0), (data, parts, w0) = setups
    for k in jdata:
        np.testing.assert_array_equal(data[k], jdata[k])
    assert len(parts) == len(jparts)
    for a, b in zip(parts, jparts):
        np.testing.assert_array_equal(a, b)
    for k, v in to_numpy(w0).items():
        np.testing.assert_array_equal(v, np.asarray(jw0[k]))
    j_non = jax_make_setup(**{**TINY_SETUP, "iid": False})[1]
    t_non = make_setup(**{**TINY_SETUP, "iid": False}, device="cpu")[1]
    for a, b in zip(t_non, j_non):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["tea", "teasq"])
@pytest.mark.parametrize("codec", ["dense", "packed"])
def test_run_method_matches_live_jax(setups, method, codec):
    (jdata, jparts, jw0), (data, parts, w0) = setups
    kw = dict(TINY_RUN_KW, p_s=0.25, p_q=8, codec=codec)
    h_jax = jax_run_method(method, jdata, jparts, jw0, **kw)
    h_port = run_method(method, data, parts, w0, device="cpu", **kw)
    _assert_parity(h_jax, h_port)
    assert h_port[-1].round >= 4


def test_scenario_hooks_match_live_jax(setups):
    """Dropout and transient failures draw from the scenario stream in the
    JAX order: the same devices fail at the same times."""
    (jdata, jparts, jw0), (data, parts, w0) = setups
    kw = dict(TINY_RUN_KW, p_s=0.25, p_q=8)
    h_jax = jax_run_method("teasq", jdata, jparts, jw0, scenario=JScenarioConfig(
        dropout_prob=0.1, failure_prob=0.2), **kw)
    h_port = run_method("teasq", data, parts, w0, device="cpu",
                        scenario=ScenarioConfig(dropout_prob=0.1,
                                                failure_prob=0.2), **kw)
    _assert_parity(h_jax, h_port)


def test_profile_compression_matches_live_jax(setups):
    """Alg. 5 on the same model: the codec round trips are host numpy from
    the same rng, so only the evaluation's float arithmetic differs; the
    search takes the same path and picks the same point."""
    (jdata, _, jw0), (data, _, w0) = setups
    si, qi, trace = profile_compression(w0, data, theta=0.02, seed=1)
    jsi, jqi, jtrace = jax_profile_compression(jw0, jdata, theta=0.02,
                                               seed=1)
    assert (si, qi) == (jsi, jqi)
    assert [t[:2] for t in trace] == [t[:2] for t in jtrace]
    for t, jt in zip(trace, jtrace):
        assert abs(t[2] - jt[2]) <= ACC_TOL


def test_device_registry_draws_exact():
    jr, tr = np.random.RandomState(8), np.random.RandomState(8)
    jreg = JDeviceRegistry(JSimConfig(n_devices=30), jr)
    treg = tengine.DeviceRegistry(SimConfig(n_devices=30), tr)
    for name in ("down_rates", "up_rates", "a_k", "phi_k"):
        np.testing.assert_array_equal(getattr(treg, name),
                                      getattr(jreg, name))
    for k in (0, 7, 29):
        assert treg.round_latency(k, 8e5, 4e5, 15, tr) == \
            jreg.round_latency(k, 8e5, 4e5, 15, jr)


def test_engine_resumes_and_stops_at_max_rounds(setups):
    _, (data, parts, w0) = setups
    cfg = SimConfig(method="teasq", n_devices=8, seed=3, epochs=1,
                    p_s=0.25, p_q=8)
    whole = make_sim(data, parts, w0, cfg, device="cpu").run(4.0)
    sim = make_sim(data, parts, w0, cfg, device="cpu")
    sim.run(2.0)
    resumed = sim.run(4.0)
    assert [(e.time, e.round, e.bytes_up) for e in resumed] == \
        [(e.time, e.round, e.bytes_up) for e in whole]
    capped = make_sim(data, parts, w0, cfg, device="cpu")
    hist = capped.run(100.0, max_rounds=3)
    assert capped.server.t == 3 and hist[-1].round == 3


def test_unported_settings_raise(setups):
    _, (data, parts, w0) = setups
    # wave handlers need the batched scheduler, as in the JAX package
    with pytest.raises(ValueError, match="batched"):
        make_sim(data, parts, w0, SimConfig(n_devices=8,
                                            handler_mode="wave"),
                 device="cpu")
    # an unknown server raises; the sharded one builds (a world of 1 here)
    with pytest.raises(ValueError, match="unknown server"):
        tengine.FLEngine(data, parts, w0, SimConfig(n_devices=8,
                                                    server="bogus"),
                         device="cpu")
    eng = tengine.FLEngine(data, parts, w0, SimConfig(n_devices=8,
                                                      server="sharded"),
                           device="cpu")
    assert eng.server.n_shards == 1 and eng.server.mesh is None
    # the LM tasks are ported: an engine on transformer_lm builds
    from repro_torch.fl.protocols import make_setup
    lm = make_setup(8, True, 0, 64, 32, "transformer_lm", device="cpu")
    eng = tengine.FLEngine(*lm, SimConfig(n_devices=8,
                                          task="transformer_lm"),
                           device="cpu")
    assert eng.task.model_cfg.name == "fl-transformer-lm"
    assert eng._names[0] == ("embed",) and ("layers", "attn", "wq") in \
        eng._names


def test_entry_points_need_a_device_without_cuda(setups, monkeypatch):
    """With no card and no device named, the entry points raise; they never
    fall back to the CPU on their own."""
    _, (data, parts, w0) = setups
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_method("teasq", data, parts, w0, **TINY_RUN_KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_sim(data, parts, w0, SimConfig(n_devices=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_setup(**TINY_SETUP)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port imports in a fresh interpreter without
    loading ``jax``, ``repro`` or ``msgpack`` (the checkpoints carry a
    msgpack codec of their own and need no msgpack package)."""
    code = (
        "import pkgutil, sys, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    __import__(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro',\n"
        "                                    'msgpack'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 51, names\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]


def test_chip_smoke_phases_rehearse_on_cpu():
    """chip_smoke.py's comparison phases run on CPU tensors at a small
    fleet and Mamba2-370M's smoke config (kernel and plain version are then
    both the plain version, and the serving path launches no kernel): the
    script's own checks, kept from rotting between card runs."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    smoke = chip_smoke.Smoke("cpu", n_devices=10, n_train=1000, n_test=500,
                             ssm_smoke=True)
    for phase in (smoke.kernel_a, smoke.kernel_b, smoke.card_vs_cpu,
                  smoke.kernel_c, smoke.serve_ssm, smoke.ssm_card_vs_cpu):
        smoke.phase(phase.__name__, phase)
    assert smoke.failures == []
    assert smoke.kernels["fused_pack"]["max_abs_err"] == 0.0
    # 18 tensors at blocks of 1,024 to 400,003, and the CNN's 8 leaves in
    # one call
    assert smoke.kernels["topk_quant"]["checked_cases"] == 19
    # 9 grid cases + 4 ragged or odd-head cells + the full-width cell, for
    # f32 and bf16 b and c
    assert smoke.kernels["ssd_scan"]["checked_cases"] == 28
    assert smoke.kernels["ssd_scan"]["launches"] == 0
    assert smoke.serving["flips"] == 0


@pytest.mark.cuda
def test_card_and_cpu_histories_agree(setups):
    """The same run on the card and on the CPU: equal timelines."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python3 chip_smoke.py runs this "
                    "comparison on the card)")
    _, (data, parts, w0) = setups
    kw = dict(TINY_RUN_KW, p_s=0.25, p_q=8, codec="packed")
    h_cpu = run_method("teasq", data, parts, w0, device="cpu", **kw)
    h_gpu = run_method("teasq", data, parts,
                       {k: v.cuda() for k, v in w0.items()}, device="cuda",
                       **kw)
    _assert_parity(h_cpu, h_gpu)
