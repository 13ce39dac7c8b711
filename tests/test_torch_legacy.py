"""The port's legacy simulator (``FLSimulator``, ``backend="legacy"``)
against the JAX package's, on the CPU.

``run_method(method, ..., backend="legacy")`` from the same data,
partitions and weights (the JAX package's, carried across) at
``TINY_SETUP``: the time, round and byte columns equal (every random draw
is numpy in both packages, in the legacy loop's order), accuracy within
``ACC_TOL`` absolute per entry.  The JAX package holds its legacy
simulator equal to its engine (``tests/test_engine_parity.py``); the
port's two are held equal here in the same settings.  With
``codec="threshold"`` the legacy loop runs kernel B's channel form's plain
version on the CPU.
"""
import numpy as np
import pytest

from repro.fl.protocols import make_setup as jax_make_setup
from repro.fl.protocols import run_method as jax_run_method
from repro_torch.fl.protocols import make_setup, make_sim, run_method
from repro_torch.fl.simulator import FLSimulator, SimConfig

from conftest import TINY_RUN_KW, TINY_SETUP
from torch_threads import one_torch_thread  # noqa: F401

ACC_TOL = 0.025
COLUMNS = ("time", "round", "bytes_up", "bytes_down", "max_model_bytes_up",
           "max_model_bytes_down")


@pytest.fixture(scope="module")
def setups():
    """(JAX setup, port setup), the port's w0 carried over from JAX's."""
    jdata, jparts, jw0 = jax_make_setup(**TINY_SETUP)
    w_np = {k: np.asarray(v) for k, v in jw0.items()}
    port = make_setup(**TINY_SETUP, device="cpu", init_params=w_np)
    return (jdata, jparts, jw0), port


def _same_columns(h_a, h_b, acc_tol):
    assert len(h_a) == len(h_b) > 2
    for a, b in zip(h_a, h_b):
        for c in COLUMNS:
            assert getattr(a, c) == getattr(b, c), c
        assert abs(a.accuracy - b.accuracy) <= acc_tol


@pytest.mark.parametrize("method,codec", [
    ("teasq", "dense"), ("teasq", "packed"), ("teasq", "threshold"),
    ("fedasync", "dense"), ("fedavg", "dense"), ("moon", "dense")])
def test_legacy_matches_live_jax_legacy(setups, method, codec):
    (jdata, jparts, jw0), (data, parts, w0) = setups
    kw = dict(TINY_RUN_KW, codec=codec)
    h_jax = jax_run_method(method, jdata, jparts, jw0, backend="legacy",
                           **kw)
    h_port = run_method(method, data, parts, w0, backend="legacy",
                        device="cpu", **kw)
    _same_columns(h_jax, h_port, ACC_TOL)


@pytest.mark.parametrize("method,kw", [
    pytest.param("teasq", {}, id="teasq"),
    pytest.param("fedasync", {}, id="fedasync"),
    pytest.param("port", {}, id="port"),
    pytest.param("fedavg", {}, id="fedavg"),
    pytest.param("moon", {"devices_per_round": 3}, id="moon"),
    pytest.param("tea", {}, id="tea"),
    pytest.param("teasq", {"codec": "packed"}, id="teasq-packed")])
def test_legacy_equals_the_engine(setups, method, kw):
    """The port's legacy and engine backends: the same draws in the same
    order, the same ops on the same device, so equal histories (accuracy
    included) wherever the JAX package holds its two equal
    (``tests/test_engine_parity.py``: the TEA family, fedasync, fedavg,
    moon and the packed codec)."""
    _, (data, parts, w0) = setups
    h_legacy = run_method(method, data, parts, w0, backend="legacy",
                          device="cpu", **TINY_RUN_KW, **kw)
    h_engine = run_method(method, data, parts, w0, backend="engine",
                          device="cpu", **TINY_RUN_KW, **kw)
    _same_columns(h_legacy, h_engine, 0.0)


def test_make_sim_picks_the_backend(setups):
    _, (data, parts, w0) = setups
    cfg = SimConfig(n_devices=len(parts), seed=3, epochs=1)
    sim = make_sim(data, parts, w0, cfg, backend="legacy", device="cpu")
    assert isinstance(sim, FLSimulator)
    assert sim.run(time_budget=0.5)[0].round == 0
    with pytest.raises(ValueError, match="unknown backend"):
        make_sim(data, parts, w0, cfg, backend="monolith", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        run_method("teasq", data, parts, w0, backend="monolith",
                   device="cpu", **TINY_RUN_KW)
