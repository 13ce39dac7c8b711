"""The other five protocols (fedasync, port, asofed: immediate mixing;
fedavg, moon: the synchronous loop) against a live run of the JAX
package's, on the CPU, from the same data, partitions and weights.

The time, round and byte columns of the histories must be equal (every
random draw is numpy in both packages, in the same order, MOON's minibatch
permutations included); accuracy within ``ACC_TOL`` absolute per entry.
One MOON step is held to 1e-5: its loss sums a cross entropy and a
contrastive term over three forwards whose sums XLA and PyTorch order
differently.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import protocols as jprotocols
from repro.fl.protocols import make_setup as jax_make_setup
from repro.fl.protocols import run_method as jax_run_method
from repro.fl.simulator import SimConfig as JSimConfig
from repro.fl.simulator import moon_local_train as jax_moon_local_train
from repro.models import cnn as jcnn
from repro_torch.fl import protocols as tprotocols
from repro_torch.fl.protocols import make_setup, run_method
from repro_torch.fl.simulator import SimConfig, moon_local_train
from repro_torch.models import cnn as tcnn
from repro_torch.utils.tree import from_numpy

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


@pytest.mark.parametrize("method,cohort_size", [
    ("fedasync", 0), ("port", 0), ("asofed", 0), ("fedavg", 0), ("moon", 0),
    ("fedavg", 4)])
def test_protocol_matches_live_jax(setups, method, cohort_size):
    """The time, round and byte columns equal, accuracy within ACC_TOL;
    fedavg on the cohort trainer falls back to the serial one."""
    (jdata, jparts, jw0), (data, parts, w0) = setups
    kw = dict(TINY_RUN_KW, cohort_size=cohort_size)
    h_jax = jax_run_method(method, jdata, jparts, jw0, **kw)
    h_port = run_method(method, data, parts, w0, device="cpu", **kw)
    assert len(h_jax) == len(h_port) > 2
    for a, b in zip(h_jax, h_port):
        for c in COLUMNS:
            assert getattr(a, c) == getattr(b, c), c
        assert abs(a.accuracy - b.accuracy) <= ACC_TOL


def test_mixing_weights_and_fedavg_weights_match_jax():
    """The staleness-decayed mixing weights of the three immediate-mixing
    protocols (to f32 rounding: the JAX package takes its power in XLA),
    and FedAvg's sample-count merge."""
    jcfg, tcfg = JSimConfig(alpha=0.6, a=0.5), SimConfig(alpha=0.6, a=0.5)
    for name in ("fedasync", "port", "asofed"):
        js = jprotocols.make_strategy(name, jcfg)
        ts = tprotocols.make_strategy(name, tcfg)
        for stale in range(8):
            assert ts.mixing_weight(stale) == pytest.approx(
                js.mixing_weight(stale), rel=1e-7)
    rng = np.random.RandomState(3)
    ups = [{"a": rng.randn(4, 3).astype(np.float32)} for _ in range(3)]
    want = jprotocols.make_strategy("fedavg", jcfg).aggregate(
        None, [{"a": jnp.asarray(u["a"])} for u in ups], [80, 40, 120])
    got = tprotocols.make_strategy("fedavg", tcfg).aggregate(
        None, [from_numpy(u, "cpu") for u in ups], [80, 40, 120])
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                               atol=1e-6, rtol=1e-6)


def test_moon_local_step_matches_jax():
    """One MOON step (one minibatch of 40, from the same global and
    previous models) within 1e-5, and the same RNG draws."""
    w = {k: np.asarray(v) for k, v in
         jcnn.init_cnn(jax.random.PRNGKey(4)).items()}
    rng = np.random.RandomState(0)
    prev = {k: (v + rng.randn(*v.shape) * 0.02).astype(np.float32)
            for k, v in w.items()}
    x = rng.randn(40, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 10, 40).astype(np.int32)
    jr, tr = np.random.RandomState(9), np.random.RandomState(9)
    want = jax_moon_local_train(
        {k: jnp.asarray(v) for k, v in w.items()},
        {k: jnp.asarray(v) for k, v in prev.items()}, x, y, epochs=1,
        batch_size=40, lr=0.08, rng=jr, forward_fn=jcnn.cnn_forward,
        features_fn=jcnn.cnn_features)
    got = moon_local_train(
        from_numpy(w, "cpu"), from_numpy(prev, "cpu"), torch.from_numpy(x),
        torch.from_numpy(y), epochs=1, batch_size=40, lr=0.08, rng=tr,
        forward_fn=tcnn.cnn_forward, features_fn=tcnn.cnn_features)
    for k in w:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=1e-5)
    assert not np.array_equal(got["fc1"].numpy(), w["fc1"])
    assert jr.randint(1 << 30) == tr.randint(1 << 30)


def test_chip_smoke_cohort_phases_rehearse_on_cpu():
    """chip_smoke.py's new comparison phases on CPU tensors at a small
    fleet: the channel form against its plain version (both the plain
    version here, so no launch) and the cohort path card against CPU (here
    CPU against CPU).  The protocols phase composes ``compare_with_cpu``
    and ``make_sim(...).run``, which this and test_protocol_matches_live_jax
    already drive."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    smoke = chip_smoke.Smoke("cpu", n_devices=10, n_train=1000, n_test=500,
                             ssm_smoke=True, channel_cs=(1,))
    for phase in (smoke.channel_b, smoke.cohort_card_vs_cpu):
        smoke.phase(phase.__name__, phase)
    assert smoke.failures == []
    # Set_s x Set_q x 2 iters at one cohort size, 4 bf16 points, 5 ragged
    assert smoke.kernels["topk_quant"]["channel_checked_cases"] == 57
    assert smoke.kernels["topk_quant"]["channel_max_abs_err"] == 0.0
