"""Wave mode's resume contract in the port, on the CPU: the JAX package's
two layers (``tests/test_wave_handlers.py``), on the same zero-noise
fleets (``ComputeConfig(phi=inf)``: every latency draw is exactly 0.0).

1. The checkpoint proper, bit-exact: the engine restored from the blob
   saved at the cut replays the same engine continued past the save
   without serializing: histories, meters, stats, pending events and
   weights to the last bit.
2. The cut against the uninterrupted run, relaxed: a budget cut splits
   waves, and a wave handles its whole same-kind span before the events
   spawned inside it, so processing near the cut regroups.  One job lands
   on the same round sequence, final row (but accuracy, within 0.05),
   meters, stats (but the flush counts), pending events and server state
   machine, with weights within 0.2; a multi-job fleet may also shift one
   round completion across the final budget boundary (+-1 round, 5% of
   the bytes).

Both layers compare what the JAX tests compare.  The engines run to 2.0
virtual s cut at 1.0 (the JAX test: 4.0 at 2.0, twice the CPU time); the
fleet keeps the JAX test's 3.0 cut at 1.5.
"""
import numpy as np
import pytest
import torch

from repro.fl.protocols import make_setup as jax_make_setup
from repro_torch.core.latency import ComputeConfig
from repro_torch.fl.engine import KIND_NAMES
from repro_torch.fl.fleet import FleetConfig, MultiTaskEngine
from repro_torch.fl.protocols import make_setup, make_sim
from repro_torch.fl.simulator import SimConfig

from test_torch_resume import (STATS, _assert_state_equal, _pending,
                               _resume, _rows, _weights_equal)
from torch_threads import one_torch_thread  # noqa: F401


def _wave_cfg(n, method, cohort, seed):
    return SimConfig(method=method, task="fmnist_cnn", n_devices=n,
                     c_fraction=1.0, gamma=0.25, epochs=1, batch_size=8,
                     p_s=0.25, p_q=8, seed=seed, cohort_size=cohort,
                     cohort_channel_iters=6, scheduler="batched",
                     handler_mode="wave",
                     compute=ComputeConfig(phi=float("inf")))


def _wave_setup(n, seed):
    _, _, jw0 = jax_make_setup(n_devices=n, iid=True, seed=seed,
                               n_train=40 * n, n_test=160)
    return make_setup(n_devices=n, iid=True, seed=seed, n_train=40 * n,
                      n_test=160, device="cpu",
                      init_params={k: np.asarray(v) for k, v in jw0.items()})


def _assert_resume_bit_exact(h_cont, h_res, cont, res):
    """Layer 1: the restored run against the never-serialized one."""
    assert _rows(h_cont) == _rows(h_res)
    _assert_state_equal(cont, res, STATS[:5])
    _weights_equal(cont, res)


def _assert_server_close(a, b, atol=0.2):
    for k in a.w:
        assert torch.isfinite(b.w[k]).all()
        np.testing.assert_allclose(a.w[k].numpy(), b.w[k].numpy(), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("method,cohort", [("teasq", 0), ("teasq", 3),
                                           ("fedasync", 0)])
def test_wave_engine_resume_two_layers(method, cohort, tmp_path):
    n = 8
    data, parts, w0 = _wave_setup(n, 0)
    cfg = _wave_cfg(n, method, cohort, 0)

    def make():
        return make_sim(data, parts, w0, cfg, device="cpu")

    full = make()
    h_full = full.run(time_budget=2.0, eval_every=1)
    a, b = _resume(make, 1.0, str(tmp_path / "wave_engine.msgpack"),
                   dict(eval_every=1))
    h_res = b.run(time_budget=2.0, eval_every=1)
    h_cont = a.run(time_budget=2.0, eval_every=1)      # never serialized
    assert h_full[-1].round >= 10
    _assert_resume_bit_exact(h_cont, h_res, a, b)
    assert _pending(a, KIND_NAMES) == _pending(b, KIND_NAMES)
    # layer 2: against the uninterrupted run
    assert [e.round for e in h_full] == [e.round for e in h_res]
    fa, fb = h_full[-1], h_res[-1]
    assert _rows([fa], accuracy=False) == _rows([fb], accuracy=False)
    assert abs(fa.accuracy - fb.accuracy) <= 0.05
    _assert_state_equal(full, b, STATS[:5])
    assert _pending(full, KIND_NAMES) == _pending(b, KIND_NAMES)
    _assert_server_close(full.server, b.server)


def test_wave_fleet_resume_two_layers(tmp_path):
    n = 12
    data, parts, w0 = _wave_setup(n, 1)

    def make():
        specs = [_wave_cfg(n, "teasq", 0, 1), _wave_cfg(n, "fedasync", 3, 1)]
        return MultiTaskEngine(
            [data, data], [parts, parts], [w0, w0],
            FleetConfig(tasks=specs, n_devices=n, seed=1,
                        scheduler="batched", handler_mode="wave",
                        compute=ComputeConfig(phi=float("inf"))),
            device="cpu")

    # the JAX package's budgets: its own fleet, cut at 1.0 of 2.0, shifts
    # two rounds of the second job, outside the +-1 of layer 2
    full = make()
    h_full = full.run(time_budget=3.0, eval_every=1)
    a, b = _resume(make, 1.5, str(tmp_path / "wave_fleet.msgpack"),
                   dict(eval_every=1))
    h_res = b.run(time_budget=3.0, eval_every=1)
    h_cont = a.run(time_budget=3.0, eval_every=1)      # never serialized
    assert any(h[-1].round >= 1 for h in h_full)
    for h_c, h_r, rt_c, rt_r in zip(h_cont, h_res, a.runtimes, b.runtimes):
        _assert_resume_bit_exact(h_c, h_r, rt_c, rt_r)
    assert _pending(a, KIND_NAMES) == _pending(b, KIND_NAMES)
    for h_f, h_r, rt_f, rt_r in zip(h_full, h_res, full.runtimes,
                                    b.runtimes):
        assert abs(len(h_f) - len(h_r)) <= 1
        assert abs(rt_f.server.t - rt_r.server.t) <= 1
        assert abs(h_f[-1].accuracy - h_r[-1].accuracy) <= 0.05
        up_f, up_r = h_f[-1].bytes_up, h_r[-1].bytes_up
        assert abs(up_f - up_r) <= 0.05 * max(up_f, up_r)
        _assert_server_close(rt_f.server, rt_r.server)
