"""Checkpoint and resume of the port's engine and fleet, on the CPU.

* Save at t, restore into a fresh engine, run to T: bit-identical to an
  uninterrupted run to T (history with accuracy, meters, stats, weights),
  on the heap and the batched scheduler, with the serial and the cohort
  trainer; the fleet likewise.
* Wave mode keeps the JAX package's two-layer contract instead
  (tests/test_torch_wave_resume.py).
* Across frameworks: a JAX blob saved at t, loaded into the port and run
  on to T, gives the time, round and byte columns of the JAX run continued
  to T, accuracy within ``ACC_TOL``; a port blob loaded into the JAX
  engine likewise.  At the cut, the port's state and the JAX package's
  agree field for field: exact but for the model weights (f32 sums in
  other orders, ``WEIGHT_TOL``) and the logged accuracy.
"""
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.fl import fleet as jfleet
from repro.fl.engine import KIND_NAMES as JKIND_NAMES
from repro.fl.protocols import make_setup as jax_make_setup
from repro.fl.protocols import make_sim as jax_make_sim
from repro.fl.simulator import SimConfig as JSimConfig
from repro_torch.checkpoint.io import load_blob, save_blob
from repro_torch.fl.engine import KIND_NAMES
from repro_torch.fl.fleet import FleetConfig, MultiTaskEngine, build_fleet
from repro_torch.fl.protocols import make_setup, make_sim
from repro_torch.fl.simulator import SimConfig

from conftest import TINY_SETUP
from torch_threads import one_torch_thread  # noqa: F401

ACC_TOL = 0.025
WEIGHT_TOL = 1e-3
COLUMNS = ("time", "round", "bytes_up", "bytes_down", "max_model_bytes_up",
           "max_model_bytes_down")
STATS = ("dispatches", "completions", "dropouts", "transient_failures",
         "redispatched", "flushes", "flushed_tasks")


@pytest.fixture(scope="module")
def setups():
    """(JAX setup, port setup), the port's w0 carried over from JAX's."""
    jdata, jparts, jw0 = jax_make_setup(**TINY_SETUP)
    w_np = {k: np.asarray(v) for k, v in jw0.items()}
    port = make_setup(**TINY_SETUP, device="cpu", init_params=w_np)
    return (jdata, jparts, jw0), port


def spec(sim_config=SimConfig, **kw):
    base = dict(method="teasq", n_devices=TINY_SETUP["n_devices"],
                c_fraction=0.1, mu=0.01, alpha=0.6, p_s=0.25, p_q=8,
                epochs=1, seed=3)
    base.update(kw)
    return sim_config(**base)


def _rows(h, accuracy=True):
    return [tuple(getattr(e, c) for c in COLUMNS)
            + ((e.accuracy,) if accuracy else ()) for e in h]


def _assert_state_equal(a, b, stats=STATS):
    """Meters, ``stats``, liveness and the server state machine; the wave
    contract compares ``stats`` without the flush counts (``STATS[:5]``,
    the JAX package's ``assert_engine_state_equal``)."""
    for name in ("bytes_up", "bytes_down", "max_up", "max_down", "tier_up",
                 "tier_down"):
        assert getattr(a.channel, name) == getattr(b.channel, name), name
    for name in stats:
        assert getattr(a.stats, name) == getattr(b.stats, name), name
    np.testing.assert_array_equal(a.stats.completed_per_device,
                                  b.stats.completed_per_device)
    np.testing.assert_array_equal(a.devices.alive, b.devices.alive)
    assert (a.server.t, a.server.active, len(a.server.cache)) == \
        (b.server.t, b.server.active, len(b.server.cache))


def _weights_equal(a, b):
    for k in a.server.w:
        assert torch.equal(a.server.w[k], b.server.w[k]), k


def _pending(eng, kind_names):
    """Multiset of pending (time, kind, device) events, of an engine or a
    fleet, of either package."""
    if eng._events is not None:
        return sorted((ev[0], ev[2], ev[3]) for ev in eng._events)
    tab = eng.devices.events
    return sorted((float(tab.time[k]), kind_names[tab.kind[k]], int(k))
                  for k in np.flatnonzero(np.isfinite(tab.time)).tolist())


def _resume(make, t, path, run_kw=None):
    """A fresh instance restored from the blob of ``make()`` run to ``t``:
    (the original, the restored one)."""
    run_kw = run_kw or {}
    a = make()
    a.run(time_budget=t, **run_kw)
    save_blob(path, a.state_dict())
    b = make()
    b.load_state(load_blob(path))
    return a, b


# ----------------------------------------------------------------------
# bit-identical resume: heap and batched serial, serial and cohort
# ----------------------------------------------------------------------
@pytest.mark.parametrize("scheduler", ["heap", "batched"])
@pytest.mark.parametrize("cohort", [0, 4], ids=["serial", "cohort"])
def test_engine_resume_is_bit_identical(setups, scheduler, cohort,
                                        tmp_path):
    """run(2) -> state_dict -> save_blob -> fresh engine -> load_state ->
    run(4) is run(4), including the deferred cohort buffer, the in-flight
    PendingTasks shared with it, and every RNG stream."""
    _, (data, parts, w0) = setups
    cfg = spec(scheduler=scheduler, cohort_size=cohort)

    def make():
        return make_sim(data, parts, w0, cfg, device="cpu")

    full = make()
    h_full = full.run(time_budget=4.0)
    _, b = _resume(make, 2.0, str(tmp_path / "engine.msgpack"))
    h_res = b.run(time_budget=4.0)
    assert _rows(h_full) == _rows(h_res)
    _assert_state_equal(full, b)
    _weights_equal(full, b)
    assert _pending(full, KIND_NAMES) == _pending(b, KIND_NAMES)


def test_cohort_resume_reinterns_the_global_model(setups, tmp_path):
    """The restored global model is a fresh object: ``_load_core`` maps it
    to the buffered version it equals, so the next submit reuses that
    version slot as the uninterrupted run does."""
    _, (data, parts, w0) = setups
    cfg = spec(scheduler="heap", cohort_size=4)
    a, b = _resume(lambda: make_sim(data, parts, w0, cfg, device="cpu"),
                   2.0, str(tmp_path / "engine.msgpack"))
    ta, tb = a.trainer, b.trainer
    assert len(ta._versions) == len(tb._versions) > 0
    assert [p.version for p in ta.pending] == [p.version for p in tb.pending]
    assert (id(a.server.w) in ta._version_ids) == \
        (id(b.server.w) in tb._version_ids)
    if id(a.server.w) in ta._version_ids:
        assert ta._version_ids[id(a.server.w)] == \
            tb._version_ids[id(b.server.w)]


@pytest.mark.parametrize("scheduler", ["heap", "batched"])
def test_fleet_resume_is_bit_identical(setups, scheduler, tmp_path):
    _, (data, parts, w0) = setups
    n = len(parts)

    def make():
        return MultiTaskEngine([data, data], [parts, parts], [w0, w0],
                               FleetConfig(
            tasks=[spec(cohort_size=4), spec(method="fedasync")],
            n_devices=n, seed=3, scheduler=scheduler, assigner="adaptive"),
            device="cpu")

    full = make()
    h_full = full.run(time_budget=3.0)
    _, b = _resume(make, 1.5, str(tmp_path / "fleet.msgpack"))
    h_res = b.run(time_budget=3.0)
    for h_f, h_r in zip(h_full, h_res):
        assert _rows(h_f) == _rows(h_r)
    for rt_f, rt_r in zip(full.runtimes, b.runtimes):
        _assert_state_equal(rt_f, rt_r)
        _weights_equal(rt_f, rt_r)


def test_checkpoint_version_guard(setups):
    _, (data, parts, w0) = setups
    eng = make_sim(data, parts, w0, spec(), device="cpu")
    state = eng.state_dict()
    state["version"] = 99
    with pytest.raises(ValueError, match="unknown engine checkpoint"):
        eng.load_state(state)
    fleet = MultiTaskEngine([data], [parts], [w0], FleetConfig(
        tasks=[spec()], n_devices=len(parts), seed=3), device="cpu")
    state = fleet.state_dict()
    state["version"] = 2
    with pytest.raises(ValueError, match="unknown fleet checkpoint"):
        fleet.load_state(state)


# ----------------------------------------------------------------------
# across frameworks
# ----------------------------------------------------------------------
def _assert_blobs_agree(jb, tb, where="state"):
    """The JAX package's state and the port's, field for field: f32
    arrays (model weights) within ``WEIGHT_TOL``, the history's accuracy
    within ``ACC_TOL``, everything else exact."""
    if isinstance(jb, dict):
        assert list(jb) == list(tb), where
        for k in jb:
            _assert_blobs_agree(jb[k], tb[k], f"{where}.{k}")
    elif isinstance(jb, list):
        assert len(jb) == len(tb), where
        history = where.endswith(".history")
        for i, (x, y) in enumerate(zip(jb, tb)):
            if history:
                assert x[:2] == y[:2] and x[3:] == y[3:], where
                assert abs(x[2] - y[2]) <= ACC_TOL, where
            else:
                _assert_blobs_agree(x, y, f"{where}[{i}]")
    elif isinstance(jb, np.ndarray):
        assert jb.dtype == tb.dtype and jb.shape == tb.shape, where
        if jb.dtype == np.float32:
            np.testing.assert_allclose(tb, jb, rtol=0, atol=WEIGHT_TOL,
                                       err_msg=where)
        else:
            np.testing.assert_array_equal(tb, jb, err_msg=where)
    else:
        assert type(jb) is type(tb) and jb == tb, (where, jb, tb)


ENGINE_CASES = {
    "heap_serial": dict(scheduler="heap"),
    "batched_cohort": dict(scheduler="batched", cohort_size=4,
                           codec="packed"),
    "wave_cohort": dict(scheduler="batched", handler_mode="wave",
                        cohort_size=4, codec="packed"),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_blobs_cross_frameworks(setups, case, tmp_path):
    """A JAX blob at t=2 continued to 4 by the port, and a port blob
    continued by the JAX engine: the time, round and byte columns of the
    other package's continuation, accuracy within ``ACC_TOL``; the two
    states at the cut agree field for field."""
    (jdata, jparts, jw0), (data, parts, w0) = setups
    kw = ENGINE_CASES[case]
    jeng = jax_make_sim(jdata, jparts, jw0, spec(JSimConfig, **kw))
    jeng.run(time_budget=2.0)
    teng = make_sim(data, parts, w0, spec(**kw), device="cpu")
    teng.run(time_budget=2.0)
    _assert_blobs_agree(jeng.state_dict(), teng.state_dict())
    jpath, tpath = str(tmp_path / "jax.msgpack"), str(tmp_path / "t.msgpack")
    jio.save_blob(jpath, jeng.state_dict())
    save_blob(tpath, teng.state_dict())
    from_jax = make_sim(data, parts, w0, spec(**kw), device="cpu")
    from_jax.load_state(load_blob(jpath))
    from_port = jax_make_sim(jdata, jparts, jw0, spec(JSimConfig, **kw))
    from_port.load_state(jio.load_blob(tpath))
    h_jax = jeng.run(time_budget=4.0)
    h_port = teng.run(time_budget=4.0)
    for want, got in ((h_jax, from_jax.run(time_budget=4.0)),
                      (h_port, from_port.run(time_budget=4.0))):
        assert _rows(want, False) == _rows(got, False)
        assert max(abs(x.accuracy - y.accuracy)
                   for x, y in zip(want, got)) <= ACC_TOL
    assert _pending(jeng, JKIND_NAMES) == _pending(from_jax, KIND_NAMES)
    assert h_jax[-1].round > 2


def test_fleet_blobs_cross_frameworks(tmp_path):
    """The two-job wave fleet (CNN TEASQ with cohorts, MLP fedasync): a
    JAX fleet blob at t continued to T by the port and a port blob
    continued by the JAX fleet give the other's time, round and byte
    columns, accuracy within ``ACC_TOL``."""
    n = TINY_SETUP["n_devices"]
    mlp = dict(method="fedasync", task="fmnist_mlp", p_s=1.0, p_q=32)
    common = dict(n_devices=n, seed=3, scheduler="batched",
                  handler_mode="wave", assigner="adaptive")
    sizes = dict(n_train=TINY_SETUP["n_train"], n_test=TINY_SETUP["n_test"])

    def jax_fleet():
        return jfleet.build_fleet(jfleet.FleetConfig(
            tasks=[spec(JSimConfig, cohort_size=4, codec="packed"),
                   spec(JSimConfig, **mlp)], **common), **sizes)

    jf = jax_fleet()
    w0s = [{k: np.asarray(v) for k, v in rt.server.w.items()}
           for rt in jf.runtimes]

    def port_fleet():
        return build_fleet(FleetConfig(
            tasks=[spec(cohort_size=4, codec="packed"), spec(**mlp)],
            **common), **sizes, device="cpu", init_params=w0s)

    tf = port_fleet()
    jf.run(time_budget=2.0)
    tf.run(time_budget=2.0)
    _assert_blobs_agree(jf.state_dict(), tf.state_dict())
    jpath, tpath = str(tmp_path / "jax.msgpack"), str(tmp_path / "t.msgpack")
    jio.save_blob(jpath, jf.state_dict())
    save_blob(tpath, tf.state_dict())
    from_jax = port_fleet()
    from_jax.load_state(load_blob(jpath))
    from_port = jax_fleet()
    from_port.load_state(jio.load_blob(tpath))
    hs_jax, hs_port = jf.run(time_budget=4.0), tf.run(time_budget=4.0)
    for wants, gots in ((hs_jax, from_jax.run(time_budget=4.0)),
                        (hs_port, from_port.run(time_budget=4.0))):
        for want, got in zip(wants, gots):
            assert _rows(want, False) == _rows(got, False)
            assert max(abs(x.accuracy - y.accuracy)
                       for x, y in zip(want, got)) <= ACC_TOL
    assert from_jax.runtimes[0].stats.flushes > 0
