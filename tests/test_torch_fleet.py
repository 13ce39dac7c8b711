"""The port's multi-task fleet (``repro_torch.fl.fleet``) on the CPU: its
assigners, a one-task fleet against the port's own engine, and a two-job
fleet against a live run of the JAX package's fleet.

* Assigners are host numpy: exact, and their draws equal the JAX
  package's assigners' on the same fleet surface.
* A one-task fleet replays the standalone engine's draws in the same
  order, so its history (accuracy included), byte meters, stats and
  liveness are bit-identical to the port's engine, on both schedulers.
* A two-job fleet (TEASQ on the CNN, dense fedasync on the MLP: two
  parameter structures in one fleet) against the live JAX fleet from the
  same data and weights, on the heap, the batched scheduler in serial mode
  and wave mode: every time, round and byte column, ``stats``, the tier
  meters and the pending events exact; accuracy within ``ACC_TOL``
  absolute (the models' float sums differ in their last bits).
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.fl import fleet as jfleet
from repro.fl.engine import KIND_NAMES as JKIND_NAMES
from repro.fl.simulator import SimConfig as JSimConfig
from repro_torch.core.compression import expected_pytree_wire_bytes
from repro_torch.fl.engine import KIND_NAMES
from repro_torch.fl.fleet import (ASSIGNERS, AdaptiveAssigner, FleetConfig,
                                  MultiTaskEngine, RoundRobinAssigner,
                                  WeightedAssigner, build_fleet,
                                  make_assigner)
from repro_torch.fl.protocols import make_setup, make_sim
from repro_torch.fl.simulator import ScenarioConfig, SimConfig, TierSpec

from conftest import TINY_RUN_KW, TINY_SETUP
from torch_threads import one_torch_thread  # noqa: F401

ACC_TOL = 0.025
COLUMNS = ("time", "round", "bytes_up", "bytes_down", "max_model_bytes_up",
           "max_model_bytes_down")
STATS = ("dispatches", "completions", "dropouts", "transient_failures",
         "redispatched", "flushes", "flushed_tasks")


def tiny_spec(method, n_devices, sim_config=SimConfig, **kw):
    """A per-task SimConfig with ``run_method``'s defaults, so a one-task
    fleet is config-identical to a standalone ``make_sim`` run."""
    return sim_config(method=method, n_devices=n_devices, c_fraction=0.1,
                      mu=0.01, alpha=0.6, p_s=kw.pop("p_s", 0.25),
                      p_q=kw.pop("p_q", 8), **kw)


@pytest.fixture(scope="module")
def port_setup():
    return make_setup(**TINY_SETUP, device="cpu")


# ----------------------------------------------------------------------
# assigners
# ----------------------------------------------------------------------
def _dummy_fleet(cfg_cls=FleetConfig, n_tasks=3, n_devices=12, shares=None,
                 accs=(0.2, 0.5, 0.9), active=(0, 0, 0), max_parallel=2):
    """The fleet surface an Assigner touches: cfg and per-task
    (server.active, server.cfg.max_parallel, history[-1].accuracy)."""
    cfg = cfg_cls(tasks=[None] * n_tasks, n_devices=n_devices,
                  shares=shares)
    rts = [SimpleNamespace(
        server=SimpleNamespace(
            active=a, cfg=SimpleNamespace(max_parallel=max_parallel)),
        history=[SimpleNamespace(accuracy=acc)])
        for a, acc in zip(active, accs)]
    return SimpleNamespace(cfg=cfg, runtimes=rts)


def test_assigner_registry_and_validation():
    assert set(ASSIGNERS) == {"round_robin", "weighted", "adaptive"}
    with pytest.raises(ValueError, match="unknown assigner"):
        make_assigner("fifo", _dummy_fleet())


def test_round_robin_cycles_live_tasks():
    a = RoundRobinAssigner(_dummy_fleet())
    assert [a.assign(k, [0, 1, 2]) for k in range(5)] == [0, 1, 2, 0, 1]
    assert [a.assign(k, [0, 2]) for k in range(3)] == [2, 0, 2]


def test_weighted_assigner_partitions_by_shares():
    a = WeightedAssigner(_dummy_fleet(shares=[0.5, 0.25, 0.25]))
    owner = [a.assign(k, [0, 1, 2]) for k in range(12)]
    assert owner == [0] * 6 + [1] * 3 + [2] * 3
    assert [a.assign(0, [1, 2]) for _ in range(3)] == [1, 2, 1]
    b = WeightedAssigner(_dummy_fleet())
    counts = np.bincount([b.assign(k, [0, 1, 2]) for k in range(12)])
    assert counts.tolist() == [4, 4, 4]


def test_adaptive_assigner_prefers_slow_converging_free_tasks():
    fleet = _dummy_fleet(accs=(0.2, 0.5, 0.9), active=(2, 0, 0))
    a = AdaptiveAssigner(fleet)
    picks = np.bincount([a.assign(k, [0, 1, 2]) for k in range(400)],
                        minlength=3)
    assert picks[0] == 0
    assert picks[1] > 3 * picks[2] > 0
    sat = AdaptiveAssigner(_dummy_fleet(active=(2, 2, 2)))
    assert set(sat.assign(k, [0, 1, 2]) for k in range(50)) == {0, 1, 2}
    state0 = a.rng.get_state()[1].copy()
    assert a.assign(0, [2]) == 2
    assert np.array_equal(a.rng.get_state()[1], state0)


@pytest.mark.parametrize("name", sorted(ASSIGNERS))
def test_assigner_state_roundtrip_and_jax_draws(name):
    """A restored assigner continues as the original would, and every
    assigner makes the JAX package's choices on the same fleet surface
    (the adaptive one draws from the same seeded stream)."""
    kw = dict(shares=[0.5, 0.25, 0.25], accs=(0.2, 0.5, 0.9),
              active=(2, 0, 1))
    fleet = _dummy_fleet(**kw)
    a = make_assigner(name, fleet)
    for k in range(7):
        a.assign(k, [0, 1, 2])
    b = make_assigner(name, fleet)
    b.load_state(a.state_dict())
    assert [a.assign(k % 12, [0, 1, 2]) for k in range(20)] == \
        [b.assign(k % 12, [0, 1, 2]) for k in range(20)]
    j = jfleet.make_assigner(name, _dummy_fleet(jfleet.FleetConfig, **kw))
    t = make_assigner(name, fleet)
    lives = ([0, 1, 2], [0, 2], [1, 2], [1], [0, 1, 2])
    assert [t.assign(k % 12, lives[k % 5]) for k in range(60)] == \
        [j.assign(k % 12, lives[k % 5]) for k in range(60)]


def test_fleet_config_validation(port_setup):
    data, parts, w0 = port_setup
    n = len(parts)
    with pytest.raises(ValueError, match="tasks is empty"):
        MultiTaskEngine([], [], [], FleetConfig(tasks=[], n_devices=n),
                        device="cpu")
    with pytest.raises(ValueError, match="unknown scheduler"):
        MultiTaskEngine([data], [parts], [w0], FleetConfig(
            tasks=[tiny_spec("teasq", n)], n_devices=n, scheduler="fifo"),
            device="cpu")
    with pytest.raises(ValueError, match="not event-driven"):
        MultiTaskEngine([data], [parts], [w0], FleetConfig(
            tasks=[tiny_spec("fedavg", n)], n_devices=n), device="cpu")
    spec = FleetConfig(tasks=[tiny_spec("teasq", 4, seed=9)], n_devices=n,
                       seed=3, scheduler="batched", handler_mode="wave")
    r = spec.resolve(0)
    assert (r.n_devices, r.seed, r.scheduler, r.handler_mode) == \
        (n, 3, "batched", "wave")


def test_fleet_follows_the_device_rule(port_setup, monkeypatch):
    """With no card and no device named, the fleet raises; it never falls
    back to the CPU on its own."""
    data, parts, w0 = port_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = FleetConfig(tasks=[tiny_spec("teasq", len(parts))],
                      n_devices=len(parts))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiTaskEngine([data], [parts], [w0], cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_fleet(cfg, n_train=160, n_test=80)


# ----------------------------------------------------------------------
# a one-task fleet is the engine, bit for bit
# ----------------------------------------------------------------------
SCENARIO = ScenarioConfig(
    dropout_prob=0.2, failure_prob=0.3, retry_backoff=0.1,
    tiers=[TierSpec(0.5, compute_scale=1.0, bandwidth_scale=1.0,
                    name="fast"),
           TierSpec(0.5, compute_scale=2.0, bandwidth_scale=0.25,
                    name="slow")])


def _assert_engine_state_equal(a, b):
    for name in ("bytes_up", "bytes_down", "max_up", "max_down", "tier_up",
                 "tier_down"):
        assert getattr(a.channel, name) == getattr(b.channel, name), name
    for name in STATS:
        assert getattr(a.stats, name) == getattr(b.stats, name), name
    np.testing.assert_array_equal(a.stats.completed_per_device,
                                  b.stats.completed_per_device)
    np.testing.assert_array_equal(a.devices.alive, b.devices.alive)


@pytest.mark.parametrize("scheduler", ["heap", "batched"])
@pytest.mark.parametrize("method,kw", [
    ("teasq", {}),
    ("fedasync", {}),
    ("teasq", dict(cohort_size=4, codec="packed")),
    ("teasq", dict(scenario=SCENARIO)),
], ids=["teasq", "fedasync", "teasq_cohort", "teasq_scenario"])
def test_single_task_fleet_matches_engine(method, kw, scheduler, port_setup):
    """A one-task fleet replays the standalone engine's RNG draws in the
    same order: history (accuracy included), meters, stats, liveness and
    weights bit-identical on both schedulers."""
    data, parts, w0 = port_setup
    spec = tiny_spec(method, len(parts), scheduler=scheduler,
                     epochs=TINY_RUN_KW["epochs"], seed=TINY_RUN_KW["seed"],
                     **kw)
    eng = make_sim(data, parts, w0, spec, device="cpu")
    h_eng = eng.run(time_budget=TINY_RUN_KW["time_budget"])
    fleet = MultiTaskEngine([data], [parts], [w0], FleetConfig(
        tasks=[spec], n_devices=len(parts), seed=spec.seed,
        scheduler=scheduler, scenario=spec.scenario), device="cpu")
    h_fleet = fleet.run(time_budget=TINY_RUN_KW["time_budget"])[0]
    assert [dataclasses.astuple(e) for e in h_eng] == \
        [dataclasses.astuple(e) for e in h_fleet]
    rt = fleet.runtimes[0]
    _assert_engine_state_equal(eng, rt)
    for k in eng.server.w:
        assert torch.equal(eng.server.w[k], rt.server.w[k]), k
    if kw.get("scenario") is not None:
        assert rt.stats.dropouts + rt.stats.transient_failures > 0


# ----------------------------------------------------------------------
# two jobs, two model families: the port against the live JAX fleet
# ----------------------------------------------------------------------
def _two_job_specs(sim_config, mode):
    n = TINY_SETUP["n_devices"]
    cnn = dict(epochs=1, seed=3)
    if mode == "wave":
        cnn.update(cohort_size=4, codec="packed")
    return [tiny_spec("teasq", n, sim_config, **cnn),
            tiny_spec("fedasync", n, sim_config, task="fmnist_mlp",
                      epochs=1, seed=3, p_s=1.0, p_q=32)]


def _pending(fleet, kind_names):
    if fleet._events is not None:
        return sorted((t, kind, k, j) for t, _, kind, k, j, _, _
                      in fleet._events)
    tab = fleet.devices.events
    return sorted((float(tab.time[k]), kind_names[tab.kind[k]], int(k),
                   int(tab.task[k]))
                  for k in np.flatnonzero(np.isfinite(tab.time)).tolist())


def run_two_job_fleets(scheduler, mode, assigner="adaptive",
                       time_budget=4.0):
    """(JAX fleet, its histories), (port fleet, its histories): the same
    two-job fleet from the same data and the JAX package's weights."""
    n = TINY_SETUP["n_devices"]
    common = dict(n_devices=n, seed=3, scheduler=scheduler,
                  handler_mode=mode, assigner=assigner)
    jf = jfleet.build_fleet(jfleet.FleetConfig(
        tasks=_two_job_specs(JSimConfig, mode), **common),
        n_train=TINY_SETUP["n_train"], n_test=TINY_SETUP["n_test"])
    w0s = [{k: np.asarray(v) for k, v in rt.server.w.items()}
           for rt in jf.runtimes]
    tf = build_fleet(FleetConfig(tasks=_two_job_specs(SimConfig, mode),
                                 **common),
                     n_train=TINY_SETUP["n_train"],
                     n_test=TINY_SETUP["n_test"], device="cpu",
                     init_params=w0s)
    return (jf, jf.run(time_budget=time_budget)), \
        (tf, tf.run(time_budget=time_budget))


def assert_fleets_match(jax_run, port_run, acc_tol=ACC_TOL):
    (jf, hj), (tf, ht) = jax_run, port_run
    assert len(hj) == len(ht) == len(tf.runtimes)
    for j, (a_h, b_h) in enumerate(zip(hj, ht)):
        assert len(a_h) == len(b_h) > 2, j
        for a, b in zip(a_h, b_h):
            for c in COLUMNS:
                assert getattr(a, c) == getattr(b, c), (j, c)
            assert abs(a.accuracy - b.accuracy) <= acc_tol, j
    for j, (jr, tr) in enumerate(zip(jf.runtimes, tf.runtimes)):
        _assert_engine_state_equal(jr, tr)
        assert (jr.server.t, jr.server.active, len(jr.server.cache)) == \
            (tr.server.t, tr.server.active, len(tr.server.cache)), j
    assert _pending(jf, JKIND_NAMES) == _pending(tf, KIND_NAMES)
    assert jf._now == tf._now and jf._seq == tf._seq
    assert [len(w) for w in jf.waiting] == [len(w) for w in tf.waiting]


@pytest.mark.parametrize("scheduler,mode", [
    ("heap", "serial"), ("batched", "serial"), ("batched", "wave")])
def test_two_job_fleet_matches_live_jax(scheduler, mode):
    jax_run, port_run = run_two_job_fleets(scheduler, mode)
    assert_fleets_match(jax_run, port_run)
    # both jobs really shared the fleet, on two parameter structures
    tf = port_run[0]
    assert all(rt.stats.dispatches > 0 for rt in tf.runtimes)
    assert all(rt.devices is tf.devices for rt in tf.runtimes)
    assert sorted(tf.runtimes[1].server.w) == ["b1", "b2", "w1", "w2"]
    if mode == "wave":
        assert tf.runtimes[0].stats.flushes > 0


def test_wave_fleet_runs_the_threshold_channel(monkeypatch):
    """In wave mode the cohort job's flushes go through the threshold
    channel (kernel B's channel form on the card; its plain version
    here), four applications a flush group with local steps, inside
    ``MultiTaskEngine.run``; the dense job never calls it."""
    from repro_torch.fl import engine as tengine
    calls = []
    channel = tengine._channel

    def counted(tree, *a, **k):
        calls.append(next(iter(tree.values())).shape[0])
        return channel(tree, *a, **k)

    monkeypatch.setattr(tengine, "_channel", counted)
    _, (tf, _) = run_two_job_fleets("batched", "wave", time_budget=2.0)
    flushes = tf.runtimes[0].stats.flushes
    assert flushes > 0 and tf.runtimes[1].stats.flushes == 0
    assert len(calls) == 2 * flushes


def test_per_task_channel_meters_are_exact(port_setup):
    """Each job's own ChannelMeter prices its traffic at its own codec
    point: a compressed TEASQ job and a dense-f32 fedasync job sharing one
    fleet keep exact, independent byte totals."""
    data, parts, w0 = port_setup
    n = len(parts)
    cfg = FleetConfig(
        tasks=[tiny_spec("teasq", n, epochs=1, seed=3),
               tiny_spec("fedasync", n, epochs=1, seed=3, p_s=1.0, p_q=32)],
        n_devices=n, seed=3, scheduler="batched", assigner="round_robin")
    fleet = MultiTaskEngine([data, data], [parts, parts], [w0, w0], cfg,
                            device="cpu")
    fleet.run(time_budget=2.0)
    per = [expected_pytree_wire_bytes(w0, 0.25, 8),
           expected_pytree_wire_bytes(w0, 1.0, 32)]
    assert per[0] < per[1]
    for rt, p in zip(fleet.runtimes, per):
        assert rt.stats.dispatches > 0
        assert rt.channel.bytes_down == rt.stats.dispatches * p
        assert rt.channel.bytes_up == rt.stats.dispatches * p
        assert rt.channel.max_down == p
        assert rt.channel.max_up == p


@pytest.mark.cuda
def test_wave_fleet_on_card_matches_cpu():
    """The two-job wave fleet on the card and on the CPU from the same
    weights: equal time, round and byte columns and stats."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python3 chip_smoke.py phase 22 "
                    "runs this comparison on the card)")
    n = TINY_SETUP["n_devices"]
    cfg = FleetConfig(tasks=_two_job_specs(SimConfig, "wave"), n_devices=n,
                      seed=3, scheduler="batched", handler_mode="wave",
                      assigner="adaptive")
    w0s = [{k: v.numpy() for k, v in w.items()} for w in (
        make_setup(**TINY_SETUP, device="cpu")[2],
        make_setup(**dict(TINY_SETUP, task="fmnist_mlp"), device="cpu")[2])]
    runs = [build_fleet(cfg, n_train=TINY_SETUP["n_train"],
                        n_test=TINY_SETUP["n_test"], device=dev,
                        init_params=w0s) for dev in ("cuda", "cpu")]
    hs = [f.run(time_budget=4.0) for f in runs]
    for a_h, b_h in zip(*hs):
        assert [tuple(getattr(e, c) for c in COLUMNS) for e in a_h] == \
            [tuple(getattr(e, c) for c in COLUMNS) for e in b_h]
    for a, b in zip(*(f.runtimes for f in runs)):
        _assert_engine_state_equal(a, b)
