"""Wave mode (``scheduler="batched"``, ``handler_mode="wave"``): the port
against a live run of the JAX package's wave mode, on the CPU, from the
same data, partitions and weights.

Both packages batch their draws per wave in the same order (grant
latencies in device-id order, scenario draws in wave order) and price
transfers from shapes, so the event timeline is the same numpy program in
both.  Exact: every history column but accuracy, ``stats`` with
``completed_per_device``, the channel's per-tier meters, and the multiset
of pending events.  Accuracy within ``ACC_TOL`` absolute per entry (the
stacked aggregation and the CNN sum in other orders).

The fleets are rows of the JAX package's own wave grid
(tests/test_wave_handlers.py ``WAVE_GRID``: zero compute noise, a gate that
never binds), a fleet with a binding gate, dropout and transient failures,
and the zero-step regime (fewer samples per device than one batch), where
every cohort flush is ``_zero_step_round``.
"""
import numpy as np
import pytest

from repro.core.latency import ComputeConfig as JComputeConfig
from repro.fl.engine import KIND_NAMES as JKIND_NAMES
from repro.fl.protocols import make_setup as jax_make_setup
from repro.fl.protocols import make_sim as jax_make_sim
from repro.fl.simulator import ScenarioConfig as JScenarioConfig
from repro.fl.simulator import SimConfig as JSimConfig
from repro.fl.simulator import TierSpec as JTierSpec
from repro_torch.core.latency import ComputeConfig
from repro_torch.fl import engine as tengine
from repro_torch.fl.engine import KIND_NAMES
from repro_torch.fl.protocols import make_setup, make_sim
from repro_torch.fl.simulator import ScenarioConfig, SimConfig, TierSpec

from torch_threads import one_torch_thread  # noqa: F401

ACC_TOL = 0.025
COLUMNS = ("time", "round", "bytes_up", "bytes_down", "max_model_bytes_up",
           "max_model_bytes_down")
STATS = ("dispatches", "completions", "dropouts", "transient_failures",
         "redispatched", "flushes", "flushed_tasks")


def _configs(tiers=None, scenario=None, phi=None, **kw):
    """The same run as a JAX and a port ``SimConfig``."""
    out = []
    for sim_cfg, scen_cfg, tier_spec, compute_cfg in (
            (JSimConfig, JScenarioConfig, JTierSpec, JComputeConfig),
            (SimConfig, ScenarioConfig, TierSpec, ComputeConfig)):
        extra = {}
        if tiers or scenario:
            extra["scenario"] = scen_cfg(
                tiers=[tier_spec(*t) for t in tiers] if tiers else None,
                **(scenario or {}))
        if phi is not None:
            extra["compute"] = compute_cfg(phi=phi)
        out.append(sim_cfg(**kw, **extra))
    return out


def _pending(eng, kind_names):
    table = eng.devices.events
    live = np.flatnonzero(np.isfinite(table.time)).tolist()
    return sorted((float(table.time[k]), kind_names[table.kind[k]], int(k))
                  for k in live)


def _run_both(setup_kw, time_budget, **cfg_kw):
    jdata, jparts, jw0 = jax_make_setup(**setup_kw)
    data, parts, w0 = make_setup(
        **setup_kw, device="cpu",
        init_params={k: np.asarray(v) for k, v in jw0.items()})
    jcfg, cfg = _configs(scheduler="batched", handler_mode="wave", **cfg_kw)
    jeng = jax_make_sim(jdata, jparts, jw0, jcfg)
    h_jax = jeng.run(time_budget=time_budget, eval_every=1)
    eng = make_sim(data, parts, w0, cfg, device="cpu")
    h_port = eng.run(time_budget=time_budget, eval_every=1)
    return (jeng, h_jax), (eng, h_port)


def _assert_wave_parity(jax_run, port_run):
    (jeng, h_jax), (eng, h_port) = jax_run, port_run
    assert len(h_jax) == len(h_port) > 2
    for a, b in zip(h_jax, h_port):
        for c in COLUMNS:
            assert getattr(a, c) == getattr(b, c), c
        assert abs(a.accuracy - b.accuracy) <= ACC_TOL
    for name in STATS:
        assert getattr(eng.stats, name) == getattr(jeng.stats, name), name
    np.testing.assert_array_equal(eng.stats.completed_per_device,
                                  jeng.stats.completed_per_device)
    for name in ("bytes_up", "bytes_down", "max_up", "max_down", "tier_up",
                 "tier_down"):
        assert getattr(eng.channel, name) == getattr(jeng.channel, name)
    assert (eng.server.t, eng.server.active, len(eng.server.cache)) == \
        (jeng.server.t, jeng.server.active, len(jeng.server.cache))
    np.testing.assert_array_equal(eng.devices.alive, jeng.devices.alive)
    assert _pending(eng, KIND_NAMES) == _pending(jeng, JKIND_NAMES)
    assert eng._now == jeng._now


# rows of tests/test_wave_handlers.py WAVE_GRID:
# (n_devices, method, codec, cohort_size, seed, tiered, bw_scale)
GRID = [(6, "teasq", "dense", 0, 0, False, 1.0),
        (8, "teasq", "packed", 4, 1, True, 0.25),
        (10, "fedasync", "packed", 3, 5, True, 0.5)]


@pytest.mark.parametrize("row", GRID, ids=lambda r: f"{r[1]}_{r[2]}_c{r[3]}")
def test_wave_matches_live_jax_on_the_wave_grid(row):
    n, method, codec, cohort, seed, tiered, bw = row
    tiers = ([(0.5, 1.0, 1.0, "fast"), (0.5, 2.0, bw, "slow")]
             if tiered else None)
    jax_run, port_run = _run_both(
        dict(n_devices=n, iid=True, seed=seed, n_train=16 * n, n_test=160),
        2.0, tiers=tiers, phi=float("inf"), method=method, n_devices=n,
        c_fraction=1.0, gamma=0.25, epochs=1, batch_size=8, p_s=0.25,
        p_q=8, seed=seed, codec=codec, cohort_size=cohort,
        cohort_channel_iters=6)
    _assert_wave_parity(jax_run, port_run)
    if tiered:
        assert len(port_run[0].channel.tier_up) == 2


def test_wave_matches_live_jax_with_a_binding_gate_and_failures():
    """A gate that binds (8 of 64 devices train at once), dropout and
    transient failures with retries, noisy compute: the scenario draws of
    a grant wave and its failing members' draws are in the JAX order."""
    n = 64
    jax_run, port_run = _run_both(
        dict(n_devices=n, iid=True, seed=0, n_train=16 * n, n_test=160),
        3.0, scenario=dict(dropout_prob=0.05, failure_prob=0.1,
                           retry_backoff=0.1),
        method="teasq", n_devices=n, c_fraction=0.125, gamma=8.0 / n,
        epochs=1, batch_size=8, p_s=0.25, p_q=8, seed=0, codec="packed",
        cohort_size=4, cohort_channel_iters=6)
    _assert_wave_parity(jax_run, port_run)
    st = port_run[0].stats
    assert st.dropouts > 0 and st.transient_failures > 0
    assert st.redispatched > 0


def test_zero_step_regime_matches_live_jax(monkeypatch):
    """64 devices with 4 samples each and batches of 8: no device takes a
    local step, so every flush group goes through ``_zero_step_round``
    (the channel twice per model version) and never ``_cohort_round``."""
    calls = {"zero": 0, "cohort": 0}
    zero, cohort = tengine._zero_step_round, tengine._cohort_round

    def counted_zero(*a, **k):
        calls["zero"] += 1
        return zero(*a, **k)

    def counted_cohort(*a, **k):
        calls["cohort"] += 1
        return cohort(*a, **k)

    monkeypatch.setattr(tengine, "_zero_step_round", counted_zero)
    monkeypatch.setattr(tengine, "_cohort_round", counted_cohort)
    n = 64
    jax_run, port_run = _run_both(
        dict(n_devices=n, iid=True, seed=0, n_train=4 * n, n_test=160),
        6.0, method="teasq", n_devices=n, c_fraction=0.1, gamma=4.0 / n,
        epochs=1, batch_size=8, p_s=0.25, p_q=8, seed=0, cohort_size=8,
        cohort_channel_iters=6)
    _assert_wave_parity(jax_run, port_run)
    st = port_run[0].stats
    assert st.flushes > 10
    assert calls["cohort"] == 0 and calls["zero"] >= st.flushes


def test_wave_stops_at_max_rounds_and_resumes():
    """The round cap stops wave mode on the capping round, as serial mode
    does; a run cut by the budget and resumed reaches the same round count,
    meters and pending events as the JAX package's."""
    setup_kw = dict(n_devices=8, iid=True, seed=3, n_train=256, n_test=160)
    data, parts, w0 = make_setup(**setup_kw, device="cpu")
    for mode in ("serial", "wave"):
        cfg = SimConfig(method="teasq", n_devices=8, epochs=1, p_s=0.25,
                        p_q=8, seed=3, scheduler="batched",
                        handler_mode=mode)
        eng = make_sim(data, parts, w0, cfg, device="cpu")
        hist = eng.run(time_budget=50.0, max_rounds=6)
        assert (hist[-1].round, eng.server.t) == (6, 6)
    jdata, jparts, jw0 = jax_make_setup(**setup_kw)
    jcfg, cfg = _configs(method="teasq", n_devices=8, epochs=1, p_s=0.25,
                         p_q=8, seed=3, cohort_size=4, scheduler="batched",
                         handler_mode="wave")
    jeng = jax_make_sim(jdata, jparts, jw0, jcfg)
    eng = make_sim(data, parts, {k: v.clone() for k, v in w0.items()}, cfg,
                   device="cpu")
    for budget in (1.5, 4.0):
        h_jax, h_port = jeng.run(budget), eng.run(budget)
    assert [(e.time, e.round, e.bytes_up) for e in h_port] == \
        [(e.time, e.round, e.bytes_up) for e in h_jax]
    assert _pending(eng, KIND_NAMES) == _pending(jeng, JKIND_NAMES)


def _arrival_wave(eng, arr_id):
    """The live arrival events of ``eng`` in ``(time, seq)`` order, taken
    off its table as the wave loop takes a run."""
    table = eng.devices.events
    ks = np.flatnonzero(np.isfinite(table.time) & (table.kind == arr_id))
    ks = ks[np.lexsort((table.seq[ks], table.time[ks]))]
    wave = (table.time[ks].copy(), ks, [table.payload[k] for k in ks],
            table.h[ks].copy())
    table.clear_wave(ks)
    return wave


def _recorders(log):
    def push(t, kind, k, payload=None, h=0):
        log.append(("push", float(t), kind, int(k), int(h)))

    def wave(tag):
        def push_wave(ts, ks, kind, payloads, h):
            log.append((tag, np.asarray(ts).tolist(),
                        np.asarray(ks).tolist(), kind, int(h)))
        return push_wave
    return push, wave("wave"), wave("free")


@pytest.mark.parametrize("case", ["round_cap", "free_scatter"])
def test_wave_arrivals_cap_and_free_scatter_match_jax(case):
    """``_wave_arrivals`` called as a multi-task fleet calls it, on the
    same arrival run in both packages: ``max_rounds`` drops the arrivals
    past the round cap (counted in cache fills), and ``push_wave_free``
    takes the re-request scatter, even of a single arrival.  The scatters,
    the drain, the server's round and cache, the completions, the policy's
    estimates and the eval logs are exact against JAX."""
    n = 8
    (jeng, _), (eng, _) = _run_both(
        dict(n_devices=n, iid=True, seed=2, n_train=16 * n, n_test=160),
        1.0, method="teasq", n_devices=n, c_fraction=1.0, gamma=0.5,
        epochs=1, batch_size=8, p_s=0.25, p_q=8, seed=2, codec="dense",
        codec_policy="staleness_aware")
    logs = []
    for e, kinds in ((jeng, JKIND_NAMES), (eng, KIND_NAMES)):
        wts, wks, wps, whs = _arrival_wave(e, list(kinds).index("arrival"))
        srv = e.server
        log = []
        push, push_wave, free = _recorders(log)
        if case == "round_cap":
            # arrivals one by one (the scalar handler) until the cache
            # holds one entry, which the cap must count
            while len(srv.cache) != 1:
                e._wave_arrivals(wts[:1], wks[:1], wps[:1], whs[:1], 1,
                                 push, push_wave, e._waiting)
                wts, wks, wps, whs = wts[1:], wks[1:], wps[1:], whs[1:]
            allowed = srv.cfg.cache_size - len(srv.cache)
            assert len(wks) > allowed > 1
            kw = dict(max_rounds=srv.t + 1)
        else:
            wts, wks, wps, whs = wts[:1], wks[:1], wps[:1], whs[:1]
        if case == "free_scatter":
            kw = dict(push_wave_free=free)
        del log[:]
        t0, done0 = srv.t, e.stats.completions
        e._wave_arrivals(wts, wks, wps, whs, 1, push, push_wave, e._waiting,
                         **kw)
        done = e.stats.completions - done0
        assert done == (allowed if case == "round_cap" else 1)
        assert srv.t == t0 + (case == "round_cap")
        scatter = [r for r in log if r[0] != "push"][0]
        assert scatter[0] == ("wave" if case == "round_cap" else "free")
        assert len(scatter[2]) == done
        logs.append((log, srv.t, len(srv.cache), srv.active, done,
                     e.stats.completed_per_device.tolist(),
                     np.asarray(e.strategy.policy.staleness_est).tolist(),
                     [(h.time, h.round, h.bytes_up) for h in e.history],
                     len(e._waiting)))
    assert logs[0] == logs[1]
