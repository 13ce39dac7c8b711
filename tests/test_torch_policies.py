"""The codec policies (``static``, ``tier_aware``, ``staleness_aware``)
against the JAX package's, on the CPU.

Policies are host numpy in both packages, so every decision is exact: the
staleness EWMAs bit for bit, the notches, and the ``(p_s, p_q)`` point and
codec family each device gets.  Runs under a policy hold the time, round
and byte columns and every tier's meters exact against the live JAX run,
accuracy within ``ACC_TOL`` absolute per entry.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.dynamic import DEFAULT_SET_Q, DEFAULT_SET_S
from repro.fl import policies as jpolicies
from repro.fl.protocols import make_setup as jax_make_setup
from repro.fl.protocols import make_sim as jax_make_sim
from repro.fl.protocols import \
    profile_compression as jax_profile_compression
from repro.fl.protocols import make_strategy as jax_make_strategy
from repro.fl.simulator import ScenarioConfig as JScenarioConfig
from repro.fl.simulator import SimConfig as JSimConfig
from repro.fl.simulator import TierSpec as JTierSpec
from repro_torch.fl import policies as tpolicies
from repro_torch.fl.protocols import (make_setup, make_sim, make_strategy,
                                      profile_compression)
from repro_torch.fl.simulator import ScenarioConfig, SimConfig, TierSpec

from conftest import TINY_RUN_KW, TINY_SETUP
from torch_threads import one_torch_thread  # noqa: F401

ACC_TOL = 0.025
COLUMNS = ("time", "round", "bytes_up", "bytes_down", "max_model_bytes_up",
           "max_model_bytes_down")
# (fraction, compute_scale, bandwidth_scale, name)
TIERS = [(0.25, 1.0, 1.0, "fast"), (0.375, 1.5, 0.5, "mid"),
         (0.375, 2.5, 0.125, "slow")]


@pytest.fixture(scope="module")
def setups():
    """(JAX setup, port setup), the port's w0 carried over from JAX's."""
    jdata, jparts, jw0 = jax_make_setup(**TINY_SETUP)
    w_np = {k: np.asarray(v) for k, v in jw0.items()}
    port = make_setup(**TINY_SETUP, device="cpu", init_params=w_np)
    return (jdata, jparts, jw0), port


def _cfgs(tiers=TIERS, scenario=None, **kw):
    """The same knobs as a JAX and a port ``SimConfig``."""
    out = []
    for sim_cfg, scen_cfg, tier_spec in (
            (JSimConfig, JScenarioConfig, JTierSpec),
            (SimConfig, ScenarioConfig, TierSpec)):
        extra = {}
        if tiers or scenario:
            extra["scenario"] = scen_cfg(
                tiers=[tier_spec(*t) for t in tiers] if tiers else None,
                **(scenario or {}))
        out.append(sim_cfg(**kw, **extra))
    return out


def _point(codec):
    return (type(codec).__name__, getattr(codec, "p_s", None),
            getattr(codec, "p_q", None))


def test_notch_point_matches_jax():
    for p_s in DEFAULT_SET_S + (0.3, 0.02, 0.07, 2.0):
        for p_q in DEFAULT_SET_Q + (6, 12, 2):
            for notches in range(7):
                assert tpolicies.notch_point(p_s, p_q, notches) == \
                    jpolicies.notch_point(p_s, p_q, notches)


@pytest.mark.parametrize("name", ["static", "tier_aware", "staleness_aware"])
def test_observe_arrivals_ewma_is_exact(name):
    """Distinct ids (one scatter), repeated ids (in order) and ids out of
    range (dropped), through both hooks: the same EWMAs bit for bit."""
    jcfg, tcfg = _cfgs(n_devices=20)
    jp, tp = jpolicies.make_policy(name, jcfg), tpolicies.make_policy(
        name, tcfg)
    rng = np.random.RandomState(3)
    for step in range(40):
        g = rng.randint(1, 12)
        if step % 3 == 0:
            ids = rng.permutation(20)[:g]                     # distinct
        elif step % 3 == 1:
            ids = rng.randint(0, 20, g)                       # repeats
        else:
            ids = rng.randint(-3, 25, g)                      # out of range
        stal = rng.randint(0, 9, g).astype(np.float64) * 0.5
        for p in (jp, tp):
            p.observe_arrivals(ids.tolist(), stal.tolist())
            p.observe_arrival(int(ids[0]), float(stal[-1]))
        np.testing.assert_array_equal(tp.staleness_est, jp.staleness_est)
    assert (tp.staleness_est != 0).any() == (name != "static")


@pytest.mark.parametrize("name,tier_points", [
    ("static", None), ("tier_aware", None),
    ("tier_aware", [(0.5, 16), (0.1, 8), (0.01, 4)]),
    ("staleness_aware", None)])
def test_each_device_gets_the_jax_point(name, tier_points):
    """``codec_for`` and ``codecs_for`` give every device (ids out of range
    and None included) the JAX policy's codec family and point, at
    compressing and uncompressed base points."""
    n = 16
    jcfg, tcfg = _cfgs(n_devices=n, codec="packed", tier_points=tier_points)
    jp, tp = jpolicies.make_policy(name, jcfg), tpolicies.make_policy(
        name, tcfg)
    stal = np.random.RandomState(1).randint(0, 12, n).astype(np.float64)
    for p in (jp, tp):            # staleness that crosses 0, 1 and 2 notches
        p.observe_arrivals(list(range(n)), stal.tolist())
        p.observe_arrivals(list(range(n)), stal.tolist())
    ids = list(range(n)) + [n, n + 5, -1]
    for base in ((0.25, 8), (0.1, 16), (0.5, 32), (1.0, 4), (1.0, 32)):
        want = [_point(jp.codec_for(3, k, *base)) for k in ids + [None]]
        got = [_point(tp.codec_for(3, k, *base)) for k in ids + [None]]
        assert got == want
        assert [_point(c) for c in tp.codecs_for(3, ids, *base)] == \
            [_point(c) for c in jp.codecs_for(3, ids, *base)]
        assert [_point(c) for c in tp.codecs_for(3, ids, *base)] == \
            got[:-1]
        assert dataclasses.astuple(tp.context(3, 7)) == \
            dataclasses.astuple(jp.context(3, 7))
        # a compressing base point is adapted per device, an uncompressed
        # one never
        assert len(set(got)) == (1 if name == "static" or base == (1.0, 32)
                                 else len(set(got)))
        if base == (0.25, 8):
            assert (len(set(got)) > 1) == (name != "static")


def test_policy_and_strategy_state_round_trip():
    """``state_dict`` -> ``load_state`` restores the EWMAs exactly, into a
    fresh port policy and into the JAX package's (and back)."""
    jcfg, tcfg = _cfgs(n_devices=12, codec_policy="staleness_aware",
                       p_s=0.25, p_q=8)
    ts = make_strategy("teasq", tcfg)
    ts.policy.observe_arrivals(list(range(12)), list(range(12)))
    state = ts.state_dict()
    fresh = make_strategy("teasq", tcfg)
    fresh.load_state(state)
    np.testing.assert_array_equal(fresh.policy.staleness_est,
                                  ts.policy.staleness_est)
    js = jax_make_strategy("teasq", jcfg)
    js.load_state(state)
    np.testing.assert_array_equal(js.policy.staleness_est,
                                  ts.policy.staleness_est)
    back = make_strategy("teasq", tcfg)
    back.load_state(js.state_dict())
    assert [_point(back.channel_for(0, k)) for k in range(12)] == \
        [_point(js.channel_for(0, k)) for k in range(12)]
    state["policy"]["staleness_est"][0] = 99.0   # load_state copies
    assert fresh.policy.staleness_est[0] != 99.0


def _run_both(setups, scheduler="heap", **kw):
    (jdata, jparts, jw0), (data, parts, w0) = setups
    jcfg, tcfg = _cfgs(n_devices=8, seed=3, epochs=1, method="teasq",
                       scheduler=scheduler, **kw)
    jeng = jax_make_sim(jdata, jparts, jw0, jcfg)
    h_jax = jeng.run(time_budget=TINY_RUN_KW["time_budget"])
    eng = make_sim(data, parts, w0, tcfg, device="cpu")
    h_port = eng.run(time_budget=TINY_RUN_KW["time_budget"])
    assert len(h_jax) == len(h_port) > 2
    for a, b in zip(h_jax, h_port):
        for c in COLUMNS:
            assert getattr(a, c) == getattr(b, c), c
        assert abs(a.accuracy - b.accuracy) <= ACC_TOL
    for name in ("tier_up", "tier_down", "bytes_up", "max_up"):
        assert getattr(eng.channel, name) == getattr(jeng.channel, name)
    return eng


def test_profiled_tier_points_drive_a_tier_aware_run(setups):
    """``profile_compression(tiers=...)`` finds the JAX package's per-tier
    points; a ``tier_aware`` run on them meters every tier's uplink
    exactly as the JAX run does, the slow tier below the fast one."""
    (jdata, _, jw0), (data, _, w0) = setups
    tiers = [TierSpec(*t) for t in TIERS]
    points, traces = profile_compression(w0, data, theta=0.02, seed=1,
                                         tiers=tiers)
    jpoints, jtraces = jax_profile_compression(
        jw0, jdata, theta=0.02, seed=1, tiers=[JTierSpec(*t) for t in TIERS])
    assert points == jpoints
    assert [[t[:2] for t in tr] for tr in traces] == \
        [[t[:2] for t in tr] for tr in jtraces]
    eng = _run_both(setups, codec_policy="tier_aware", tier_points=points,
                    p_s=0.25, p_q=8, codec="packed", c_fraction=0.5)
    assert len(eng.channel.tier_up) == 3
    per_task = {t: eng.channel.tier_up[t] / max(1, eng.stats.completions)
                for t in eng.channel.tier_up}
    assert per_task[2] <= per_task[0]


def test_tier_aware_without_points_matches_live_jax(setups):
    """The notched points (no ``tier_points``): each tier steps the base
    point by round(log2(1 / bandwidth_scale)) notches."""
    eng = _run_both(setups, codec_policy="tier_aware", p_s=0.25, p_q=8,
                    c_fraction=0.5)
    assert len(eng.channel.tier_up) == 3
    assert eng.channel.max_up == max(
        eng.strategy.channel_for(0, k).wire_bytes(eng.server.w)
        for k in range(8))


@pytest.mark.parametrize("scheduler", ["heap", "batched"])
def test_staleness_aware_under_dropout_matches_live_jax(setups, scheduler):
    """``staleness_aware`` with devices dropping out and failing: the
    estimates feed the next dispatches' points in the same order."""
    eng = _run_both(setups, scheduler=scheduler,
                    codec_policy="staleness_aware", tiers=None,
                    scenario=dict(dropout_prob=0.1, failure_prob=0.15),
                    p_s=0.25, p_q=8, c_fraction=1.0, gamma=0.5)
    assert eng.stats.dropouts + eng.stats.transient_failures > 0
    assert eng.strategy.policy.staleness_est.max() > 0
