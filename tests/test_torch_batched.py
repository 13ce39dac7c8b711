"""The batched scheduler's machinery and its serial handlers: the port
against a live run of the JAX package's, on the CPU, from the same inputs.

* ``EventTable``, ``_FifoWaiting``, ``round_latency_batch`` and the
  channel meter's wave accounting are host numpy in both packages: exact.
* ``aggregate_cache_stacked`` reduces by one tensordot per leaf in XLA and
  in PyTorch, summed in orders of their own: rtol 1e-5, atol 1e-6 (the JAX
  package's own tolerance between its stacked and sequential kernels).
* ``_zero_step_round`` is kernel B's channel form applied twice, whose
  plain version is bit-exact against the jitted JAX channel
  (tests/test_torch_channel.py): bit-identical.
* The port's batched scheduler in serial mode against its own heap
  scheduler: bit-identical histories, accuracy included (the same event
  order, the same float ops).  Against the live JAX batched run: the time,
  round and byte columns exact, accuracy within ``ACC_TOL`` absolute.
* ``train_global``: the same rounds, weights within 1e-4 (a few rounds of
  prox-SGD summed in other orders).
"""
import heapq

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.staleness import \
    aggregate_cache_stacked as jax_aggregate_cache_stacked
from repro.fl import engine as jengine
from repro.fl import protocols as jprotocols
from repro.fl.protocols import make_setup as jax_make_setup
from repro.fl.protocols import run_method as jax_run_method
from repro.fl.simulator import SimConfig as JSimConfig
from repro.models import cnn as jcnn
from repro_torch.core.server import ServerConfig, TeasqServer
from repro_torch.core.staleness import aggregate_cache_stacked
from repro_torch.fl import engine as tengine
from repro_torch.fl import protocols as tprotocols
from repro_torch.fl.protocols import (make_setup, make_sim, run_method,
                                      train_global)
from repro_torch.fl.simulator import SimConfig
from repro_torch.utils.tree import from_numpy

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


# ----------------------------------------------------------------------
# host machinery: exact
# ----------------------------------------------------------------------
def _tables(times, seqs):
    tt, jt = tengine.EventTable(len(times)), jengine.EventTable(len(times))
    for k, (t, s) in enumerate(zip(times, seqs)):
        if np.isfinite(t):
            for tab in (tt, jt):
                tab.put(k, t, s, "request", None, 0)
    return tt, jt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_event_table_select_batch_orders_like_a_heap(seed):
    """Random times with ties and empty slots: every ``select_batch`` gives
    the heap's ``(time, seq)`` order, and the JAX table's selection, with
    ``k_max`` below, at and above the live count."""
    rng = np.random.RandomState(seed)
    n = 300
    times = rng.choice(np.round(rng.uniform(0, 5, 40), 2), n)
    times[rng.rand(n) < 0.2] = np.inf
    seqs = rng.permutation(n * 3)[:n]
    tt, jt = _tables(times, seqs)
    heap = [(t, s, k) for k, (t, s) in enumerate(zip(times, seqs))
            if np.isfinite(t)]
    heapq.heapify(heap)
    order = [heapq.heappop(heap)[2] for _ in range(len(heap))]
    live = len(order)
    for k_max in (1, 7, 64, live - 1, live, live + 5, 4096):
        got = tt.select_batch(k_max)
        np.testing.assert_array_equal(got, jt.select_batch(k_max))
        # the first k_max of the heap order, plus whatever ties the k-th
        assert got.tolist() == order[:len(got)]
        assert len(got) >= min(k_max, live)
        if len(got) > k_max:
            assert times[got[k_max:]].min() == times[got[k_max - 1]]
    empty = tengine.EventTable(4)
    assert empty.select_batch(3).tolist() == []


def test_event_table_waves_match_jax():
    """``put_wave``/``clear_wave`` leave the same arrays as JAX's table."""
    rng = np.random.RandomState(5)
    tt, jt = tengine.EventTable(50), jengine.EventTable(50)
    ks = rng.permutation(50)[:20]
    ts = rng.uniform(0, 3, 20)
    for tab in (tt, jt):
        tab.put_wave(ks, ts, np.arange(20) + 7, "arrival",
                     [f"p{k}" for k in ks], 4)
        tab.clear_wave(ks[:5])
        tab.put(int(ks[0]), 1.25, 99, "failure", "dropout", 2)
    for name in ("time", "seq", "kind", "h", "task"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name))
    assert tt.payload == jt.payload
    np.testing.assert_array_equal(tt.select_batch(8), jt.select_batch(8))


def test_fifo_waiting_matches_jax():
    """``pop``, ``pop_many``, ``extend`` and compaction: the same items and
    the same buffer state as JAX's queue, step for step, across the
    compaction threshold."""
    tq, jq = tengine._FifoWaiting(), jengine._FifoWaiting()
    rng = np.random.RandomState(7)
    for step in range(4000):
        r = rng.random_sample()
        if r < 0.35:
            ks = list(range(step * 10, step * 10 + rng.randint(1, 40)))
            tq.extend(ks)
            jq.extend(ks)
        elif r < 0.6:
            tq.append(step)
            jq.append(step)
        elif r < 0.8 and len(jq):
            assert tq.pop(0) == jq.pop(0)
        else:
            g = rng.randint(0, 30)
            assert tq.pop_many(g) == jq.pop_many(g)
        assert (len(tq), tq._head, tq._items) == \
            (len(jq), jq._head, jq._items)
    deep, jdeep = tengine._FifoWaiting(), jengine._FifoWaiting()
    deep.extend(range(10 ** 5))
    jdeep.extend(range(10 ** 5))
    for g in (25_000, 35_000, 50_000):
        assert deep.pop_many(g) == jdeep.pop_many(g)
        assert (deep._head, len(deep._items)) == \
            (jdeep._head, len(jdeep._items))


def test_round_latency_batch_and_wave_meters_match_jax():
    """The same RNG state gives the same latency vectors bit for bit, and
    the meters' wave accounting equals JAX's (totals, maxima, per-tier)."""
    jr, tr = np.random.RandomState(11), np.random.RandomState(11)
    jreg = jengine.DeviceRegistry(JSimConfig(n_devices=40), jr)
    treg = tengine.DeviceRegistry(SimConfig(n_devices=40), tr)
    ks = np.sort(np.random.RandomState(2).permutation(40)[:17])
    bits = np.random.RandomState(3).randint(1000, 10 ** 6, 17) * 8.0
    nb = np.random.RandomState(4).randint(1, 30, 17)
    for _ in range(3):
        for got, want in zip(treg.round_latency_batch(ks, bits, bits, nb, tr),
                             jreg.round_latency_batch(ks, bits, bits, nb,
                                                      jr)):
            np.testing.assert_array_equal(got, want)
    assert tr.randint(1 << 30) == jr.randint(1 << 30)
    tm, jm = tengine.ChannelMeter(), jengine.ChannelMeter()
    rng = np.random.RandomState(9)
    for _ in range(6):
        nbytes = rng.randint(1, 200_000, 25).astype(np.int64)
        tiers = rng.randint(0, 3, 25)
        for m in (tm, jm):
            m.down_wave(nbytes, tiers)
            m.up_wave(nbytes[:10], tiers[:10])
            m.up(77, 1)
        tm.down_wave(nbytes[:0], tiers[:0])
    for name in ("bytes_up", "bytes_down", "max_up", "max_down", "tier_up",
                 "tier_down"):
        assert getattr(tm, name) == getattr(jm, name), name


# ----------------------------------------------------------------------
# stacked aggregation and the zero-step channel
# ----------------------------------------------------------------------
def _cache(rng, k, shapes):
    return [({n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()},
             int(rng.randint(0, 6)), int(rng.randint(5, 60)))
            for _ in range(k)]


@pytest.mark.parametrize("k", [1, 3, 10])
def test_aggregate_cache_stacked_matches_jax(k):
    rng = np.random.RandomState(k)
    shapes = {"w1": (6, 4), "b": (4,), "conv": (2, 2, 1, 3)}
    w = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    cache = _cache(rng, k, shapes)
    want = jax_aggregate_cache_stacked(
        {n: jnp.asarray(v) for n, v in w.items()},
        [({n: jnp.asarray(v) for n, v in c.items()}, h, m)
         for c, h, m in cache], 7, 0.6, 0.5)
    got = aggregate_cache_stacked(
        from_numpy(w, "cpu"),
        [(from_numpy(c, "cpu"), h, m) for c, h, m in cache], 7, 0.6, 0.5)
    for n in shapes:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=1e-5, atol=1e-6)


def test_receive_many_matches_receive():
    """The wave Receiver over a split group replays one ``receive`` per
    entry: the same flags, round, cache depth and ``active``, weights
    within 1e-5."""
    rng = np.random.RandomState(0)
    shapes = {"w1": (6, 4), "b": (4,)}
    w0 = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    cfg = ServerConfig(n_devices=10, gamma=0.3)      # K = 3
    srv_a = TeasqServer(from_numpy(w0, "cpu"), cfg)
    srv_b = TeasqServer(from_numpy(w0, "cpu"), cfg)
    entries = [(from_numpy({n: rng.randn(*s).astype(np.float32)
                            for n, s in shapes.items()}, "cpu"),
                max(0, i % 4 - 1), 10 + 3 * i) for i in range(8)]
    srv_a.active = srv_b.active = 8                  # receive decrements
    done_a = [srv_a.receive(*e) for e in entries]
    done_b = srv_b.receive_many(entries[:5]) + srv_b.receive_many(
        entries[5:])
    assert done_a == done_b
    assert (srv_a.t, len(srv_a.cache), srv_a.active) == \
        (srv_b.t, len(srv_b.cache), srv_b.active)
    for n in shapes:
        np.testing.assert_allclose(srv_a.w[n].numpy(), srv_b.w[n].numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("v", [1, 3])
@pytest.mark.parametrize("point", [(0.25, 8, 6), (0.05, 4, 6)])
def test_zero_step_round_matches_jax(v, point):
    """V model versions of the CNN through the channel twice: bit for bit
    the jitted JAX ``_zero_step_round``."""
    p_s, p_q, iters = point
    base = {k: np.asarray(x) for k, x in
            jcnn.init_cnn(jax.random.PRNGKey(v)).items()}
    rng = np.random.RandomState(v)
    wv = {k: (x[None] + rng.randn(v, *x.shape) * 0.02).astype(np.float32)
          for k, x in base.items()}
    want = jengine._zero_step_round({k: jnp.asarray(x) for k, x in
                                     wv.items()}, p_s=p_s, p_q=p_q,
                                    iters=iters)
    got = tengine._zero_step_round(from_numpy(wv, "cpu"), p_s=p_s, p_q=p_q,
                                   iters=iters)
    for k in wv:
        assert got[k].shape == wv[k].shape
        np.testing.assert_array_equal(got[k].numpy().view(np.int32),
                                      np.asarray(want[k]).view(np.int32))


# ----------------------------------------------------------------------
# the batched scheduler, serial handlers
# ----------------------------------------------------------------------
SERIAL_CASES = [("teasq", dict(codec="packed")),
                ("teasq", dict(cohort_size=4)),
                ("fedasync", dict()),
                ("fedavg", dict())]


@pytest.mark.parametrize("method,extra", SERIAL_CASES,
                         ids=["teasq_packed", "teasq_cohort4", "fedasync",
                              "fedavg"])
def test_batched_serial_is_bit_identical_to_heap(setups, method, extra):
    _, (data, parts, w0) = setups
    kw = dict(TINY_RUN_KW, p_s=0.25, p_q=8, **extra)
    h_heap = run_method(method, data, parts, w0, device="cpu", **kw)
    h_batched = run_method(method, data, parts, w0, device="cpu",
                           scheduler="batched", handler_mode="serial", **kw)
    assert len(h_heap) > 2
    assert h_heap == h_batched


@pytest.mark.parametrize("method,extra", SERIAL_CASES[:2],
                         ids=["teasq_packed", "teasq_cohort4"])
def test_batched_serial_matches_live_jax(setups, method, extra):
    (jdata, jparts, jw0), (data, parts, w0) = setups
    kw = dict(TINY_RUN_KW, p_s=0.25, p_q=8, scheduler="batched", **extra)
    h_jax = jax_run_method(method, jdata, jparts, jw0, **kw)
    h_port = run_method(method, data, parts, w0, device="cpu", **kw)
    assert len(h_jax) == len(h_port) > 2
    for a, b in zip(h_jax, h_port):
        for c in COLUMNS:
            assert getattr(a, c) == getattr(b, c), c
        assert abs(a.accuracy - b.accuracy) <= ACC_TOL


def test_batched_resumes_and_stops_at_max_rounds(setups):
    """``run(t)`` then ``run(T)`` equals ``run(T)``, and ``max_rounds``
    stops on the capping round, on the batched scheduler too."""
    _, (data, parts, w0) = setups
    cfg = SimConfig(method="teasq", n_devices=8, seed=3, epochs=1, p_s=0.25,
                    p_q=8, scheduler="batched")
    whole = make_sim(data, parts, w0, cfg, device="cpu").run(4.0)
    sim = make_sim(data, parts, w0, cfg, device="cpu")
    sim.run(2.0)
    assert sim.run(4.0) == whole
    capped = make_sim(data, parts, w0, cfg, device="cpu")
    hist = capped.run(100.0, max_rounds=3)
    assert capped.server.t == 3 and hist[-1].round == 3


def test_train_global_matches_jax(setups, monkeypatch):
    """The same TEA run (same rounds), weights within 1e-4; ``kw`` that are
    not ``SimConfig`` fields are ignored on both sides."""
    (jdata, jparts, jw0), (data, parts, w0) = setups
    sims = {}
    for name, mod in (("jax", jprotocols), ("port", tprotocols)):
        def capture(*a, _make=mod.make_sim, _name=name, **k):
            sims[_name] = _make(*a, **k)
            return sims[_name]
        monkeypatch.setattr(mod, "make_sim", capture)
    w_jax = jprotocols.train_global(jdata, jparts, jw0, time_budget=2.0,
                                    seed=3, epochs=1, not_a_field=1)
    w_port = train_global(data, parts, w0, time_budget=2.0, seed=3,
                          device="cpu", epochs=1, not_a_field=1)
    assert sims["port"].server.t == sims["jax"].server.t >= 2
    assert sims["port"].cfg.method == "tea"
    for k in w0:
        assert not np.array_equal(w_port[k].numpy(), w0[k].numpy())
        np.testing.assert_allclose(w_port[k].numpy(), np.asarray(w_jax[k]),
                                   rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------------
# validation
# ----------------------------------------------------------------------
def test_scheduler_and_handler_mode_validation(setups):
    _, (data, parts, w0) = setups
    with pytest.raises(ValueError, match="unknown scheduler"):
        make_sim(data, parts, w0, SimConfig(n_devices=8, scheduler="x"),
                 device="cpu")
    with pytest.raises(ValueError, match="batched"):
        make_sim(data, parts, w0, SimConfig(n_devices=8,
                                            handler_mode="wave"),
                 device="cpu")
    with pytest.raises(ValueError, match="unknown handler_mode"):
        make_sim(data, parts, w0, SimConfig(n_devices=8, scheduler="batched",
                                            handler_mode="vector"),
                 device="cpu")
    for knobs in (dict(scheduler="batched"),
                  dict(scheduler="batched", handler_mode="wave"),
                  dict(codec_policy="tier_aware"),
                  dict(codec_policy="staleness_aware")):
        sim = make_sim(data, parts, w0, SimConfig(n_devices=8, epochs=1,
                                                  p_s=0.25, p_q=8, **knobs),
                       device="cpu")
        hist = sim.run(1.0)
        assert hist[-1].round >= 1 and hist[-1].bytes_up > 0
    assert isinstance(sim, tengine.FLEngine)
    assert tengine.SCHEDULERS["batched"].supports_wave


@pytest.mark.cuda
def test_batched_wave_run_on_card(setups):
    """A batched wave run with the cohort trainer on the card: kernel B's
    channel form launches inside it, and its timeline equals the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python3 chip_smoke.py runs the "
                    "wave path on the card)")
    from repro_torch.kernels import topk_quant
    _, (data, parts, w0) = setups
    kw = dict(TINY_RUN_KW, p_s=0.25, p_q=8, cohort_size=4,
              scheduler="batched", handler_mode="wave")
    h_cpu = run_method("teasq", data, parts, w0, device="cpu", **kw)
    before = topk_quant.LAUNCHES
    h_gpu = run_method("teasq", data, parts,
                       {k: v.cuda() for k, v in w0.items()}, device="cuda",
                       **kw)
    assert topk_quant.LAUNCHES > before
    assert len(h_cpu) == len(h_gpu)
    for a, b in zip(h_cpu, h_gpu):
        for c in COLUMNS:
            assert getattr(a, c) == getattr(b, c), c
        assert abs(a.accuracy - b.accuracy) <= 0.05
