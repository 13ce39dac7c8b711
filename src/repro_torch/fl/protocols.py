"""Protocol strategies + one-call drivers for the protocols of the paper's §5.

A strategy answers three questions for the engine
(``repro_torch.fl.engine.FLEngine``): which wire codec does a round-``t``
dispatch use (``channel_for``), how does a device train locally (Alg. 1
device side), and what happens when an update arrives at the server
(Alg. 2: cached staleness-weighted aggregation).  ``make_strategy``
resolves a method name from ``METHODS``.

Registered: the TEA family (``tea``, ``teas``, ``teaq``, ``teastatic``,
``teasq``: cached staleness-weighted aggregation), the immediate-mixing
baselines (``fedasync``, ``port``, ``asofed``: every arrival is mixed into
the global model), and the synchronous ones (``fedavg``, ``moon``), which
run the engine's ``_run_sync`` loop.  Every ``on_arrival`` resolves its
payload through ``engine.resolve_payload``, so each protocol also runs on
the cohort trainer's deferred tasks.  The batched scheduler's wave
handlers talk to a strategy through group-shaped hooks (``channels_for``
on grants, ``on_arrivals`` on arrivals); the TEA family fuses an arrival
wave into the server's ``receive_many``.
"""
from __future__ import annotations

from typing import Any, ClassVar, Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.core.codecs import Codec, resolve_codec
from repro_torch.core.dynamic import (DEFAULT_SET_Q, DEFAULT_SET_S,
                                      greedy_search, greedy_search_per_tier)
from repro_torch.core.staleness import staleness_weight
from repro_torch.data.synthetic import partition_iid, partition_noniid_classes
from repro_torch.fl.policies import make_policy
from repro_torch.fl.simulator import (FLSimulator, LogEntry, SimConfig,
                                      moon_local_train)
from repro_torch.fl.tasks import get_task
from repro_torch.utils.tree import (Params, from_numpy, leaves,
                                    resolve_device, tree_map)

METHODS = ("fedavg", "fedasync", "tea", "teas", "teaq", "teastatic",
           "teasq", "moon", "port", "asofed")


class ProtocolStrategy:
    """One FL protocol, bound to a SimConfig (see the JAX package's
    ``ProtocolStrategy`` for the full hook contract)."""

    method: ClassVar[str] = ""
    event_driven: ClassVar[bool] = True
    # True when on_arrivals fuses a whole arrival wave: the wave engine
    # routes arrival runs through it only for strategies that declare it
    arrival_wave: ClassVar[bool] = False

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.policy = make_policy(cfg.codec_policy, cfg)

    def compression_at(self, t: int) -> Tuple[float, int]:
        return 1.0, 32

    def channel_for(self, t: int, device_id: Optional[int] = None) -> Codec:
        """Codec for a round-``t`` dispatch to ``device_id``: the global
        (p_s, p_q) point, adapted per device by the bound policy."""
        p_s, p_q = self.compression_at(t)
        return self.policy.codec_for(t, device_id, p_s, p_q)

    def local_train(self, engine, k: int, w: Params) -> Tuple[Params, int]:
        return engine.trainer.train(k, w)

    def on_arrival(self, engine, now: float, k: int, payload: Any,
                   h: int) -> bool:
        """Server-side handling of a completed upload; True when an
        aggregation round finished."""
        raise NotImplementedError(
            f"{self.method} is not an event-driven protocol")

    # -- batched hooks (BatchedEngine) ----------------------------------
    def channels_for(self, t: int, device_ids) -> List[Codec]:
        """The wire codec for each device of a round-``t`` grant wave:
        through the policy's ``codecs_for`` (one resolve per distinct
        point) when the strategy keeps the stock ``channel_for``, else the
        override per device."""
        if type(self).channel_for is ProtocolStrategy.channel_for:
            p_s, p_q = self.compression_at(t)
            return self.policy.codecs_for(t, device_ids, p_s, p_q)
        return [self.channel_for(t, device_id=int(k)) for k in device_ids]

    def on_arrivals(self, engine, arrivals) -> List[bool]:
        """``arrivals`` is ``[(now, k, payload, h), ...]`` in event order;
        returns the per-arrival done-round flags (default: ``on_arrival``
        in order)."""
        return [self.on_arrival(engine, now, k, payload, h)
                for now, k, payload, h in arrivals]

    def aggregate(self, engine, updates: List[Params],
                  weights: List[int]) -> Params:
        raise NotImplementedError(
            f"{self.method} does not run the synchronous loop")

    # -- checkpoint state: a registered strategy keeps none beyond its
    # policy's staleness estimates
    def state_dict(self) -> Dict[str, Any]:
        return {"policy": self.policy.state_dict()}

    def load_state(self, state: Dict[str, Any]) -> None:
        self.policy.load_state(state["policy"])


# -- TEA-Fed family: cached staleness-weighted aggregation (Alg. 2) -------
class TeaStrategy(ProtocolStrategy):
    """TEA-Fed: asynchronous cached aggregation, no wire compression."""

    method = "tea"
    arrival_wave = True   # Alg. 2 is order-insensitive within a cache fill

    def on_arrival(self, engine, now, k, payload, h) -> bool:
        w_local, n_k = engine.resolve_payload(payload)
        return engine.server.receive(w_local, h, n_k)

    def on_arrivals(self, engine, arrivals) -> List[bool]:
        """Alg. 2 over an arrival group in wave mode: resolve every
        payload, then one ``receive_many`` (the stacked Eqs. 6-10 kernel
        per cache fill).  Singletons and serial mode keep ``receive``."""
        if len(arrivals) <= 1 or engine.cfg.handler_mode != "wave":
            return super().on_arrivals(engine, arrivals)
        entries = []
        for _now, _k, payload, h in arrivals:
            w_local, n_k = engine.resolve_payload(payload)
            entries.append((w_local, h, n_k))
        return engine.server.receive_many(entries)


class TeasStrategy(TeaStrategy):
    method = "teas"

    def compression_at(self, t):
        return self.cfg.p_s, 32


class TeaqStrategy(TeaStrategy):
    method = "teaq"

    def compression_at(self, t):
        return 1.0, self.cfg.p_q


class TeaStaticStrategy(TeaStrategy):
    method = "teastatic"

    def compression_at(self, t):
        return self.cfg.p_s, self.cfg.p_q


class TeasqStrategy(TeaStaticStrategy):
    """Full TEASQ-Fed: Alg. 5 decay schedule when provided, else static."""

    method = "teasq"

    def compression_at(self, t):
        if self.cfg.schedule is not None:
            return self.cfg.schedule.at_round(t)
        return self.cfg.p_s, self.cfg.p_q


# -- immediate-update async baselines -------------------------------------
class FedAsyncStrategy(ProtocolStrategy):
    """FedAsync (Xie et al.): mix every arrival straight into the global
    model with a staleness-decayed weight; every arrival is a round."""

    method = "fedasync"

    def mixing_weight(self, staleness: int) -> float:
        cfg = self.cfg
        stale = min(staleness, cfg.max_staleness)   # capped poly decay
        return cfg.alpha * float(staleness_weight(stale, cfg.a))

    def on_arrival(self, engine, now, k, payload, h) -> bool:
        w_local, _ = engine.resolve_payload(payload)
        srv = engine.server
        srv.active = max(0, srv.active - 1)
        a_t = self.mixing_weight(srv.t - h)
        srv.w = tree_map(lambda l, g: a_t * l + (1 - a_t) * g, w_local,
                         srv.w)
        srv.t += 1
        return True


class PortStrategy(FedAsyncStrategy):
    method = "port"

    def mixing_weight(self, staleness):   # unbounded staleness, harder decay
        return self.cfg.alpha * (staleness + 1.0) ** -1.0


class AsoFedStrategy(FedAsyncStrategy):
    method = "asofed"

    def mixing_weight(self, staleness):   # linear decay
        return self.cfg.alpha / (1.0 + staleness)


# -- synchronous baselines -------------------------------------------------
class FedAvgStrategy(ProtocolStrategy):
    """Synchronous FedAvg: sample a round cohort, wait for the straggler,
    merge by sample-count weights."""

    method = "fedavg"
    event_driven = False

    def aggregate(self, engine, updates, weights):
        wts = np.asarray(weights, np.float32)
        wts /= wts.sum()
        return tree_map(
            lambda *us: sum(float(w) * u for w, u in zip(wts, us)),
            *updates)


class MoonStrategy(FedAvgStrategy):
    """MOON (Li et al., CVPR'21): FedAvg round structure with a model-
    contrastive local objective against the device's previous model."""

    method = "moon"

    def local_train(self, engine, k, w_glob):
        cfg = self.cfg
        task = engine.task
        idx = engine.partition_index(k)
        prev = engine.prev_local.get(k, w_glob)
        params = moon_local_train(
            w_glob, prev, engine.x_train[idx], engine.y_train[idx],
            epochs=cfg.epochs, batch_size=cfg.batch_size, lr=cfg.lr,
            rng=engine.rng, forward_fn=task.forward,
            features_fn=task.features)
        engine.prev_local[k] = params
        return params, len(idx)


STRATEGIES: Dict[str, Type[ProtocolStrategy]] = {
    cls.method: cls for cls in (
        TeaStrategy, TeasStrategy, TeaqStrategy, TeaStaticStrategy,
        TeasqStrategy, FedAsyncStrategy, PortStrategy, AsoFedStrategy,
        FedAvgStrategy, MoonStrategy)
}
assert set(STRATEGIES) == set(METHODS)


def make_strategy(method: str, cfg: SimConfig) -> ProtocolStrategy:
    try:
        return STRATEGIES[method](cfg)
    except KeyError:
        raise ValueError(f"unknown method {method!r}; "
                         f"expected one of {sorted(METHODS)}") from None


# ----------------------------------------------------------------------
# One-call drivers
# ----------------------------------------------------------------------
def make_setup(n_devices: int = 100, iid: bool = True, seed: int = 0,
               n_train: int = 60000, n_test: int = 10000,
               task: str = "fmnist_cnn", *, device=None,
               init_params: Optional[Dict[str, Any]] = None):
    """Synthetic (data, partitions, w0) for a registered FLTask -- the
    default is the paper's FMNIST CNN workload.  Data and partitions are
    numpy, bit-equal to the JAX package's; ``w0`` is a parameter dict on
    ``device``: the port's own init from a ``torch.Generator`` seeded with
    ``seed``, or ``init_params`` (e.g. the JAX package's weights) carried
    over unchanged."""
    device = resolve_device(device)
    t = get_task(task)
    data = t.make_data(n_train, n_test, seed)
    if iid:
        parts = partition_iid(n_train, n_devices, seed)
    else:
        parts = partition_noniid_classes(data["y_train"], n_devices, 2, seed)
    if init_params is not None:
        w0 = from_numpy(init_params, device)
    else:
        w0 = t.init_params(torch.Generator().manual_seed(seed), device)
    return data, parts, w0


def make_sim(data, parts, w0: Params, cfg: SimConfig,
             backend: str = "engine", *, device=None):
    """Build a runnable simulator on ``device`` (the card unless the
    caller names another): the strategy-based engine (default) or the
    legacy monolithic ``FLSimulator`` (the parity reference).
    ``cfg.scheduler`` picks the engine's event loop from
    ``repro_torch.fl.engine.SCHEDULERS``: the ``"heap"`` one or the
    array-backed ``"batched"`` one (which also runs
    ``handler_mode="wave"``)."""
    if backend == "legacy":
        return FLSimulator(data, parts, w0, cfg, device=device)
    if backend != "engine":
        raise ValueError(f"unknown backend {backend!r}")
    from repro_torch.fl.engine import SCHEDULERS
    try:
        engine_cls = SCHEDULERS[cfg.scheduler]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {cfg.scheduler!r}; "
            f"expected one of {sorted(SCHEDULERS)}") from None
    return engine_cls(data, parts, w0, cfg, device=device)


def train_global(data, parts, w0: Params, time_budget: float = 20.0,
                 seed: int = 0, *, device=None, **kw) -> Params:
    """Briefly train a global model (TEA protocol) and return its weights:
    Algorithm 5 profiles compression on a trained model, not the random
    init.  ``kw`` entries that are ``SimConfig`` fields configure the run;
    others are ignored, as in the JAX package."""
    cfg = SimConfig(method="tea", n_devices=len(parts), seed=seed,
                    **{k: v for k, v in kw.items() if hasattr(SimConfig, k)})
    sim = make_sim(data, parts, w0, cfg, device=device)
    sim.run(time_budget=time_budget, eval_every=10 ** 9)
    return sim.server.w


def profile_compression(w: Params, data: Dict[str, np.ndarray],
                        theta: float = 0.02, seed: int = 0,
                        codec: str = "dense", task: str = "fmnist_cnn",
                        tiers=None):
    """Algorithm 5 search on a profiling model ``w`` (on its device),
    through the codec seam with stochastic rounding.  Returns ``(si, qi,
    trace)``, or with ``tiers`` ``(tier_points, traces)`` (see the JAX
    package's ``profile_compression``)."""
    device = leaves(w)[0].device
    xs = torch.from_numpy(data["x_test"][:2000]).to(device)
    ys = torch.from_numpy(data["y_test"][:2000]).to(device)
    metric = get_task(task).eval_metric
    rng = np.random.RandomState(seed)

    def eval_acc(p_s: float, p_q: int) -> float:
        w2, _ = resolve_codec(codec, p_s, p_q).roundtrip(w, rng=rng)
        with torch.no_grad():
            return float(metric(w2, xs, ys))

    if tiers is None:
        return greedy_search(eval_acc, theta)
    scales = [getattr(t, "bandwidth_scale", t) for t in tiers]
    points, traces = greedy_search_per_tier(eval_acc, theta, scales)
    return ([(DEFAULT_SET_S[si], DEFAULT_SET_Q[qi]) for si, qi in points],
            traces)


def run_method(method: str, data, parts, w0: Params, *, iid: bool = True,
               time_budget: float = 300.0, seed: int = 0,
               c_fraction: float = 0.1, mu: float = 0.01, alpha: float = 0.6,
               p_s: float = 0.25, p_q: int = 8,
               schedule=None, eval_every: int = 1,
               backend: str = "engine", device=None,
               **overrides) -> List[LogEntry]:
    """One simulated run of ``method`` on ``device`` (the card unless the
    caller names another), on the engine or the ``"legacy"`` simulator;
    returns the LogEntry history."""
    device = resolve_device(device)
    cfg = SimConfig(method=method, n_devices=len(parts),
                    c_fraction=c_fraction, mu=mu, alpha=alpha,
                    p_s=p_s, p_q=p_q, schedule=schedule, seed=seed,
                    **overrides)
    sim = make_sim(data, parts, w0, cfg, backend=backend, device=device)
    return sim.run(time_budget=time_budget, eval_every=eval_every)


def best_acc_within(history: List[LogEntry], budget: float) -> float:
    accs = [h.accuracy for h in history if h.time <= budget]
    return max(accs) if accs else float("nan")


def time_to_acc(history: List[LogEntry], target: float) -> Optional[float]:
    for h in history:
        if h.accuracy >= target:
            return h.time
    return None
