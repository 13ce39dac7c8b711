"""Simulation configuration, log records and the legacy simulator.

:class:`SimConfig` (the JAX package's fields and defaults), :class:`LogEntry`,
the scenario knobs (:class:`ScenarioConfig`, :class:`TierSpec`),
``tier_assignment``, MOON's local update (``moon_local_train``), and
:class:`FLSimulator`: the legacy monolithic simulator, which
``make_sim(..., backend="legacy")`` builds.  It is the JAX package's parity
reference for the engine and keeps its RNG draw order: the same event
timeline from the same seed.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.client import local_update
from repro_torch.core.codecs import IdentityCodec
from repro_torch.core.dynamic import CompressionSchedule
from repro_torch.core.latency import ComputeConfig, WirelessConfig
from repro_torch.core.server import ServerConfig, TeasqServer
from repro_torch.core.staleness import staleness_weight
from repro_torch.utils.tree import (Path, leaves, paths, resolve_device,
                                    tree_map, unflatten)

Params = Dict[str, torch.Tensor]


def _moon_sgd_step(params: List[torch.Tensor], names: List[Path],
                   images: torch.Tensor, labels: torch.Tensor,
                   z_glob: torch.Tensor, z_prev: torch.Tensor, lr: float,
                   mu_con: float, tau: float, forward_fn: Callable,
                   features_fn: Callable) -> List[torch.Tensor]:
    """MOON (Li et al., CVPR'21) local step: CE + model-contrastive loss
    pulling the representation toward the global model's (``z_glob``) and
    away from the device's previous local model's (``z_prev``), then one
    plain SGD step."""
    for p in params:
        p.requires_grad_(True)
    w = unflatten(names, params)
    logp = F.log_softmax(forward_fn(w, images), dim=-1)
    ce = -torch.gather(logp, 1, labels.long()[:, None]).mean()
    z = features_fn(w, images)

    def cos(a, b):
        return (a * b).sum(-1) / (torch.linalg.norm(a, dim=-1)
                                  * torch.linalg.norm(b, dim=-1) + 1e-8)

    sim_g = cos(z, z_glob) / tau
    sim_p = cos(z, z_prev) / tau
    lcon = -(sim_g - torch.logaddexp(sim_g, sim_p)).mean()
    grads = torch.autograd.grad(ce + mu_con * lcon, params)
    with torch.no_grad():
        return [p - lr * g for p, g in zip(params, grads)]


def moon_local_train(w_glob: Params, prev: Params, x: torch.Tensor,
                     y: torch.Tensor, *, epochs: int, batch_size: int,
                     lr: float, rng: np.random.RandomState,
                     forward_fn: Callable, features_fn: Callable,
                     mu_con: float = 1.0, tau: float = 0.5) -> Params:
    """MOON device-side update: E epochs of ``_moon_sgd_step`` minibatches
    from ``w_glob``, the minibatch order drawn from ``rng`` (one
    permutation per epoch, as in the JAX package).  The global and
    previous models' features carry no gradient."""
    if forward_fn is None or features_fn is None:
        raise ValueError(
            "MOON's model-contrastive term needs the task's forward and "
            "features heads (FLTask.forward / FLTask.features)")
    names = paths(w_glob)
    params = [v.detach() for v in leaves(w_glob)]
    n = len(y)
    for _ in range(epochs):
        order = torch.from_numpy(rng.permutation(n)).to(x.device)
        for s in range(0, n - batch_size + 1, batch_size):
            sel = order[s:s + batch_size]
            images, labels = x[sel], y[sel]
            with torch.no_grad():
                z_glob = features_fn(w_glob, images)
                z_prev = features_fn(prev, images)
            params = _moon_sgd_step(params, names, images, labels, z_glob,
                                    z_prev, lr, mu_con, tau, forward_fn,
                                    features_fn)
    return unflatten(names, params)


@dataclasses.dataclass
class TierSpec:
    """One heterogeneity tier: a fraction of the fleet with scaled compute
    speed (multiplies the shifted-exponential coefficient a_k; >1 = slower)
    and scaled link bandwidth (multiplies both directions' rates;
    <1 = slower links)."""
    fraction: float
    compute_scale: float = 1.0
    bandwidth_scale: float = 1.0
    name: str = ""


def tier_assignment(n_devices: int,
                    tiers: Optional[List[TierSpec]]) -> np.ndarray:
    """Contiguous deterministic tier indices by device id: tier ``i`` covers
    the next ``round(fraction_i * n)`` devices and the last tier absorbs the
    remainder."""
    tier = np.zeros(n_devices, np.int64)
    if not tiers:
        return tier
    start = 0
    for i, t in enumerate(tiers):
        stop = n_devices if i == len(tiers) - 1 else min(
            n_devices, start + int(round(t.fraction * n_devices)))
        tier[start:stop] = i
        start = stop
    return tier


@dataclasses.dataclass
class ScenarioConfig:
    """Scenario-injection knobs, drawn from a dedicated RNG stream so that
    an all-zero scenario leaves the engine's event stream unchanged.

    * ``dropout_prob``: per-task probability the device leaves the fleet
      mid-round (permanent); its slot is freed and re-dispatched.
    * ``failure_prob``: per-task probability of a transient mid-round
      crash; the device retries after ``retry_backoff`` simulated seconds.
    * ``tiers``: heterogeneous compute/bandwidth ``TierSpec`` tiers,
      assigned contiguously by device index (see ``tier_assignment``).
    """
    dropout_prob: float = 0.0
    failure_prob: float = 0.0
    retry_backoff: float = 1.0
    tiers: Optional[List[TierSpec]] = None

    @property
    def active(self) -> bool:
        return (self.dropout_prob > 0.0 or self.failure_prob > 0.0
                or bool(self.tiers))


@dataclasses.dataclass
class SimConfig:
    """Every knob of a simulated run, with the JAX package's names and
    defaults (see its ``SimConfig`` docstring for each one).  The port runs
    both schedulers (``"heap"``, ``"batched"``), both handler modes
    (``"serial"``; ``"wave"`` on the batched scheduler only), every codec
    policy, both servers (``"single"``, and ``"sharded"`` over the ranks of
    the ``torch.distributed`` world, ``server_shards`` of them at most),
    with the serial trainer or, at ``cohort_size > 0``, the cohort
    trainer."""

    method: str = "teasq"
    task: str = "fmnist_cnn"
    n_devices: int = 100
    c_fraction: float = 0.1
    gamma: float = 0.1
    alpha: float = 0.6
    a: float = 0.5
    mu: float = 0.01
    epochs: int = 2
    batch_size: int = 40
    lr: float = 0.08
    # compression (used by teas/teaq/teastatic/teasq)
    p_s: float = 1.0
    p_q: int = 32
    schedule: Optional[CompressionSchedule] = None
    codec: str = "dense"
    # per-device adaptive codec policy (repro_torch.fl.policies.POLICIES)
    codec_policy: str = "static"
    tier_points: Optional[List[Tuple[float, int]]] = None
    # latency model
    wireless: WirelessConfig = dataclasses.field(default_factory=WirelessConfig)
    compute: ComputeConfig = dataclasses.field(default_factory=ComputeConfig)
    # fedavg / fedasync
    devices_per_round: int = 10
    max_staleness: int = 4
    seed: int = 0
    # engine-only knobs
    scheduler: str = "heap"
    cohort_size: int = 0
    cohort_channel_iters: int = 12   # threshold binary-search iterations
    handler_mode: str = "serial"     # "serial" | "wave" (batched only)
    server: str = "single"           # repro_torch.core.server.SERVERS backend
    server_shards: int = 0           # sharded-server mesh width (0 = all)
    scenario: Optional[ScenarioConfig] = None


@dataclasses.dataclass
class LogEntry:
    time: float
    round: int
    accuracy: float
    bytes_up: int
    bytes_down: int
    max_model_bytes_up: int
    max_model_bytes_down: int


class FLSimulator:
    """The legacy monolithic simulator: one heap of request/arrival events
    for the asynchronous protocols and a straggler-bound loop for FedAvg
    and MOON, on ``device`` (the card unless the caller names another).
    It shares ``DeviceRegistry``, ``local_update``, ``moon_local_train``,
    ``TeasqServer`` and the strategies' ``channel_for`` with the engine,
    and draws from ``self.rng`` in the JAX ``FLSimulator``'s order."""

    def __init__(self, data: Dict[str, np.ndarray],
                 partitions: List[np.ndarray], w_init: Params,
                 cfg: SimConfig, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.data = data
        self.partitions = partitions
        self.rng = np.random.RandomState(cfg.seed)
        n = cfg.n_devices
        assert len(partitions) == n
        # rates then a_k, in the engine's order (lazy imports: the engine
        # and the protocols import this module)
        from repro_torch.fl.engine import DeviceRegistry
        self.devices = DeviceRegistry(cfg, self.rng)
        if cfg.scenario is not None and cfg.scenario.tiers:
            self.devices.apply_tiers(cfg.scenario.tiers)
        self.server = TeasqServer(
            tree_map(lambda v: v.to(self.device), w_init),
            ServerConfig(n, cfg.c_fraction, cfg.gamma, cfg.alpha, cfg.a))
        self.bytes_up = 0
        self.bytes_down = 0
        self.max_up = 0
        self.max_down = 0
        self.prev_local: Dict[int, Params] = {}   # MOON: per-device prev model
        from repro_torch.fl.tasks import get_task
        self.task = get_task(cfg.task)
        self.history: List[LogEntry] = []
        self.x_train = torch.from_numpy(data["x_train"]).to(self.device)
        self.y_train = torch.from_numpy(data["y_train"]).to(self.device)
        self.x_test = torch.from_numpy(data["x_test"]).to(self.device)
        self.y_test = torch.from_numpy(data["y_test"]).to(self.device)
        from repro_torch.fl.protocols import make_strategy
        self.strategy = make_strategy(cfg.method, cfg)

    # ------------------------------------------------------------------
    def _train_device(self, k: int, w: Params) -> Tuple[Params, int]:
        idx = torch.from_numpy(np.asarray(self.partitions[k])).to(
            self.device)
        x, y = self.x_train[idx], self.y_train[idx]
        if self.cfg.method == "moon":
            return self._train_device_moon(k, w, x, y), len(idx)
        w_new, _, _ = local_update(
            w, x, y, self.task.loss, epochs=self.cfg.epochs,
            batch_size=self.cfg.batch_size, lr=self.cfg.lr, mu=self.cfg.mu,
            rng=self.rng)
        return w_new, len(idx)

    def _train_device_moon(self, k: int, w_glob: Params, x, y) -> Params:
        prev = self.prev_local.get(k, w_glob)
        params = moon_local_train(w_glob, prev, x, y, epochs=self.cfg.epochs,
                                  batch_size=self.cfg.batch_size,
                                  lr=self.cfg.lr, rng=self.rng,
                                  forward_fn=self.task.forward,
                                  features_fn=self.task.features)
        self.prev_local[k] = params
        return params

    def _round_latency(self, k: int, bits_down: float, bits_up: float,
                       n_batches: int) -> Tuple[float, float, float]:
        return self.devices.round_latency(k, bits_down, bits_up, n_batches,
                                          self.rng)

    def evaluate(self) -> float:
        """Test accuracy: the mean of the per-chunk accuracies over chunks
        of 2,000 samples."""
        xs, ys = self.x_test, self.y_test
        accs = []
        with torch.no_grad():
            for s in range(0, len(ys), 2000):
                accs.append(self.task.eval_metric(
                    self.server.w, xs[s:s + 2000], ys[s:s + 2000]))
        return float(np.mean([float(a) for a in torch.stack(accs).cpu()]))

    def _log(self, time: float):
        self.history.append(LogEntry(
            time, self.server.t, self.evaluate(), self.bytes_up,
            self.bytes_down, self.max_up, self.max_down))

    # ------------------------------------------------------------------
    def run(self, time_budget: float = 300.0, max_rounds: int = 10 ** 9,
            eval_every: int = 1) -> List[LogEntry]:
        if self.cfg.method in ("fedavg", "moon"):
            return self._run_fedavg(time_budget, max_rounds, eval_every)
        return self._run_async(time_budget, max_rounds, eval_every)

    def _async_alpha(self, staleness: int) -> float:
        """Per-method immediate-update mixing weight (async baselines)."""
        cfg = self.cfg
        if cfg.method == "port":       # unbounded staleness, harder decay
            return cfg.alpha * (staleness + 1.0) ** -1.0
        if cfg.method == "asofed":     # linear decay
            return cfg.alpha / (1.0 + staleness)
        stale = min(staleness, cfg.max_staleness)   # fedasync: capped poly
        return cfg.alpha * float(staleness_weight(stale, cfg.a))

    # -- asynchronous protocols (teasq family + fedasync) ----------------
    def _run_async(self, time_budget: float, max_rounds: int,
                   eval_every: int) -> List[LogEntry]:
        cfg = self.cfg
        events: List[Tuple[float, int, str, int, Any, int]] = []
        seq = 0

        def push(t, kind, k, payload=None, h=0):
            nonlocal seq
            heapq.heappush(events, (t, seq, kind, k, payload, h))
            seq += 1

        waiting: List[int] = []
        for k in range(cfg.n_devices):
            push(self.rng.uniform(0, 0.05), "request", k)

        self._log(0.0)
        fedasync = cfg.method in ("fedasync", "port", "asofed")

        now = 0.0   # the heap can be empty (n_devices=0) or the first pop
        while events:  # can exceed time_budget; the final log still needs now
            now, _, kind, k, payload, h = heapq.heappop(events)
            if now > time_budget or self.server.t >= max_rounds:
                break
            if kind == "request":
                grant = self.server.try_dispatch()
                if grant is None:
                    waiting.append(k)
                    continue
                w_t, t0 = grant
                codec = self.strategy.channel_for(t0, device_id=k)
                w_recv, nbytes_down = codec.roundtrip(w_t, rng=self.rng)
                self.bytes_down += nbytes_down
                self.max_down = max(self.max_down, nbytes_down)
                w_local, n_k = self._train_device(k, w_recv)
                w_up, nbytes_up = codec.roundtrip(w_local, rng=self.rng)
                self.bytes_up += nbytes_up
                self.max_up = max(self.max_up, nbytes_up)
                n_batches = max(1, n_k // cfg.batch_size)
                dl, cp, ul = self._round_latency(
                    k, nbytes_down * 8, nbytes_up * 8, n_batches)
                push(now + dl + cp + ul, "arrival", k, (w_up, n_k), t0)
            else:  # arrival
                w_local, n_k = payload
                # the codec policy's per-device staleness estimator (no-op
                # for the static policy; draws no RNG)
                self.strategy.policy.observe_arrival(
                    k, max(0, self.server.t - h))
                if fedasync:
                    self.server.active = max(0, self.server.active - 1)
                    a_t = self._async_alpha(self.server.t - h)
                    self.server.w = tree_map(
                        lambda wl, wg: a_t * wl + (1 - a_t) * wg,
                        w_local, self.server.w)
                    self.server.t += 1
                    done_round = True
                else:
                    done_round = self.server.receive(w_local, h, n_k)
                if done_round and self.server.t % eval_every == 0:
                    self._log(now)
                push(now, "request", k)
                # FIFO-equivalent to re-pushing the whole queue
                free = self.server.cfg.max_parallel - self.server.active
                for _ in range(min(free, len(waiting))):
                    push(now, "request", waiting.pop(0))
        self._log(min(now, time_budget))
        return self.history

    # -- synchronous FedAvg ----------------------------------------------
    def _run_fedavg(self, time_budget: float, max_rounds: int,
                    eval_every: int) -> List[LogEntry]:
        cfg = self.cfg
        now = 0.0
        self._log(now)
        per_round = min(cfg.devices_per_round, cfg.n_devices)
        identity = IdentityCodec()       # FedAvg/MOON ship dense f32
        while now < time_budget and self.server.t < max_rounds:
            sel = self.rng.choice(cfg.n_devices, per_round, replace=False)
            updates, weights, latencies = [], [], []
            for k in sel:
                nbytes = identity.wire_bytes(self.server.w)
                self.bytes_down += nbytes
                self.max_down = max(self.max_down, nbytes)
                w_local, n_k = self._train_device(k, self.server.w)
                self.bytes_up += nbytes
                self.max_up = max(self.max_up, nbytes)
                n_batches = max(1, n_k // cfg.batch_size)
                dl, cp, ul = self._round_latency(k, nbytes * 8, nbytes * 8,
                                                 n_batches)
                latencies.append(dl + cp + ul)
                updates.append(w_local)
                weights.append(n_k)
            wts = np.asarray(weights, np.float32)
            wts /= wts.sum()
            self.server.w = tree_map(
                lambda *ls: sum(float(w) * l for w, l in zip(wts, ls)),
                *updates)
            self.server.t += 1
            now += max(latencies)        # straggler-bound synchronous round
            if self.server.t % eval_every == 0:
                self._log(now)
        return self.history
