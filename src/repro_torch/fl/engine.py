"""Event-driven FL engine on a virtual clock (paper Algs. 1-2), in PyTorch.

* **Alg. 1, server side (Distributor)** -- ``FLEngine._handle_request``
  pops a device's task request off the event heap and admission-controls it
  through ``TeasqServer.try_dispatch`` (the C-fraction gate); rejected
  requests park in the waiting queue.
* **Alg. 1, device side (local prox-SGD, Eq. 5)** -- ``SerialTrainer`` runs
  ``repro_torch.core.client.local_update`` for one device at grant time.
* **Algs. 3-4 (wire compression)** -- every dispatch asks the strategy for
  a codec (``channel_for``) and runs ``codec.roundtrip`` down and up.  The
  engine passes its RNG, so both encodes round stochastically on the host,
  in the JAX package's draw order.
* **Alg. 2 (Receiver/Updater, Eqs. 6-10)** -- ``_handle_arrival`` hands the
  upload to the strategy, which feeds ``TeasqServer.receive``.

Everything random is numpy, drawn in the JAX package's order: device
rates and compute coefficients (``DeviceRegistry``), initial request
times, permutations of local SGD, stochastic rounding and latency draws.
Wire sizes depend on shapes only.  So the time, round and byte columns of
the ``LogEntry`` history equal the JAX engine's for the same inputs; only
accuracy moves with float arithmetic.

The model, the data and the aggregation live on the engine's device: the
card unless the caller names another.  This slice runs the heap scheduler
with the serial trainer and the single server; other settings raise.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.client import local_update
from repro_torch.core.latency import (comm_latency, device_rates,
                                      sample_compute_latency)
from repro_torch.core.server import ServerConfig, make_server
from repro_torch.fl.simulator import (LogEntry, ScenarioConfig, SimConfig,
                                      tier_assignment)
from repro_torch.fl.tasks import get_task
from repro_torch.utils.tree import Params, resolve_device


# ----------------------------------------------------------------------
# Device registry + channel accounting
# ----------------------------------------------------------------------
class DeviceRegistry:
    """Per-device simulation state: link rates, compute coefficients, tier
    assignment, and liveness.  Draws from the engine RNG in the JAX
    package's order (rates, then a_k)."""

    def __init__(self, cfg: SimConfig, rng: np.random.RandomState):
        n = cfg.n_devices
        self.cfg = cfg
        self.down_rates, self.up_rates = device_rates(n, cfg.wireless, rng)
        self.a_k = rng.uniform(cfg.compute.a_min, cfg.compute.a_max, n)
        self.phi_k = np.full(n, cfg.compute.phi)
        self.alive = np.ones(n, bool)
        self.tier = np.zeros(n, np.int64)

    def apply_tiers(self, tiers) -> None:
        """Scale latency per tier under the shared contiguous assignment."""
        self.tier = tier_assignment(len(self.alive), tiers)
        for i, t in enumerate(tiers):
            sel = self.tier == i
            self.a_k[sel] *= t.compute_scale
            self.down_rates[sel] *= t.bandwidth_scale
            self.up_rates[sel] *= t.bandwidth_scale

    def round_latency(self, k: int, bits_down: float, bits_up: float,
                      n_batches: int, rng: np.random.RandomState
                      ) -> Tuple[float, float, float]:
        cfg = self.cfg
        dl = comm_latency(bits_down, self.down_rates[k])
        ul = comm_latency(bits_up, self.up_rates[k])
        cp = sample_compute_latency(self.a_k[k], self.phi_k[k],
                                    tau_b=n_batches * cfg.epochs
                                    * 0.002 * cfg.batch_size, rng=rng)
        return dl, cp, ul


class ChannelMeter:
    """Cumulative and per-transfer-max byte accounting for both directions,
    with per-tier totals when the caller passes the device's tier."""

    def __init__(self):
        self.bytes_up = 0
        self.bytes_down = 0
        self.max_up = 0
        self.max_down = 0
        self.tier_up: Dict[int, int] = {}
        self.tier_down: Dict[int, int] = {}

    def down(self, nbytes: int, tier: Optional[int] = None) -> None:
        self.bytes_down += nbytes
        self.max_down = max(self.max_down, nbytes)
        if tier is not None:
            self.tier_down[tier] = self.tier_down.get(tier, 0) + nbytes

    def up(self, nbytes: int, tier: Optional[int] = None) -> None:
        self.bytes_up += nbytes
        self.max_up = max(self.max_up, nbytes)
        if tier is not None:
            self.tier_up[tier] = self.tier_up.get(tier, 0) + nbytes

    def down_tree(self, codec, tree: Params,
                  tier: Optional[int] = None) -> int:
        nbytes = codec.wire_bytes(tree)
        self.down(nbytes, tier)
        return nbytes


@dataclasses.dataclass
class EngineStats:
    dispatches: int = 0
    completions: int = 0
    dropouts: int = 0
    transient_failures: int = 0
    redispatched: int = 0
    completed_per_device: Optional[np.ndarray] = None


class SerialTrainer:
    """Trains one device at grant time, on the engine's device."""

    deferred = False

    def __init__(self, engine: "FLEngine"):
        self.engine = engine
        self._idx: Dict[int, torch.Tensor] = {}

    def train(self, k: int, w: Params) -> Tuple[Params, int]:
        eng = self.engine
        idx = self._idx.get(k)
        if idx is None:
            idx = torch.from_numpy(np.asarray(eng.partitions[k])).to(
                eng.device)
            self._idx[k] = idx
        w_new, _, _ = local_update(
            w, eng.x_train[idx], eng.y_train[idx], eng.task.loss,
            epochs=eng.cfg.epochs, batch_size=eng.cfg.batch_size,
            lr=eng.cfg.lr, mu=eng.cfg.mu, rng=eng.rng)
        return w_new, len(idx)


# ----------------------------------------------------------------------
# The engine
# ----------------------------------------------------------------------
class FLEngine:
    """Event-driven virtual-clock FL engine with pluggable protocol
    strategies.  With the same inputs and knobs it consumes the seeded RNG
    in the JAX ``FLEngine``'s order and logs the same event timeline."""

    def __init__(self, data: Dict[str, np.ndarray],
                 partitions: List[np.ndarray], w_init: Params,
                 cfg: SimConfig, strategy: Optional[Any] = None, *,
                 device=None):
        unsupported = {"scheduler": (cfg.scheduler, "heap"),
                       "cohort_size": (cfg.cohort_size, 0),
                       "handler_mode": (cfg.handler_mode, "serial")}
        for knob, (got, want) in unsupported.items():
            if got != want:
                raise NotImplementedError(
                    f"SimConfig.{knob}={got!r} is not ported yet: this "
                    f"slice runs {knob}={want!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.data = data
        self.partitions = partitions
        self.rng = np.random.RandomState(cfg.seed)
        n = cfg.n_devices
        assert len(partitions) == n
        self.devices = DeviceRegistry(cfg, self.rng)
        w_init = {k: v.to(self.device) for k, v in w_init.items()}
        self.server = make_server(cfg.server, w_init, ServerConfig(
            n, cfg.c_fraction, cfg.gamma, cfg.alpha, cfg.a),
            shards=cfg.server_shards)
        self.channel = ChannelMeter()
        self.task = get_task(cfg.task)
        self.history: List[LogEntry] = []
        self.stats = EngineStats(completed_per_device=np.zeros(n, np.int64))
        # the data lives on the device for the whole run
        self.x_train = torch.from_numpy(data["x_train"]).to(self.device)
        self.y_train = torch.from_numpy(data["y_train"]).to(self.device)
        self.x_test = torch.from_numpy(data["x_test"]).to(self.device)
        self.y_test = torch.from_numpy(data["y_test"]).to(self.device)

        if strategy is None:
            from repro_torch.fl.protocols import make_strategy
            strategy = make_strategy(cfg.method, cfg)
        if not strategy.event_driven:
            raise NotImplementedError(
                f"{cfg.method!r} runs the synchronous loop, which arrives "
                f"with the other-protocols slice")
        self.strategy = strategy

        self.scenario: Optional[ScenarioConfig] = cfg.scenario
        self.scenario_rng = np.random.RandomState(
            (cfg.seed + 0x5CE7A710) % (2 ** 31))
        if self.scenario is not None and self.scenario.tiers:
            self.devices.apply_tiers(self.scenario.tiers)

        self.trainer = SerialTrainer(self)
        self._started = False
        self._now = 0.0
        self._seq = 0
        self._events: List[Tuple] = []
        self._waiting: List[int] = []
        self._tail_logged = False

    # -- shared helpers ----------------------------------------------------
    def evaluate(self) -> float:
        """Test accuracy of the global model: the mean of the per-chunk
        accuracies over chunks of 2,000 samples, as the JAX engine logs it."""
        xs, ys = self.x_test, self.y_test
        accs = []
        with torch.no_grad():
            for s in range(0, len(ys), 2000):
                accs.append(self.task.eval_metric(
                    self.server.w, xs[s:s + 2000], ys[s:s + 2000]))
        return float(np.mean([float(a) for a in torch.stack(accs).cpu()]))

    def _log(self, time: float) -> None:
        self.history.append(LogEntry(
            time, self.server.t, self.evaluate(), self.channel.bytes_up,
            self.channel.bytes_down, self.channel.max_up,
            self.channel.max_down))

    # -- entry point -------------------------------------------------------
    def run(self, time_budget: float = 300.0, max_rounds: int = 10 ** 9,
            eval_every: int = 1) -> List[LogEntry]:
        """Run the event loop until the virtual clock passes
        ``time_budget`` or ``max_rounds`` aggregations are done; a later
        call resumes where this one stopped."""
        if self._tail_logged:             # drop the previous call's tail log
            self.history.pop()
            self._tail_logged = False
        if not self._started:
            for k in range(self.cfg.n_devices):
                self._push(self.rng.uniform(0, 0.05), "request", k)
            self._log(0.0)
            self._started = True
        events, waiting = self._events, self._waiting
        now = self._now
        while events:
            t_next = events[0][0]
            if t_next > time_budget or self.server.t >= max_rounds:
                now = t_next
                break
            now, _, kind, k, payload, h = heapq.heappop(events)
            if kind == "request":
                self._handle_request(now, k, waiting)
            elif kind == "failure":
                self._handle_failure(now, k, payload, waiting)
            else:
                self._handle_arrival(now, k, payload, h, eval_every, waiting)
        self._now = now
        self._log(min(now, time_budget))
        self._tail_logged = True
        return self.history

    def _push(self, t, kind, k, payload=None, h=0):
        heapq.heappush(self._events, (t, self._seq, kind, k, payload, h))
        self._seq += 1

    def _drain_waiting(self, now, waiting) -> None:
        free = self.server.cfg.max_parallel - self.server.active
        for _ in range(min(free, len(waiting))):
            self._push(now, "request", waiting.pop(0))

    def _handle_request(self, now, k, waiting) -> None:
        cfg = self.cfg
        if not self.devices.alive[k]:
            return
        grant = self.server.try_dispatch()
        if grant is None:
            waiting.append(k)
            return
        self.stats.dispatches += 1
        w_t, t0 = grant
        codec = self.strategy.channel_for(t0, device_id=k)
        tier = int(self.devices.tier[k])

        if self.scenario is not None and self.scenario.active:
            scen = self.scenario
            u = self.scenario_rng.random_sample()
            if u < scen.dropout_prob + scen.failure_prob:
                mode = "dropout" if u < scen.dropout_prob else "transient"
                nbytes_down = self.channel.down_tree(codec, w_t, tier)
                n_k = len(self.partitions[k])
                n_batches = max(1, n_k // cfg.batch_size)
                dl, cp, _ = self.devices.round_latency(
                    k, nbytes_down * 8, 0.0, n_batches, self.scenario_rng)
                fail_at = now + self.scenario_rng.uniform(0.0, dl + cp)
                self._push(fail_at, "failure", k, mode)
                return

        w_recv, nbytes_down = codec.roundtrip(w_t, rng=self.rng)
        self.channel.down(nbytes_down, tier)
        w_local, n_k = self.strategy.local_train(self, k, w_recv)
        w_up, nbytes_up = codec.roundtrip(w_local, rng=self.rng)
        self.channel.up(nbytes_up, tier)
        n_batches = max(1, n_k // cfg.batch_size)
        dl, cp, ul = self.devices.round_latency(
            k, nbytes_down * 8, nbytes_up * 8, n_batches, self.rng)
        self._push(now + dl + cp + ul, "arrival", k, (w_up, n_k), t0)

    def _handle_failure(self, now, k, mode, waiting) -> None:
        """Mid-round device loss: free the slot, re-dispatch the capacity to
        the waiting queue; transient failures retry after a backoff."""
        self.server.active = max(0, self.server.active - 1)
        if mode == "dropout":
            self.devices.alive[k] = False
            self.stats.dropouts += 1
        else:
            self.stats.transient_failures += 1
            self._push(now + self.scenario.retry_backoff, "request", k)
        if waiting:
            self.stats.redispatched += 1
        self._drain_waiting(now, waiting)

    def _handle_arrival(self, now, k, payload, h, eval_every,
                        waiting) -> None:
        self.strategy.policy.observe_arrival(k, max(0, self.server.t - h))
        done_round = self.strategy.on_arrival(self, now, k, payload, h)
        self.stats.completions += 1
        self.stats.completed_per_device[k] += 1
        if done_round and self.server.t % eval_every == 0:
            self._log(now)
        if self.devices.alive[k]:
            self._push(now, "request", k)
        self._drain_waiting(now, waiting)
