"""Event-driven FL engine on a virtual clock (paper Algs. 1-2), in PyTorch.

* **Alg. 1, server side (Distributor)** -- ``FLEngine._handle_request``
  pops a device's task request off the event heap and admission-controls it
  through ``TeasqServer.try_dispatch`` (the C-fraction gate); rejected
  requests park in the waiting queue.
* **Alg. 1, device side (local prox-SGD, Eq. 5)** -- the trainer layer:
  ``SerialTrainer`` runs ``repro_torch.core.client.local_update`` for one
  device at grant time; ``CohortTrainer`` (``SimConfig.cohort_size > 0``)
  defers training and runs whole cohorts of granted devices in one
  ``_cohort_round``: the threshold channel down (kernel B's channel form on
  the card), E epochs of prox-SGD on the task's vectorized ``cohort_loss``,
  the channel up.
* **Algs. 3-4 (wire compression)** -- every dispatch asks the strategy for
  a codec (``channel_for``).  The serial trainer runs ``codec.roundtrip``
  down and up; the engine passes its RNG, so stochastic encodes round on
  the host in the JAX package's draw order.  The cohort trainer prices
  both transfers from shapes alone at grant time and applies the channel
  at the codec's ``(p_s, p_q)`` inside the cohort round.
* **Alg. 2 (Receiver/Updater, Eqs. 6-10)** -- ``_handle_arrival`` hands the
  upload to the strategy, which resolves it (``resolve_payload``: a
  deferred task is trained at the latest here) and feeds the server.
* **Synchronous baselines (FedAvg, MOON)** -- ``_run_sync``: sample a round
  cohort, train each device on the dense model, merge, and advance the
  clock by the straggler's latency.

Everything random is numpy, drawn in the JAX package's order: device
rates and compute coefficients (``DeviceRegistry``), initial request
times, permutations of local SGD, stochastic rounding and latency draws.
Wire sizes depend on shapes only.  So the time, round and byte columns of
the ``LogEntry`` history equal the JAX engine's for the same inputs; only
accuracy moves with float arithmetic.

The model, the data and the aggregation live on the engine's device: the
card unless the caller names another.  The port runs the heap scheduler,
``handler_mode="serial"`` and the single server; the batched scheduler and
wave handlers arrive with ROADMAP.md Queue A item 4 and raise until then.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.client import local_update
from repro_torch.core.codecs import IdentityCodec
from repro_torch.core.latency import (comm_latency, device_rates,
                                      sample_compute_latency)
from repro_torch.core.server import ServerConfig, make_server
from repro_torch.fl.simulator import (LogEntry, ScenarioConfig, SimConfig,
                                      tier_assignment)
from repro_torch.fl.tasks import get_task
from repro_torch.kernels.ops import threshold_channel_leaves
from repro_torch.utils.tree import Params, resolve_device, unflatten


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

    def up_tree(self, codec, tree: Params,
                tier: Optional[int] = None) -> int:
        nbytes = codec.wire_bytes(tree)
        self.up(nbytes, tier)
        return nbytes


@dataclasses.dataclass
class EngineStats:
    dispatches: int = 0
    completions: int = 0
    dropouts: int = 0
    transient_failures: int = 0
    redispatched: int = 0
    flushes: int = 0
    flushed_tasks: int = 0
    completed_per_device: Optional[np.ndarray] = None


class SerialTrainer:
    """Trains one device at grant time, on the engine's device."""

    deferred = False

    def __init__(self, engine: "FLEngine"):
        self.engine = engine

    def train(self, k: int, w: Params) -> Tuple[Params, int]:
        eng = self.engine
        idx = eng.partition_index(k)
        w_new, _, _ = local_update(
            w, eng.x_train[idx], eng.y_train[idx], eng.task.loss,
            epochs=eng.cfg.epochs, batch_size=eng.cfg.batch_size,
            lr=eng.cfg.lr, mu=eng.cfg.mu, rng=eng.rng)
        return w_new, len(idx)


@dataclasses.dataclass
class PendingTask:
    """A granted-but-not-yet-trained task in the deferred cohort buffer."""
    k: int
    version: int          # index into the flush's global-model version list
    t0: int
    p_s: float
    p_q: int
    n_k: int
    bidx: np.ndarray      # (T, bs) minibatch sample indices
    result: Optional[Tuple[Params, int]] = None


def _channel(tree: Params, p_s: float, p_q: int, iters: int) -> Params:
    """The threshold channel on every row of a stacked dict: kernel B's
    channel form on the card, its plain version on the CPU."""
    names = sorted(tree)
    return unflatten(names, threshold_channel_leaves(
        [tree[k] for k in names], p_s, p_q, iters))


def _cohort_round(w_versions: Params, vidx: torch.Tensor, xs: torch.Tensor,
                  ys: torch.Tensor, didx: torch.Tensor, bidx: torch.Tensor,
                  valid: torch.Tensor, *, cohort_loss: Callable, lr: float,
                  mu: float, p_s: float, p_q: int, iters: int) -> Params:
    """One cohort round: the channel down (per model version), E epochs of
    prox-SGD for every device of the cohort on the task's ``cohort_loss``,
    the channel up.  Shapes: w_versions leaves (V, ...); vidx/didx (C,);
    xs/ys (N, n_max, ...); bidx (T, C, bs); valid (T, C), 0 on the steps a
    device does not take.  Returns the (C, ...) uploads."""
    w_recv = {k: v[vidx] for k, v in _channel(w_versions, p_s, p_q,
                                               iters).items()}
    xd, yd = xs[didx], ys[didx]
    rows = torch.arange(xd.shape[0], device=xd.device)[:, None]
    names = sorted(w_recv)
    anchor = [w_recv[k] for k in names]
    params = [a.clone() for a in anchor]
    for t in range(bidx.shape[0]):
        idx = bidx[t]                                   # (C, bs)
        for p in params:
            p.requires_grad_(True)
        loss = cohort_loss(unflatten(names, params), xd[rows, idx],
                           yd[rows, idx])
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            v = valid[t]
            params = [p - v.reshape((-1,) + (1,) * (p.dim() - 1)) * lr
                      * (g + mu * (p - a))
                      for p, g, a in zip(params, grads, anchor)]
    return _channel(unflatten(names, [p.detach() for p in params]), p_s,
                    p_q, iters)


def _zero_step_round(w_versions: Params, *, p_s: float, p_q: int,
                     iters: int) -> Params:
    """Wave-mode cohort fast path for groups with ZERO local steps: with no
    SGD step the up-channel's input is the down-channel's output, so the
    result is the channel applied twice to each of the V versions."""
    return _channel(_channel(w_versions, p_s, p_q, iters), p_s, p_q, iters)


class CohortTrainer:
    """Deferred vectorized execution: granted tasks buffer up and whole
    cohorts train in one :func:`_cohort_round`, padded to two cohort
    buckets and a power-of-two step count (the JAX package's shapes, so the
    same numbers come out: the cohort loss is a mean over the padded
    cohort).  Device data is stacked once on the engine's device; minibatch
    permutations come from a dedicated RNG, drawn in the JAX package's
    order."""

    deferred = True

    def __init__(self, engine: "FLEngine", cohort_size: int,
                 channel_iters: int = 12):
        self.engine = engine
        self.cohort_size = max(1, cohort_size)
        self.channel_iters = channel_iters
        self.perm_rng = np.random.RandomState(engine.cfg.seed + 0x9E3779)
        self._serial = SerialTrainer(engine)   # sync-loop fallback
        self.pending: List[PendingTask] = []
        self._versions: List[Params] = []
        self._version_ids: Dict[int, int] = {}
        parts = engine.partitions
        n_max = max(len(idx) for idx in parts)
        x = engine.data["x_train"]
        xs = np.zeros((len(parts), n_max) + x.shape[1:], x.dtype)
        ys = np.zeros((len(parts), n_max), np.int64)
        for k, idx in enumerate(parts):
            xs[k, :len(idx)] = x[idx]
            ys[k, :len(idx)] = engine.data["y_train"][idx]
        self.xs = torch.from_numpy(xs).to(engine.device)
        self.ys = torch.from_numpy(ys).to(engine.device)
        # two padded cohort buckets: full cohorts and a small one for tail
        # flushes
        self.buckets = sorted({max(1, self.cohort_size // 4),
                               self.cohort_size})

    # -- sync-loop fallback -------------------------------------------------
    def train(self, k: int, w: Params) -> Tuple[Params, int]:
        return self._serial.train(k, w)

    # -- deferred protocol --------------------------------------------------
    def _version_of(self, w: Params) -> int:
        vid = self._version_ids.get(id(w))
        if vid is None:
            vid = len(self._versions)
            self._versions.append(w)       # keeps the ref alive => id stable
            self._version_ids[id(w)] = vid
        return vid

    def submit(self, k: int, w_t: Params, t0: int, p_s: float,
               p_q: int) -> PendingTask:
        cfg = self.engine.cfg
        n_k = len(self.engine.partitions[k])
        bs = cfg.batch_size
        steps = (n_k - bs) // bs + 1 if n_k >= bs else 0
        rows = []
        for _ in range(cfg.epochs):
            order = self.perm_rng.permutation(n_k)
            for s in range(steps):
                rows.append(order[s * bs:(s + 1) * bs])
        bidx = (np.asarray(rows, np.int64) if rows
                else np.zeros((0, bs), np.int64))
        task = PendingTask(k, self._version_of(w_t), t0, p_s, p_q, n_k, bidx)
        self.pending.append(task)
        if len(self.pending) >= self.cohort_size:
            self.flush()
        return task

    def result(self, task: PendingTask) -> Tuple[Params, int]:
        if task.result is None:
            self.flush()
        assert task.result is not None
        return task.result

    @staticmethod
    def _pad_pow2(n: int) -> int:
        p = 1
        while p < n:
            p *= 2
        return p

    def flush(self) -> None:
        tasks, self.pending = self.pending, []
        versions, self._versions = self._versions, []
        self._version_ids = {}
        if not tasks:
            return
        groups: Dict[Tuple[float, int], List[PendingTask]] = {}
        for t in tasks:
            groups.setdefault((t.p_s, t.p_q), []).append(t)
        # the V distinct versions only: the JAX package pads V to a power
        # of two with copies of the first, which change no result
        w_versions = {k: torch.stack([w[k] for w in versions])
                      for k in versions[0]}
        for (p_s, p_q), group in groups.items():
            self._flush_group(group, w_versions, p_s, p_q)
        self.engine.stats.flushes += 1
        self.engine.stats.flushed_tasks += len(tasks)

    def _flush_group(self, group: List[PendingTask], w_versions: Params,
                     p_s: float, p_q: int) -> None:
        cfg = self.engine.cfg
        c = len(group)
        c_pad = next(b for b in self.buckets if b >= c) if \
            c <= self.buckets[-1] else c
        # the step count padded to a power of two too (valid=0 masks it)
        t_max = max(t.bidx.shape[0] for t in group)
        t_max = self._pad_pow2(t_max) if t_max else 0
        if t_max == 0 and cfg.handler_mode == "wave":
            w_up_v = _zero_step_round(w_versions, p_s=p_s, p_q=p_q,
                                      iters=self.channel_iters)
            for t in group:
                t.result = ({k: a[t.version] for k, a in w_up_v.items()},
                            t.n_k)
            return
        bs = cfg.batch_size
        bidx = np.zeros((c_pad, t_max, bs), np.int64)
        valid = np.zeros((c_pad, t_max), np.float32)
        vidx = np.zeros(c_pad, np.int64)
        didx = np.zeros(c_pad, np.int64)
        for i, t in enumerate(group):
            ti = t.bidx.shape[0]
            bidx[i, :ti] = t.bidx
            valid[i, :ti] = 1.0
            vidx[i] = t.version
            didx[i] = t.k
        dev = self.engine.device
        w_up = _cohort_round(
            w_versions, torch.from_numpy(vidx).to(dev), self.xs, self.ys,
            torch.from_numpy(didx).to(dev),
            torch.from_numpy(np.ascontiguousarray(
                np.swapaxes(bidx, 0, 1))).to(dev),
            torch.from_numpy(np.ascontiguousarray(
                np.swapaxes(valid, 0, 1))).to(dev),
            cohort_loss=self.engine.task.cohort_loss, lr=cfg.lr, mu=cfg.mu,
            p_s=p_s, p_q=p_q, iters=self.channel_iters)
        # per-task results: views of the stacked output, on the device
        for i, t in enumerate(group):
            t.result = ({k: a[i] for k, a in w_up.items()}, t.n_k)


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
                       "handler_mode": (cfg.handler_mode, "serial")}
        for knob, (got, want) in unsupported.items():
            if got != want:
                raise NotImplementedError(
                    f"SimConfig.{knob}={got!r} is not ported yet: it "
                    f"arrives with ROADMAP.md Queue A item 4 (the batched "
                    f"engine and wave handlers); the port runs "
                    f"{knob}={want!r}")
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
        self.prev_local: Dict[int, Params] = {}      # MOON per-device state
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
        self.strategy = strategy

        self.scenario: Optional[ScenarioConfig] = cfg.scenario
        self.scenario_rng = np.random.RandomState(
            (cfg.seed + 0x5CE7A710) % (2 ** 31))
        if self.scenario is not None and self.scenario.tiers:
            self.devices.apply_tiers(self.scenario.tiers)

        self.trainer = (CohortTrainer(self, cfg.cohort_size,
                                      cfg.cohort_channel_iters)
                        if cfg.cohort_size > 0 else SerialTrainer(self))
        self._started = False
        self._now = 0.0
        self._seq = 0
        self._events: List[Tuple] = []
        self._waiting: List[int] = []
        self._tail_logged = False
        self._sync_now = 0.0
        self._part_idx: Dict[int, torch.Tensor] = {}

    # -- shared helpers ----------------------------------------------------
    def partition_index(self, k: int) -> torch.Tensor:
        """Device ``k``'s sample indices, on the engine's device."""
        idx = self._part_idx.get(int(k))
        if idx is None:
            idx = torch.from_numpy(np.asarray(self.partitions[k])).to(
                self.device)
            self._part_idx[int(k)] = idx
        return idx

    def resolve_payload(self, payload: Any) -> Tuple[Params, int]:
        """(w_local, n_k) from either an eager tuple or a PendingTask."""
        if isinstance(payload, PendingTask):
            return self.trainer.result(payload)
        return payload

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
        """Run until the virtual clock passes ``time_budget`` or
        ``max_rounds`` aggregations are done; a later call resumes where
        this one stopped.  Event-driven protocols run the event loop, the
        synchronous ones (FedAvg, MOON) ``_run_sync``."""
        if not self.strategy.event_driven:
            return self._run_sync(time_budget, max_rounds, eval_every)
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

        if self.trainer.deferred:
            # priced from shapes and scheduled now, trained at the flush
            nbytes_down = self.channel.down_tree(codec, w_t, tier)
            task = self.trainer.submit(k, w_t, t0, codec.p_s, codec.p_q)
            # same tree shapes and (p_s, p_q) => nbytes_up == nbytes_down
            nbytes_up = self.channel.up_tree(codec, w_t, tier)
            n_batches = max(1, task.n_k // cfg.batch_size)
            dl, cp, ul = self.devices.round_latency(
                k, nbytes_down * 8, nbytes_up * 8, n_batches, self.rng)
            self._push(now + dl + cp + ul, "arrival", k, task, t0)
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

    # -- synchronous loop (FedAvg / MOON) ----------------------------------
    def _run_sync(self, time_budget: float, max_rounds: int,
                  eval_every: int) -> List[LogEntry]:
        cfg = self.cfg
        now = self._sync_now
        if not self._started:
            self._log(now)
            self._started = True
        per_round = min(cfg.devices_per_round, cfg.n_devices)
        identity = IdentityCodec()       # FedAvg/MOON ship dense f32
        while now < time_budget and self.server.t < max_rounds:
            sel = self.rng.choice(cfg.n_devices, per_round, replace=False)
            updates, weights, latencies = [], [], []
            for k in sel:
                tier = int(self.devices.tier[k])
                nbytes = self.channel.down_tree(identity, self.server.w,
                                                tier)
                w_local, n_k = self.strategy.local_train(self, int(k),
                                                         self.server.w)
                self.channel.up(nbytes, tier)
                n_batches = max(1, n_k // cfg.batch_size)
                dl, cp, ul = self.devices.round_latency(
                    k, nbytes * 8, nbytes * 8, n_batches, self.rng)
                latencies.append(dl + cp + ul)
                updates.append(w_local)
                weights.append(n_k)
            self.server.w = self.strategy.aggregate(self, updates, weights)
            self.server.t += 1
            now += max(latencies)        # straggler-bound synchronous round
            if self.server.t % eval_every == 0:
                self._log(now)
        self._sync_now = now
        return self.history
