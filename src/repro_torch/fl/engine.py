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
card unless the caller names another.  The event loop itself is host
numpy.

Two schedulers drive the Alg. 1-2 event loop (``SimConfig.scheduler``,
registry :data:`SCHEDULERS`):

* ``"heap"`` -- :class:`FLEngine`, one ``heappop`` at a time.
* ``"batched"`` -- :class:`BatchedEngine`: per-device next-event state in
  resident arrays (:class:`EventTable`), the next K events selected in one
  numpy call in the heap's exact ``(time, seq)`` order, so with
  ``handler_mode="serial"`` its histories equal the heap's bit for bit.
  ``handler_mode="wave"`` processes each same-kind run of a batch as one
  vectorized wave (grant waves, arrival waves through the stacked
  Eqs. 6-10 kernel), under the JAX package's relaxed-parity contract (see
  the class docstring); in the zero-step regime a cohort flush is kernel
  B's channel form applied twice to each model version
  (:func:`_zero_step_round`).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.client import local_update
from repro_torch.core.codecs import IdentityCodec
from repro_torch.core.latency import (comm_latency, comm_latency_batch,
                                      device_rates, sample_compute_latency,
                                      sample_compute_latency_batch)
from repro_torch.core.server import ServerConfig, make_server
from repro_torch.fl.simulator import (LogEntry, ScenarioConfig, SimConfig,
                                      tier_assignment)
from repro_torch.fl.tasks import get_task
from repro_torch.kernels.ops import threshold_channel_leaves
from repro_torch.utils.tree import (Params, leaves, paths, resolve_device,
                                    tree_map, tree_stack, unflatten)


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
        self.events: Optional[EventTable] = None   # batched scheduler only

    def event_table(self) -> "EventTable":
        """The resident per-device next-event arrays (allocated on first
        use: only the batched scheduler needs them)."""
        if self.events is None:
            self.events = EventTable(len(self.alive))
        return self.events

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

    def round_latency_batch(self, ks: np.ndarray, bits_down, bits_up,
                            n_batches: np.ndarray,
                            rng: np.random.RandomState
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``round_latency`` over a grant wave: the same float64
        arithmetic, one ``rng.exponential(size=G)`` draw.  Wave callers
        pass ``ks`` in ascending device-id order, so draw i belongs to the
        i-th lowest device id of the wave."""
        cfg = self.cfg
        dl = comm_latency_batch(bits_down, self.down_rates[ks])
        ul = comm_latency_batch(bits_up, self.up_rates[ks])
        tau_b = (np.asarray(n_batches, np.float64) * cfg.epochs
                 * 0.002 * cfg.batch_size)
        cp = sample_compute_latency_batch(self.a_k[ks], self.phi_k[ks],
                                          tau_b, rng)
        return dl, cp, ul


# Event kinds, shared by both schedulers: the heap path stores the name in
# its event tuples, the batched path the id in its resident arrays.
KIND_NAMES = ("request", "arrival", "failure")
KIND_IDS = {name: i for i, name in enumerate(KIND_NAMES)}


class EventTable:
    """Resident next-event state of the batched scheduler, one slot per
    device.  Every device has at most one outstanding event (its request,
    its in-flight arrival, or a failure/retry), and events are never
    cancelled, so the device id is the slot key and the whole queue is a
    set of aligned per-device arrays (``time`` is +inf while a slot is
    empty).  ``select_batch`` picks the next <= ``k_max`` events in exact
    ``(time, seq)`` heap order, ties at the k-th time all included, so a
    batch boundary never splits a group of same-time events."""

    def __init__(self, n: int):
        self.time = np.full(n, np.inf)
        self.seq = np.zeros(n, np.int64)
        self.kind = np.zeros(n, np.int8)
        self.h = np.zeros(n, np.int64)
        # the FL job of an event: 0 for a single-task engine
        self.task = np.zeros(n, np.int32)
        self.payload: List[Any] = [None] * n

    def put(self, k: int, t: float, seq: int, kind: str, payload: Any,
            h: int, task: int = 0) -> None:
        assert self.time[k] == np.inf, \
            f"device {k} already has a scheduled event"
        self.time[k] = t
        self.seq[k] = seq
        self.kind[k] = KIND_IDS[kind]
        self.h[k] = h
        self.task[k] = task
        self.payload[k] = payload

    def clear(self, k: int) -> None:
        self.time[k] = np.inf
        self.payload[k] = None

    def put_wave(self, ks: np.ndarray, ts: np.ndarray, seqs: np.ndarray,
                 kind: str, payloads, h, task: int = 0) -> None:
        """``put`` for a wave of same-kind events, one scatter per array;
        ``h`` and ``task`` are shared by the wave."""
        assert np.all(self.time[ks] == np.inf), \
            "a wave member already has a scheduled event"
        self.time[ks] = ts
        self.seq[ks] = seqs
        self.kind[ks] = KIND_IDS[kind]
        self.h[ks] = h
        self.task[ks] = task
        if payloads is None:
            return
        pl = self.payload
        for k, p in zip(ks.tolist(), payloads):
            pl[k] = p

    def clear_wave(self, ks: np.ndarray) -> None:
        self.time[ks] = np.inf
        pl = self.payload
        for k in ks.tolist():
            pl[k] = None

    def select_batch(self, k_max: int) -> np.ndarray:
        """Device ids of the next <= ``k_max`` scheduled events (plus any
        events tied with the k-th time), in ``(time, seq)`` order."""
        times = self.time
        finite = times < np.inf
        n_live = int(finite.sum())
        if n_live == 0:
            return np.empty(0, np.int64)
        if n_live > k_max:
            kth = np.partition(times, k_max - 1)[k_max - 1]
            cand = np.flatnonzero(times <= kth)
        else:
            cand = np.flatnonzero(finite)
        return cand[np.lexsort((self.seq[cand], times[cand]))]


class _FifoWaiting:
    """FIFO waiting queue with O(1) pops, call-compatible with the heap
    path's plain list (``append`` / ``pop(0)`` / ``len``): a pop advances a
    head cursor instead of shifting the buffer, which matters when most of
    a large fleet parks behind the admission gate."""

    __slots__ = ("_items", "_head")

    def __init__(self):
        self._items: List[int] = []
        self._head = 0

    def __len__(self) -> int:
        return len(self._items) - self._head

    def append(self, k: int) -> None:
        self._items.append(k)

    def pop(self, i: int = 0) -> int:
        assert i == 0, "the waiting queue is FIFO-only"
        k = self._items[self._head]
        self._head += 1
        self._maybe_compact()
        return k

    def extend(self, ks) -> None:
        """Park a whole wave behind the admission gate in one call."""
        self._items.extend(ks)

    def pop_many(self, g: int) -> List[int]:
        """Pop up to ``g`` waiters as one slice (the wave-grant drain)."""
        h = self._head
        out = self._items[h:h + g]
        self._head = h + len(out)
        self._maybe_compact()
        return out

    def _maybe_compact(self) -> None:
        if self._head > 1024 and self._head * 2 >= len(self._items):
            del self._items[:self._head]
            self._head = 0


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

    # -- wave accounting: one call per grant wave.  Integer-exact: the
    # bincount sums int64 byte counts as float64 (exact below 2^53) and
    # converts back per tier, so the totals equal G scalar calls.
    def _wave(self, nbytes: np.ndarray, tiers: np.ndarray,
              tier_tot: Dict[int, int]) -> Tuple[int, int]:
        sums = np.bincount(tiers, weights=nbytes)
        for t in np.flatnonzero(sums).tolist():
            tier_tot[t] = tier_tot.get(t, 0) + int(sums[t])
        return int(nbytes.sum()), int(nbytes.max())

    def down_wave(self, nbytes: np.ndarray, tiers: np.ndarray) -> None:
        if not len(nbytes):
            return
        tot, mx = self._wave(nbytes, tiers, self.tier_down)
        self.bytes_down += tot
        self.max_down = max(self.max_down, mx)

    def up_wave(self, nbytes: np.ndarray, tiers: np.ndarray) -> None:
        if not len(nbytes):
            return
        tot, mx = self._wave(nbytes, tiers, self.tier_up)
        self.bytes_up += tot
        self.max_up = max(self.max_up, mx)


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
    return unflatten(paths(tree), threshold_channel_leaves(
        leaves(tree), p_s, p_q, iters))


def _cohort_round(w_versions: Params, vidx: torch.Tensor, xs: torch.Tensor,
                  ys: torch.Tensor, didx: torch.Tensor, bidx: torch.Tensor,
                  valid: torch.Tensor, *, cohort_loss: Callable, lr: float,
                  mu: float, p_s: float, p_q: int, iters: int) -> Params:
    """One cohort round: the channel down (per model version), E epochs of
    prox-SGD for every device of the cohort on the task's ``cohort_loss``,
    the channel up.  Shapes: w_versions leaves (V, ...); vidx/didx (C,);
    xs/ys (N, n_max, ...); bidx (T, C, bs); valid (T, C), 0 on the steps a
    device does not take.  Returns the (C, ...) uploads."""
    w_recv = tree_map(lambda v: v[vidx], _channel(w_versions, p_s, p_q,
                                                   iters))
    xd, yd = xs[didx], ys[didx]
    rows = torch.arange(xd.shape[0], device=xd.device)[:, None]
    names = paths(w_recv)
    anchor = leaves(w_recv)
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
        w_versions = tree_stack(versions)
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
            # no local step: the result is a function of the version alone
            # (gated to wave mode, as in the JAX package); one set of views
            # per version, shared by its tasks
            w_up_v = _zero_step_round(w_versions, p_s=p_s, p_q=p_q,
                                      iters=self.channel_iters)
            per_version: Dict[int, Params] = {}
            for t in group:
                w = per_version.get(t.version)
                if w is None:
                    w = per_version[t.version] = tree_map(
                        lambda a: a[t.version], w_up_v)
                t.result = (w, t.n_k)
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
            t.result = (tree_map(lambda a: a[i], w_up), t.n_k)


# ----------------------------------------------------------------------
# Checkpoint helpers (engine and fleet state_dict/load_state)
# ----------------------------------------------------------------------
def _pack_rng(rng: np.random.RandomState) -> List[Any]:
    name, keys, pos, has_gauss, cached = rng.get_state()
    return [name, np.asarray(keys), int(pos), int(has_gauss), float(cached)]


def _load_rng(rng: np.random.RandomState, packed) -> None:
    rng.set_state((packed[0], np.asarray(packed[1], np.uint32),
                   int(packed[2]), int(packed[3]), float(packed[4])))


def _pack_devices(dv: DeviceRegistry) -> Dict[str, np.ndarray]:
    return {"down_rates": np.asarray(dv.down_rates),
            "up_rates": np.asarray(dv.up_rates), "a_k": np.asarray(dv.a_k),
            "phi_k": np.asarray(dv.phi_k), "alive": np.asarray(dv.alive),
            "tier": np.asarray(dv.tier)}


def _load_devices(dv: DeviceRegistry, d) -> None:
    dv.down_rates[:] = np.asarray(d["down_rates"])
    dv.up_rates[:] = np.asarray(d["up_rates"])
    dv.a_k[:] = np.asarray(d["a_k"])
    dv.phi_k[:] = np.asarray(d["phi_k"])
    dv.alive[:] = np.asarray(d["alive"], bool)
    dv.tier[:] = np.asarray(d["tier"])


def _trees_equal(a: Params, b: Params) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


# ----------------------------------------------------------------------
# The engine
# ----------------------------------------------------------------------
class FLEngine:
    """Event-driven virtual-clock FL engine with pluggable protocol
    strategies.  With the same inputs and knobs it consumes the seeded RNG
    in the JAX ``FLEngine``'s order and logs the same event timeline."""

    supports_wave = False   # handler_mode="wave" needs the batched arrays

    def __init__(self, data: Dict[str, np.ndarray],
                 partitions: List[np.ndarray], w_init: Params,
                 cfg: SimConfig, strategy: Optional[Any] = None, *,
                 device=None, rng: Optional[np.random.RandomState] = None,
                 devices: Optional[DeviceRegistry] = None,
                 scenario_rng: Optional[np.random.RandomState] = None):
        """``rng`` / ``devices`` / ``scenario_rng`` let a multi-task fleet
        (``repro_torch.fl.fleet.MultiTaskEngine``) share one seeded RNG
        stream, one :class:`DeviceRegistry` and one scenario stream across
        its per-task engines; with a registry injected the fleet owns the
        tiers and the event loop, and this engine is a per-task runtime
        whose handlers the fleet drives.  Standalone construction (the
        default) draws the RNG in the JAX engine's order."""
        if cfg.handler_mode not in ("serial", "wave"):
            raise ValueError(
                f"unknown handler_mode {cfg.handler_mode!r}; "
                "expected 'serial' or 'wave'")
        if cfg.handler_mode == "wave" and not self.supports_wave:
            raise ValueError(
                "handler_mode='wave' needs the batched scheduler "
                "(SimConfig.scheduler='batched')")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.data = data
        self.partitions = partitions
        self.shared_fleet = devices is not None
        self.rng = np.random.RandomState(cfg.seed) if rng is None else rng
        n = cfg.n_devices
        assert len(partitions) == n
        # per-device partition sizes, resident for the wave handlers
        self.part_sizes = np.asarray([len(p) for p in partitions], np.int64)
        self.devices = (DeviceRegistry(cfg, self.rng) if devices is None
                        else devices)
        w_init = tree_map(lambda v: v.to(self.device), w_init)
        self._names = paths(w_init)      # the checkpoints' leaf order
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
        self.scenario_rng = (np.random.RandomState(
            (cfg.seed + 0x5CE7A710) % (2 ** 31))
            if scenario_rng is None else scenario_rng)
        if (not self.shared_fleet and self.scenario is not None
                and self.scenario.tiers):
            self.devices.apply_tiers(self.scenario.tiers)

        self.trainer = (CohortTrainer(self, cfg.cohort_size,
                                      cfg.cohort_channel_iters)
                        if cfg.cohort_size > 0 else SerialTrainer(self))
        # resumable-loop state: ``run`` picks up where the last call stopped
        self._started = False
        self._now = 0.0
        self._seq = 0
        self._events: Optional[List[Tuple]] = None     # heap scheduler
        self._waiting: Optional[Any] = None
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
        return self._run_async(time_budget, max_rounds, eval_every)

    # -- asynchronous event loop (Algs. 1-2) -------------------------------
    def _resume(self) -> None:
        """Drop the previous ``run`` call's trailing budget log, so that
        ``run(t)`` then ``run(T)`` gives ``run(T)``'s history."""
        if self._tail_logged:
            self.history.pop()
            self._tail_logged = False

    def _push(self, t, kind, k, payload=None, h=0):
        heapq.heappush(self._events, (t, self._seq, kind, k, payload, h))
        self._seq += 1

    def _run_async(self, time_budget: float, max_rounds: int,
                   eval_every: int) -> List[LogEntry]:
        self._resume()
        if not self._started:
            self._events = []
            self._waiting = []
            for k in range(self.cfg.n_devices):
                self._push(self.rng.uniform(0, 0.05), "request", k)
            self._log(0.0)
            self._started = True
        events, waiting, push = self._events, self._waiting, self._push
        now = self._now
        while events:
            # peek: a stop leaves the boundary event queued for a later call
            t_next = events[0][0]
            if t_next > time_budget or self.server.t >= max_rounds:
                now = t_next
                break
            now, _, kind, k, payload, h = heapq.heappop(events)
            if kind == "request":
                self._handle_request(now, k, push, waiting)
            elif kind == "failure":
                self._handle_failure(now, k, payload, push, waiting)
            else:
                self._handle_arrival(now, k, payload, h, eval_every, push,
                                     waiting)
        self._now = now
        self._log(min(now, time_budget))
        self._tail_logged = True
        return self.history

    def _drain_waiting(self, now, push, waiting) -> None:
        # re-issue at most free-slot many waiting requests
        free = self.server.cfg.max_parallel - self.server.active
        for _ in range(min(free, len(waiting))):
            push(now, "request", waiting.pop(0))

    def _handle_request(self, now, k, push, waiting) -> None:
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
                push(fail_at, "failure", k, mode)
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
            push(now + dl + cp + ul, "arrival", k, task, t0)
            return

        w_recv, nbytes_down = codec.roundtrip(w_t, rng=self.rng)
        self.channel.down(nbytes_down, tier)
        w_local, n_k = self.strategy.local_train(self, k, w_recv)
        w_up, nbytes_up = codec.roundtrip(w_local, rng=self.rng)
        self.channel.up(nbytes_up, tier)
        n_batches = max(1, n_k // cfg.batch_size)
        dl, cp, ul = self.devices.round_latency(
            k, nbytes_down * 8, nbytes_up * 8, n_batches, self.rng)
        push(now + dl + cp + ul, "arrival", k, (w_up, n_k), t0)

    def _handle_failure(self, now, k, mode, push, waiting) -> None:
        """Mid-round device loss: free the slot, re-dispatch the capacity to
        the waiting queue; transient failures retry after a backoff."""
        self.server.active = max(0, self.server.active - 1)
        if mode == "dropout":
            self.devices.alive[k] = False
            self.stats.dropouts += 1
        else:
            self.stats.transient_failures += 1
            push(now + self.scenario.retry_backoff, "request", k)
        if waiting:
            self.stats.redispatched += 1
        self._drain_waiting(now, push, waiting)

    def _handle_arrival(self, now, k, payload, h, eval_every, push,
                        waiting) -> None:
        self.strategy.policy.observe_arrival(k, max(0, self.server.t - h))
        done_round = self.strategy.on_arrival(self, now, k, payload, h)
        self.stats.completions += 1
        self.stats.completed_per_device[k] += 1
        if done_round and self.server.t % eval_every == 0:
            self._log(now)
        if self.devices.alive[k]:
            push(now, "request", k)
        self._drain_waiting(now, push, waiting)

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

    # -- checkpoint/resume -------------------------------------------------
    # The state is a plain nested structure of dicts, lists, scalars and
    # numpy arrays, in the JAX engine's layout (``checkpoint.io.save_blob``
    # writes it, and either package's engine loads the other's).  A model
    # is a flat leaf list in ``jax.tree.leaves`` order (sorted keys at
    # every level), copied to the host; loading puts it back on the
    # engine's device under the key paths of ``w_init``,
    # so a restored engine is built over the same (data, partitions,
    # w_init, cfg).  A ``PendingTask`` can be held by the cohort buffer and
    # by an in-flight event at once: the registry ``reg = (id -> index,
    # list)`` keeps that sharing across the round trip, which is what keeps
    # a resumed run bit-identical.

    def _pack_tree(self, tree: Params) -> List[np.ndarray]:
        return [v.detach().to("cpu", copy=True).numpy()
                for v in leaves(tree)]

    def _unpack_tree(self, packed) -> Params:
        return unflatten(self._names, [
            torch.from_numpy(np.array(v)).to(self.device) for v in packed])

    @staticmethod
    def _intern(p: PendingTask, reg) -> int:
        """``p``'s index in the registry, added on first sight."""
        idx, pts = reg
        i = idx.get(id(p))
        if i is None:
            i = idx[id(p)] = len(pts)
            pts.append(p)
        return i

    def _pack_payload(self, payload: Any, reg) -> List[Any]:
        if payload is None:
            return ["none"]
        if isinstance(payload, str):         # failure mode tag
            return ["str", payload]
        if isinstance(payload, PendingTask):
            return ["pending", self._intern(payload, reg)]
        w_up, n_k = payload                  # eager (w_local, n_k) tuple
        return ["tree", self._pack_tree(w_up), int(n_k)]

    def _unpack_payload(self, packed, pts: List[PendingTask]) -> Any:
        tag = packed[0]
        if tag == "none":
            return None
        if tag == "str":
            return packed[1]
        if tag == "pending":
            return pts[int(packed[1])]
        return self._unpack_tree(packed[1]), int(packed[2])

    def _pack_pending(self, reg) -> List[Any]:
        # bidx as int32, the JAX engine's dtype
        return [[int(p.k), int(p.version), int(p.t0), float(p.p_s),
                 int(p.p_q), int(p.n_k), np.asarray(p.bidx, np.int32),
                 None if p.result is None
                 else [self._pack_tree(p.result[0]), int(p.result[1])]]
                for p in reg[1]]

    def _unpack_pending(self, packed) -> List[PendingTask]:
        pts = []
        for k, version, t0, p_s, p_q, n_k, bidx, result in packed:
            p = PendingTask(int(k), int(version), int(t0), float(p_s),
                            int(p_q), int(n_k), np.asarray(bidx, np.int64))
            if result is not None:
                p.result = (self._unpack_tree(result[0]), int(result[1]))
            pts.append(p)
        return pts

    def _core_state(self, reg) -> Dict[str, Any]:
        """Per-task state: all but the pieces a fleet shares (the RNG
        streams, the DeviceRegistry, the event queue), which it saves once."""
        srv, ch, st = self.server, self.channel, self.stats
        core = {
            "server": {"w": self._pack_tree(srv.w), "t": int(srv.t),
                       "active": int(srv.active),
                       "cache": [[self._pack_tree(w), int(h), int(n)]
                                 for w, h, n in srv.cache]},
            "strategy": self.strategy.state_dict(),
            "prev_local": [[int(k), self._pack_tree(w)]
                           for k, w in self.prev_local.items()],
            "channel": {"bytes_up": int(ch.bytes_up),
                        "bytes_down": int(ch.bytes_down),
                        "max_up": int(ch.max_up),
                        "max_down": int(ch.max_down),
                        "tier_up": [[int(t), int(b)]
                                    for t, b in ch.tier_up.items()],
                        "tier_down": [[int(t), int(b)]
                                      for t, b in ch.tier_down.items()]},
            "history": [[float(e.time), int(e.round), float(e.accuracy),
                         int(e.bytes_up), int(e.bytes_down),
                         int(e.max_model_bytes_up),
                         int(e.max_model_bytes_down)]
                        for e in self.history],
            "stats": {"dispatches": int(st.dispatches),
                      "completions": int(st.completions),
                      "dropouts": int(st.dropouts),
                      "transient_failures": int(st.transient_failures),
                      "redispatched": int(st.redispatched),
                      "flushes": int(st.flushes),
                      "flushed_tasks": int(st.flushed_tasks),
                      "completed_per_device":
                      np.asarray(st.completed_per_device)},
            "tail_logged": bool(self._tail_logged),
            "sync_now": float(self._sync_now),
            "trainer": None,
        }
        tr = self.trainer
        if isinstance(tr, CohortTrainer):
            core["trainer"] = {
                "perm_rng": _pack_rng(tr.perm_rng),
                "pending": [self._intern(p, reg) for p in tr.pending],
                "versions": [self._pack_tree(v) for v in tr._versions],
            }
        return core

    def _load_core(self, core, pts: List[PendingTask]) -> None:
        srv = self.server
        srv.w = self._unpack_tree(core["server"]["w"])
        srv.t = int(core["server"]["t"])
        srv.active = int(core["server"]["active"])
        srv.cache = [(self._unpack_tree(w), int(h), int(n))
                     for w, h, n in core["server"]["cache"]]
        self.strategy.load_state(core["strategy"])
        self.prev_local = {int(k): self._unpack_tree(w)
                           for k, w in core["prev_local"]}
        ch, c = self.channel, core["channel"]
        ch.bytes_up = int(c["bytes_up"])
        ch.bytes_down = int(c["bytes_down"])
        ch.max_up = int(c["max_up"])
        ch.max_down = int(c["max_down"])
        ch.tier_up = {int(t): int(b) for t, b in c["tier_up"]}
        ch.tier_down = {int(t): int(b) for t, b in c["tier_down"]}
        self.history = [LogEntry(float(t), int(r), float(a), int(bu),
                                 int(bd), int(mu), int(md))
                        for t, r, a, bu, bd, mu, md in core["history"]]
        s = core["stats"]
        self.stats = EngineStats(
            int(s["dispatches"]), int(s["completions"]), int(s["dropouts"]),
            int(s["transient_failures"]), int(s["redispatched"]),
            int(s["flushes"]), int(s["flushed_tasks"]),
            completed_per_device=np.asarray(s["completed_per_device"],
                                            np.int64))
        self._tail_logged = bool(core["tail_logged"])
        self._sync_now = float(core["sync_now"])
        if core["trainer"] is not None:
            tr = self.trainer
            if not isinstance(tr, CohortTrainer):
                raise ValueError("checkpoint holds a deferred cohort buffer "
                                 "but this engine was built with "
                                 "cohort_size=0")
            _load_rng(tr.perm_rng, core["trainer"]["perm_rng"])
            tr.pending = [pts[int(i)] for i in core["trainer"]["pending"]]
            tr._versions = [self._unpack_tree(v)
                            for v in core["trainer"]["versions"]]
            tr._version_ids = {id(v): i for i, v in enumerate(tr._versions)}
            # the restored global model is a fresh object: re-intern it if
            # it was one of the buffered versions, so that later submits
            # reuse the slot the uninterrupted run would
            for i, v in enumerate(tr._versions):
                if _trees_equal(v, srv.w):
                    tr._version_ids[id(srv.w)] = i
                    break

    def _sched_state(self, reg) -> Dict[str, Any]:
        events = None
        if self._events is not None:
            events = [[float(t), int(s), kind, int(k),
                       self._pack_payload(p, reg), int(h)]
                      for t, s, kind, k, p, h in self._events]
        waiting = (None if self._waiting is None
                   else [int(x) for x in list(self._waiting)])
        return {"events": events, "waiting": waiting}

    def _load_sched(self, st, pts: List[PendingTask]) -> None:
        ev = st["events"]
        # the saved list is the heap's own array, so it is still a heap
        self._events = None if ev is None else [
            (float(t), int(s), str(kind), int(k),
             self._unpack_payload(p, pts), int(h))
            for t, s, kind, k, p, h in ev]
        w = st["waiting"]
        self._waiting = None if w is None else [int(x) for x in w]

    def state_dict(self) -> Dict[str, Any]:
        """The whole simulation state: the server and its cache, the codec
        policy's estimates, the DeviceRegistry, the event queue or table,
        every RNG stream, the history, stats and byte meters, and the
        deferred cohort buffer.  ``checkpoint.io.save_blob`` writes it;
        :meth:`load_state` on a fresh engine over the same (data,
        partitions, w_init, cfg) restores it, and the resumed ``run`` is
        bit-identical to one that never stopped."""
        reg = ({}, [])
        state = {
            "version": 1,
            "rng": _pack_rng(self.rng),
            "scenario_rng": _pack_rng(self.scenario_rng),
            "devices": _pack_devices(self.devices),
            "started": bool(self._started),
            "now": float(self._now),
            "seq": int(self._seq),
            "sched": self._sched_state(reg),
            "core": self._core_state(reg),
        }
        state["pending"] = self._pack_pending(reg)
        return state

    def load_state(self, state: Dict[str, Any]) -> None:
        if int(state["version"]) != 1:
            raise ValueError(
                f"unknown engine checkpoint version {state['version']!r}")
        _load_rng(self.rng, state["rng"])
        _load_rng(self.scenario_rng, state["scenario_rng"])
        _load_devices(self.devices, state["devices"])
        self._started = bool(state["started"])
        self._now = float(state["now"])
        self._seq = int(state["seq"])
        pts = self._unpack_pending(state["pending"])
        self._load_core(state["core"], pts)
        self._load_sched(state["sched"], pts)


# ----------------------------------------------------------------------
# Batched scheduler (SimConfig.scheduler = "batched")
# ----------------------------------------------------------------------
class BatchedEngine(FLEngine):
    """The same event machine as :class:`FLEngine`, with the heap replaced
    by the resident per-device arrays of :class:`EventTable`.

    Nothing protocol-visible changes in ``handler_mode="serial"``: the next
    ``SELECT_K`` events are selected in one numpy call in the heap's exact
    ``(time, seq)`` order; events pushed during a batch land in the arrays,
    and those inside the batch's horizon also enter a small overflow heap
    that the loop interleaves, so the handlers see the heap's event order
    and draw the RNG streams in its order.  The initial request burst is one
    vectorized ``uniform`` draw (the same stream as ``n`` scalar draws), the
    waiting queue an O(1)-pop FIFO, and arrivals go through the batched
    strategy and policy hooks as groups of one.

    **Wave mode** (``handler_mode="wave"``) splits each selected batch into
    maximal same-kind runs and processes every run as arrays:

    * grant waves (Alg. 1 Distributor): one liveness mask, one
      admission-gate slice (the first ``free`` members dispatch, the rest
      park with one ``_FifoWaiting.extend``), codecs from ``channels_for``
      priced once per distinct codec, one ``round_latency_batch`` whose
      draws go to the members in ascending device-id order, and one
      arrival scatter;
    * arrival waves (Alg. 2, Eqs. 6-10): one ``observe_arrivals`` scatter,
      then ``on_arrivals``; the TEA family fuses the cache inserts and the
      aggregation (``receive_many``, the stacked form), in segments that
      end at cache fills so each eval log sees its round's server state.
      Re-requests and the waiting-queue drain (one ``pop_many``) follow as
      one request scatter.

    The relaxed-parity contract against ``"serial"`` is the JAX package's:
    draws are batched per wave (grant latencies in device-id order,
    scenario draws in wave order); events spawned by a wave are processed
    after it, never between its members; one aggregation reduces by a
    tensordot; and a cohort group with no local step runs
    ``_zero_step_round``.  The event timeline still depends only on numpy
    draws and shape-only wire sizes, so a wave run equals the JAX wave run
    in every time, round and byte column."""

    SELECT_K = 1024   # selection width; correctness is width-independent

    supports_wave = True

    def _start_table(self) -> "EventTable":
        table = self.devices.event_table()
        n = self.cfg.n_devices
        if not self._started:
            if n:
                # one vectorized draw == the heap path's n scalar draws
                table.time[:] = self.rng.uniform(0.0, 0.05, n)
                table.seq[:] = np.arange(n)
                table.kind[:] = KIND_IDS["request"]
            self._seq = n
            self._waiting = _FifoWaiting()
            self._log(0.0)
            self._started = True
        return table

    def _run_async(self, time_budget: float, max_rounds: int,
                   eval_every: int) -> List[LogEntry]:
        if self.cfg.handler_mode == "wave":
            return self._run_wave(time_budget, max_rounds, eval_every)
        self._resume()
        table = self._start_table()
        waiting = self._waiting
        spawned: List[Tuple[float, int, str, int, Any, int]] = []
        horizon = (np.inf, np.inf)   # (time, seq) of the batch's last event

        def push(t, kind, k, payload=None, h=0):
            table.put(k, t, self._seq, kind, payload, h)
            if (t, self._seq) < horizon:
                heapq.heappush(spawned, (t, self._seq, kind, k, payload, h))
            self._seq += 1

        now = self._now
        stop = False
        while not stop:
            sel = table.select_batch(self.SELECT_K)
            if not len(sel):
                break
            ts = table.time[sel].tolist()
            ss = table.seq[sel].tolist()
            kinds = table.kind[sel].tolist()
            hs = table.h[sel].tolist()
            batch = [(ts[i], ss[i], KIND_NAMES[kinds[i]], k,
                      table.payload[k], hs[i])
                     for i, k in enumerate(sel.tolist())]
            horizon = (batch[-1][0], batch[-1][1])
            i, m = 0, len(batch)
            while i < m or spawned:
                if spawned and (i >= m or spawned[0][:2] < batch[i][:2]):
                    ev = heapq.heappop(spawned)
                else:
                    ev = batch[i]
                    i += 1
                now, _, kind, k, payload, h = ev
                if now > time_budget or self.server.t >= max_rounds:
                    # stop before clearing: the boundary event stays in the
                    # table, so a later ``run`` resumes exactly here
                    stop = True
                    break
                table.clear(k)
                if kind == "request":
                    self._handle_request(now, k, push, waiting)
                elif kind == "failure":
                    self._handle_failure(now, k, payload, push, waiting)
                else:
                    self._handle_arrival(now, k, payload, h, eval_every,
                                         push, waiting)
            spawned.clear()   # leftovers (on stop) still live in `table`
            horizon = (np.inf, np.inf)
        self._now = now
        self._log(min(now, time_budget))
        self._tail_logged = True
        return self.history

    def _handle_arrival(self, now, k, payload, h, eval_every, push,
                        waiting) -> None:
        # FLEngine._handle_arrival through the batched hooks (groups of one)
        self.strategy.policy.observe_arrivals(
            [k], [max(0, self.server.t - h)])
        done_round, = self.strategy.on_arrivals(self, [(now, k, payload, h)])
        self.stats.completions += 1
        self.stats.completed_per_device[k] += 1
        if done_round and self.server.t % eval_every == 0:
            self._log(now)
        if self.devices.alive[k]:
            push(now, "request", k)
        self._drain_waiting(now, push, waiting)

    # -- wave mode (handler_mode="wave") -----------------------------------
    def _run_wave(self, time_budget: float, max_rounds: int,
                  eval_every: int) -> List[LogEntry]:
        """The serial batched loop's selection, with each maximal same-kind
        run of a batch dispatched as one wave.  Events spawned by a wave
        join the table at once and interleave at the next wave boundary."""
        self._resume()
        table = self._start_table()
        n = self.cfg.n_devices
        waiting = self._waiting
        # overflow heap of events spawned inside the current batch horizon:
        # (time, seq, kind_id, device, payload, h)
        spawned: List[Tuple[float, int, int, int, Any, int]] = []
        horizon = (np.inf, np.inf)

        def push(t, kind, k, payload=None, h=0):
            table.put(k, t, self._seq, kind, payload, h)
            if (t, self._seq) < horizon:
                heapq.heappush(spawned,
                               (t, self._seq, KIND_IDS[kind], k, payload, h))
            self._seq += 1

        def push_wave(ts_w, ks_w, kind, payloads, h):
            g = len(ks_w)
            if not g:
                return
            seqs = self._seq + np.arange(g)
            self._seq += g
            table.put_wave(ks_w, ts_w, seqs, kind, payloads, h)
            # fresh seqs exceed the horizon's, so only a strictly earlier
            # time puts a new event inside the current batch
            kid = KIND_IDS[kind]
            for j in np.flatnonzero(ts_w < horizon[0]).tolist():
                heapq.heappush(spawned, (
                    float(ts_w[j]), int(seqs[j]), kid, int(ks_w[j]),
                    None if payloads is None else payloads[j], int(h)))

        req_id = KIND_IDS["request"]
        arr_id = KIND_IDS["arrival"]
        now = self._now
        stop = False
        while not stop:
            sel = table.select_batch(self.SELECT_K)
            if not len(sel):
                break
            ts = table.time[sel]
            ss = table.seq[sel]
            kinds = table.kind[sel]
            hs = table.h[sel]
            payloads = [table.payload[k] for k in sel.tolist()]
            horizon = (float(ts[-1]), int(ss[-1]))
            bounds = np.flatnonzero(np.diff(kinds) != 0) + 1
            i, m, b = 0, len(sel), 0
            while i < m or spawned:
                if not spawned:
                    # the next run is a contiguous slice of the batch
                    while b < len(bounds) and bounds[b] <= i:
                        b += 1
                    j = int(bounds[b]) if b < len(bounds) else m
                    wts, wks = ts[i:j], sel[i:j]
                    wps, whs = payloads[i:j], hs[i:j]
                    kid = int(kinds[i])
                    i = j
                else:
                    # merge the overflow heap with the batch cursor, event
                    # by event, until the kind changes
                    rt: List[float] = []
                    rk: List[int] = []
                    rp: List[Any] = []
                    rh: List[int] = []
                    kid = -1
                    while True:
                        if spawned and (i >= m or
                                        (spawned[0][0], spawned[0][1])
                                        < (ts[i], ss[i])):
                            e = spawned[0]
                            if kid < 0:
                                kid = e[2]
                            elif e[2] != kid:
                                break
                            heapq.heappop(spawned)
                            rt.append(e[0])
                            rk.append(e[3])
                            rp.append(e[4])
                            rh.append(e[5])
                        elif i < m:
                            if kid < 0:
                                kid = int(kinds[i])
                            elif int(kinds[i]) != kid:
                                break
                            rt.append(float(ts[i]))
                            rk.append(int(sel[i]))
                            rp.append(payloads[i])
                            rh.append(int(hs[i]))
                            i += 1
                        else:
                            break
                    wts = np.asarray(rt, np.float64)
                    wks = np.asarray(rk, np.int64)
                    wps, whs = rp, np.asarray(rh, np.int64)
                if self.server.t >= max_rounds:
                    stop = True
                    break
                # budget / round-cap prefix cut: unprocessed members keep
                # their slots, so a later ``run`` resumes here.  A partial
                # budget cut does not end the loop: the processed prefix
                # spawns re-requests still inside the budget, which the
                # serial order grants before stopping; every later wave is
                # cut too, down to zero.  The round cap stops at the
                # capping event, like the serial loop.
                cut = int(np.searchsorted(wts, time_budget, side="right"))
                capped = False
                if kid == arr_id:
                    srv = self.server
                    if getattr(self.strategy, "arrival_wave", False):
                        allowed = ((max_rounds - srv.t)
                                   * srv.cfg.cache_size - len(srv.cache))
                    else:
                        allowed = max_rounds - srv.t
                    if max(0, allowed) < cut:
                        cut = max(0, allowed)
                        capped = True
                if cut < len(wts):
                    stop = True
                    if not cut:
                        break
                    wts, wks = wts[:cut], wks[:cut]
                    wps, whs = wps[:cut], whs[:cut]
                table.clear_wave(wks)
                if kid == req_id:
                    self._wave_requests(wts, wks, push, push_wave, waiting)
                elif kid == arr_id:
                    self._wave_arrivals(wts, wks, wps, whs, eval_every,
                                        push, push_wave, waiting)
                else:
                    for t_f, k_f, p_f in zip(wts.tolist(), wks.tolist(),
                                             wps):
                        self._handle_failure(t_f, int(k_f), p_f, push,
                                             waiting)
                if not stop:
                    now = float(wts[-1])
                if capped:
                    break
            spawned.clear()   # leftovers (on stop) still live in `table`
            horizon = (np.inf, np.inf)
        if stop:
            # resume cursor = the earliest unprocessed event, where the
            # serial loops stop (empty slots hold +inf)
            rem = float(table.time.min()) if n else np.inf
            if np.isfinite(rem):
                now = rem
        self._now = now
        self._log(min(now, time_budget))
        self._tail_logged = True
        return self.history

    def _wave_requests(self, wts, wks, push, push_wave, waiting) -> None:
        """Alg. 1 Distributor over a request run: one liveness mask, one
        admission-gate slice, one wire-pricing pass over the wave's codecs,
        one scenario draw vector, one ``round_latency_batch`` (device-id
        draw order) and one arrival scatter."""
        dv = self.devices
        mask = dv.alive[wks]
        if not mask.all():
            wks, wts = wks[mask], wts[mask]
        srv = self.server
        free = max(srv.cfg.max_parallel - srv.active, 0)
        if free < len(wks):
            waiting.extend(wks[free:].tolist())
            wks, wts = wks[:free], wts[:free]
        g = len(wks)
        if not g:
            return
        if not self.trainer.deferred:
            # the serial trainer's codec round trips interleave RNG draws
            # with the latency draws per grant: keep the scalar handler
            for t_s, k_s in zip(wts.tolist(), wks.tolist()):
                self._handle_request(t_s, int(k_s), push, waiting)
            return
        self.stats.dispatches += g
        srv.active += g
        w_t, t0 = srv.w, srv.t
        codecs = self.strategy.channels_for(t0, wks)
        tiers = dv.tier[wks]
        # wire price once per distinct codec instance (shape-only sizes,
        # cached instances)
        nbytes = np.empty(g, np.int64)
        seen: Dict[int, int] = {}
        for idx, c in enumerate(codecs):
            v = seen.get(id(c))
            if v is None:
                v = seen[id(c)] = c.wire_bytes(w_t)
            nbytes[idx] = v

        scen = self.scenario
        if scen is not None and scen.active and (
                scen.dropout_prob + scen.failure_prob > 0):
            u = self.scenario_rng.random_sample(g)
            fail = u < scen.dropout_prob + scen.failure_prob
            if fail.any():
                f = np.flatnonzero(fail)
                # failing members: down metered, a failure event mid-round;
                # latency and fail-point draws in device-id order
                f = f[np.argsort(wks[f], kind="stable")]
                fks = wks[f]
                self.channel.down_wave(nbytes[f], tiers[f])
                nb = np.maximum(1, self.part_sizes[fks]
                                // self.cfg.batch_size)
                dl, cp, _ = dv.round_latency_batch(
                    fks, nbytes[f] * 8.0, np.zeros(len(f)), nb,
                    self.scenario_rng)
                fail_at = wts[f] + self.scenario_rng.uniform(
                    0.0, dl + cp, len(f))
                for j, fi in enumerate(f.tolist()):
                    push(float(fail_at[j]), "failure", int(wks[fi]),
                         "dropout" if u[fi] < scen.dropout_prob
                         else "transient")
                keep = ~fail
                wks, wts = wks[keep], wts[keep]
                nbytes, tiers = nbytes[keep], tiers[keep]
                codecs = [c for c, kp in zip(codecs, keep.tolist()) if kp]
                g = len(wks)
                if not g:
                    return

        self.channel.down_wave(nbytes, tiers)
        tasks = [self.trainer.submit(int(k), w_t, t0, c.p_s, c.p_q)
                 for k, c in zip(wks.tolist(), codecs)]
        self.channel.up_wave(nbytes, tiers)
        order = np.argsort(wks, kind="stable")   # device-id draw order
        ko = wks[order]
        bits = nbytes[order] * 8.0
        nb = np.maximum(1, self.part_sizes[ko] // self.cfg.batch_size)
        dl, cp, ul = dv.round_latency_batch(ko, bits, bits, nb, self.rng)
        push_wave(wts[order] + dl + cp + ul, ko, "arrival",
                  [tasks[idx] for idx in order.tolist()], t0)

    def _wave_arrivals(self, wts, wks, wps, whs, eval_every, push,
                       push_wave, waiting, push_wave_free=None,
                       max_rounds=None) -> None:
        """Alg. 2 Receiver/Updater over an arrival run.  Strategies with
        ``arrival_wave`` fuse the cache inserts and the Eqs. 6-10
        aggregation through ``on_arrivals``, in segments that end at cache
        fills so each eval log sees its round; others keep the scalar
        handler.  ``push_wave_free`` routes the re-request scatter (a
        multi-task fleet hands requests back unassigned); ``max_rounds``,
        when given, drops the arrivals past the round cap (a fleet's
        finished job)."""
        srv = self.server
        strategy = self.strategy
        fused = getattr(strategy, "arrival_wave", False)
        if max_rounds is not None:
            allowed = ((max_rounds - srv.t) * srv.cfg.cache_size
                       - len(srv.cache)) if fused else max_rounds - srv.t
            allowed = max(0, allowed)
            if allowed < len(wks):
                wts, wks = wts[:allowed], wks[:allowed]
                wps, whs = wps[:allowed], whs[:allowed]
        g = len(wks)
        if not g:
            return
        if not fused or (g == 1 and push_wave_free is None):
            for idx in range(g):
                self._handle_arrival(float(wts[idx]), int(wks[idx]),
                                     wps[idx], int(whs[idx]), eval_every,
                                     push, waiting)
            return
        K = srv.cfg.cache_size
        t0, c0 = srv.t, len(srv.cache)
        # staleness of arrival idx as the serial loop would see it: t has
        # advanced by one per preceding cache fill
        stal = np.maximum(0, t0 + (c0 + np.arange(g)) // K - whs)
        strategy.policy.observe_arrivals(wks.tolist(), stal.tolist())
        ks_l, hs_l = wks.tolist(), whs.tolist()
        arrivals = [(float(wts[idx]), ks_l[idx], wps[idx], hs_l[idx])
                    for idx in range(g)]
        start = 0
        while start < g:
            seg_end = min(g, start + (K - len(srv.cache)))
            dones = strategy.on_arrivals(self, arrivals[start:seg_end])
            if dones[-1] and srv.t % eval_every == 0:
                self._log(float(wts[seg_end - 1]))
            start = seg_end
        self.stats.completions += g
        # a wave may hold one device twice
        np.add.at(self.stats.completed_per_device, wks, 1)
        alive = self.devices.alive[wks]
        (push_wave_free or push_wave)(wts[alive], wks[alive],
                                      "request", None, 0)
        # one-slice drain: drained request j fires at arrival j's time
        n_drain = min(len(waiting), max(0, srv.cfg.max_parallel
                                        - srv.active))
        if n_drain:
            drained = np.asarray(waiting.pop_many(n_drain), np.int64)
            push_wave(wts[:n_drain], drained, "request", None, 0)

    # -- checkpoint/resume: the EventTable instead of the heap -------------
    def _sched_state(self, reg) -> Dict[str, Any]:
        tab = self.devices.events
        table = None
        if tab is not None:
            live = np.flatnonzero(tab.time < np.inf).tolist()
            table = {"slots": [[int(k), float(tab.time[k]), int(tab.seq[k]),
                                int(tab.kind[k]), int(tab.h[k]),
                                int(tab.task[k]),
                                self._pack_payload(tab.payload[k], reg)]
                               for k in live]}
        waiting = (None if self._waiting is None
                   else [int(x) for x in
                         self._waiting._items[self._waiting._head:]])
        return {"table": table, "waiting": waiting}

    def _load_sched(self, st, pts: List[PendingTask]) -> None:
        if st["table"] is not None:
            tab = self.devices.event_table()
            tab.time[:] = np.inf
            tab.payload = [None] * len(tab.time)
            for k, t, seq, kind, h, task, p in st["table"]["slots"]:
                k = int(k)
                tab.time[k] = float(t)
                tab.seq[k] = int(seq)
                tab.kind[k] = int(kind)
                tab.h[k] = int(h)
                tab.task[k] = int(task)
                tab.payload[k] = self._unpack_payload(p, pts)
        if st["waiting"] is None:
            self._waiting = None
        else:
            w = _FifoWaiting()
            w._items = [int(x) for x in st["waiting"]]
            self._waiting = w


# scheduler registry: SimConfig.scheduler -> engine class
SCHEDULERS: Dict[str, type] = {"heap": FLEngine, "batched": BatchedEngine}
