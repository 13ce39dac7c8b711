"""Multi-task fleet: several concurrent FL jobs over ONE shared device
fleet, in PyTorch (the JAX package's ``fl/fleet.py``).

FedAST (arXiv:2406.00302) makes the systems case: when several federated
jobs train at once over one device population, a shared asynchronous event
loop with per-job buffers beats running the jobs back to back, and routing
devices toward the slower-converging jobs trims the straggler job's wall
clock.

* **One fleet, many jobs.** :class:`MultiTaskEngine` holds one
  :class:`~repro_torch.fl.engine.DeviceRegistry` (one draw of link rates
  and compute coefficients, one liveness array, one tier map) and ONE
  virtual-clock event loop, while each job keeps its own state: a server
  (its own Alg. 1 admission gate and Alg. 2 cache), a strategy and codec
  policy, a channel meter (exact per-job wire bytes), a trainer and a
  waiting queue.  Each job is a full :class:`~repro_torch.fl.engine.FLEngine`
  built in shared-fleet mode (RNG, registry and scenario stream injected),
  so every handler is the single-task code.  All jobs' models live on one
  device, the card unless the caller names another.
* **Device -> job assignment.** A device's request event carries ``task =
  -1`` ("assign on handling"); the bound :class:`Assigner` (registry
  :data:`ASSIGNERS`) picks the job at grant time: ``round_robin`` cycles
  the jobs, ``weighted`` partitions the fleet by ``FleetConfig.shares``,
  ``adaptive`` samples jobs with a free admission slot with probability
  proportional to ``max(floor, 1 - accuracy)``.  Assigners draw from a
  stream of their own, so assignment never moves the shared engine stream.
* **Both schedulers.** The heap (events ``(t, seq, kind, k, task,
  payload, h)``) and the batched :class:`~repro_torch.fl.engine.EventTable`
  path, whose ``task`` column carries job ownership, in serial or wave
  mode.  A one-task fleet replays the standalone engine's RNG draws in the
  same order on either scheduler, so its history is bit-identical to the
  engine's; a fleet's time, round and byte columns equal the JAX fleet's
  for the same inputs.

In wave mode every flush of a cohort job runs kernel B's channel form on
the card (``kernels/ops.py::threshold_channel_leaves``), down and up,
from the runtimes' own wave handlers.

Checkpoint/resume: :meth:`MultiTaskEngine.state_dict` saves the shared
pieces once (RNG streams, registry, event queue or table, assigner) plus
every job's core, in the JAX fleet's layout
(``repro_torch.checkpoint.io.save_blob``).
"""
from __future__ import annotations

import abc
import dataclasses
import heapq
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np

from repro_torch.core.latency import ComputeConfig, WirelessConfig
from repro_torch.fl.engine import (KIND_IDS, KIND_NAMES, SCHEDULERS,
                                   DeviceRegistry, _FifoWaiting,
                                   _load_devices, _load_rng, _pack_devices,
                                   _pack_rng)
from repro_torch.fl.simulator import LogEntry, ScenarioConfig, SimConfig

__all__ = ["FleetConfig", "Assigner", "RoundRobinAssigner",
           "WeightedAssigner", "AdaptiveAssigner", "ASSIGNERS",
           "make_assigner", "MultiTaskEngine", "build_fleet"]


# ----------------------------------------------------------------------
# Fleet configuration
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """N per-task protocol specs sharing one physical fleet.

    Each entry of ``tasks`` is a full :class:`SimConfig` describing that
    job's protocol knobs (method, task/model family, c_fraction, codec,
    policy, cohort size, ...).  The *fleet-level* fields below override the
    per-task ones that describe shared physics — every job sees the same
    devices, links, tiers and seed, so ``resolve(i)`` rewrites
    ``n_devices`` / ``seed`` / ``scheduler`` / ``scenario`` / ``wireless``
    / ``compute`` on task ``i``'s spec."""

    tasks: Sequence[SimConfig]
    n_devices: int = 100
    seed: int = 0
    scheduler: str = "heap"
    # "serial" (bit-identical per-event loop) or "wave" (task-id-aware
    # vectorized waves; needs scheduler="batched") — the fleet-level analog
    # of SimConfig.handler_mode, rewritten onto every per-task spec so the
    # runtimes' wave-gated paths (e.g. the cohort zero-step fast path)
    # agree with the fleet loop
    handler_mode: str = "serial"
    assigner: str = "round_robin"
    shares: Optional[Sequence[float]] = None     # weighted assigner only
    scenario: Optional[ScenarioConfig] = None
    wireless: WirelessConfig = dataclasses.field(default_factory=WirelessConfig)
    compute: ComputeConfig = dataclasses.field(default_factory=ComputeConfig)

    def resolve(self, i: int) -> SimConfig:
        return dataclasses.replace(
            self.tasks[i], n_devices=self.n_devices, seed=self.seed,
            scheduler=self.scheduler, handler_mode=self.handler_mode,
            scenario=self.scenario,
            wireless=self.wireless, compute=self.compute)


# ----------------------------------------------------------------------
# Device -> task assigners
# ----------------------------------------------------------------------
class Assigner(abc.ABC):
    """Picks which job a device's request event serves.  ``assign`` sees
    the requesting device id and the list of live (unfinished) task
    indices — never empty; the fleet loop stops before calling in.  Any
    randomness comes from a dedicated seeded stream so assignment leaves
    the shared engine RNG untouched (which is what keeps a single-task
    fleet bit-identical to the standalone engine)."""

    name: str = ""

    def __init__(self, fleet: "MultiTaskEngine"):
        self.fleet = fleet
        self.rng = np.random.RandomState(
            (fleet.cfg.seed + 0xA551C4E) % (2 ** 31))

    @abc.abstractmethod
    def assign(self, k: int, live: Sequence[int]) -> int:
        """Task index for device ``k``'s request, drawn from ``live``."""

    def state_dict(self) -> Dict[str, Any]:
        return {"rng": _pack_rng(self.rng)}

    def load_state(self, state: Dict[str, Any]) -> None:
        _load_rng(self.rng, state["rng"])


class RoundRobinAssigner(Assigner):
    """Cycle requests through the live jobs in order — draws no RNG, so a
    single-task fleet stays on the standalone engine's exact stream."""

    name = "round_robin"

    def __init__(self, fleet):
        super().__init__(fleet)
        self._next = 0

    def assign(self, k, live):
        j = live[self._next % len(live)]
        self._next += 1
        return j

    def state_dict(self):
        st = super().state_dict()
        st["next"] = int(self._next)
        return st

    def load_state(self, state):
        super().load_state(state)
        self._next = int(state["next"])


class WeightedAssigner(Assigner):
    """Static fleet partition: device ``k`` always serves the job its
    contiguous share block maps to (``FleetConfig.shares``, normalized;
    uniform when unset) — the fixed-allocation baseline FedAST's dynamic
    routing is measured against.  Requests whose home job has finished
    fall back to cycling the remaining live jobs."""

    name = "weighted"

    def __init__(self, fleet):
        super().__init__(fleet)
        n, t = fleet.cfg.n_devices, len(fleet.cfg.tasks)
        shares = np.asarray(fleet.cfg.shares if fleet.cfg.shares is not None
                            else [1.0] * t, float)
        assert len(shares) == t and (shares >= 0).all() and shares.sum() > 0
        bounds = np.floor(np.cumsum(shares / shares.sum()) * n + 0.5)
        self._map = np.searchsorted(bounds, np.arange(n), side="right")
        self._map = np.minimum(self._map, t - 1).astype(np.int64)
        self._next = 0

    def assign(self, k, live):
        j = int(self._map[k])
        if j in live:
            return j
        j = live[self._next % len(live)]
        self._next += 1
        return j

    def state_dict(self):
        st = super().state_dict()
        st["next"] = int(self._next)
        return st

    def load_state(self, state):
        super().load_state(state)
        self._next = int(state["next"])


class AdaptiveAssigner(Assigner):
    """FedAST-style dynamic reallocation: grant probability shifts toward
    the slower-converging jobs.  Candidates are the live jobs with a free
    Alg. 1 admission slot (all live jobs when everyone is saturated); a
    request is routed to candidate ``j`` with probability proportional to
    its loss proxy ``max(floor, 1 - accuracy)`` read off the job's own
    recorded curve — a job near convergence stops attracting devices and
    its capacity flows to whoever still needs rounds."""

    name = "adaptive"
    floor = 0.05      # keeps converged jobs reachable (and p well-defined)

    def assign(self, k, live):
        rts = self.fleet.runtimes
        cand = [j for j in live
                if rts[j].server.active < rts[j].server.cfg.max_parallel]
        if not cand:
            cand = list(live)
        if len(cand) == 1:
            return cand[0]
        w = np.asarray([max(self.floor, 1.0 - rts[j].history[-1].accuracy)
                        for j in cand])
        return cand[int(self.rng.choice(len(cand), p=w / w.sum()))]


ASSIGNERS: Dict[str, Type[Assigner]] = {
    cls.name: cls for cls in (RoundRobinAssigner, WeightedAssigner,
                              AdaptiveAssigner)
}


def make_assigner(name: str, fleet: "MultiTaskEngine") -> Assigner:
    try:
        return ASSIGNERS[name](fleet)
    except KeyError:
        raise ValueError(f"unknown assigner {name!r}; "
                         f"expected one of {sorted(ASSIGNERS)}") from None


# ----------------------------------------------------------------------
# The fleet engine
# ----------------------------------------------------------------------
class MultiTaskEngine:
    """Run ``len(cfg.tasks)`` concurrent FL jobs over one shared fleet.

    ``datas`` / ``partitions`` / ``w_inits`` are per-task lists aligned
    with ``cfg.tasks`` (see :func:`build_fleet` for the one-call
    constructor).  Each job is a full per-task engine runtime on
    ``device`` (the card unless the caller names another), sharing the
    fleet's RNG stream, :class:`DeviceRegistry` and scenario stream; the
    fleet owns the event loop and drives the runtimes' own handlers, so
    all protocol behavior is the single-task code."""

    def __init__(self, datas: Sequence[Dict[str, np.ndarray]],
                 partitions: Sequence[List[np.ndarray]],
                 w_inits: Sequence[Any], cfg: FleetConfig, *, device=None):
        if not cfg.tasks:
            raise ValueError("FleetConfig.tasks is empty")
        assert len(datas) == len(partitions) == len(w_inits) == len(cfg.tasks)
        try:
            engine_cls = SCHEDULERS[cfg.scheduler]
        except KeyError:
            raise ValueError(
                f"unknown scheduler {cfg.scheduler!r}; "
                f"expected one of {sorted(SCHEDULERS)}") from None
        self.cfg = cfg
        # shared physics: ONE engine-ordered RNG draw (rates, then a_k —
        # identical to a standalone engine with the same seed), one
        # registry, one scenario stream, tiers applied once
        self.rng = np.random.RandomState(cfg.seed)
        self.devices = DeviceRegistry(cfg.resolve(0), self.rng)
        self.scenario_rng = np.random.RandomState(
            (cfg.seed + 0x5CE7A710) % (2 ** 31))
        if cfg.scenario is not None and cfg.scenario.tiers:
            self.devices.apply_tiers(cfg.scenario.tiers)
        self.runtimes = []
        for i in range(len(cfg.tasks)):
            rt = engine_cls(datas[i], partitions[i], w_inits[i],
                            cfg.resolve(i), rng=self.rng,
                            devices=self.devices,
                            scenario_rng=self.scenario_rng, device=device)
            if not rt.strategy.event_driven:
                raise ValueError(
                    f"fleet task {i} ({cfg.tasks[i].method!r}) is not "
                    "event-driven; synchronous protocols cannot share the "
                    "fleet event loop")
            self.runtimes.append(rt)
        self.assigner = make_assigner(cfg.assigner, self)
        self.waiting: List[Any] = []          # per-task, built at start
        self._started = False
        self._now = 0.0
        self._seq = 0
        self._events: Optional[List[Tuple]] = None     # heap scheduler

    # -- helpers -----------------------------------------------------------
    def _live(self, max_rounds: int) -> List[int]:
        return [j for j, rt in enumerate(self.runtimes)
                if rt.server.t < max_rounds]

    def _resume(self) -> None:
        for rt in self.runtimes:
            rt._resume()

    def _finish(self, now: float, time_budget: float) -> List[List[LogEntry]]:
        self._now = now
        for rt in self.runtimes:
            rt._log(min(now, time_budget))
            rt._tail_logged = True
        return [rt.history for rt in self.runtimes]

    # -- entry point -------------------------------------------------------
    def run(self, time_budget: float = 300.0, max_rounds: int = 10 ** 9,
            eval_every: int = 1) -> List[List[LogEntry]]:
        """Advance the shared virtual clock; returns the per-task histories
        (aligned with ``cfg.tasks``).  Resumable exactly like
        ``FLEngine.run``: a second call picks up at the stop boundary and
        ``run(t)`` + ``run(T)`` matches ``run(T)`` bit-for-bit."""
        if self.cfg.scheduler == "batched":
            if self.cfg.handler_mode == "wave":
                return self._run_wave(time_budget, max_rounds, eval_every)
            return self._run_batched(time_budget, max_rounds, eval_every)
        return self._run_heap(time_budget, max_rounds, eval_every)

    # -- heap scheduler ----------------------------------------------------
    def _push(self, t, kind, k, task, payload=None, h=0):
        heapq.heappush(self._events,
                       (t, self._seq, kind, k, task, payload, h))
        self._seq += 1

    def _task_pusher(self, j: int):
        """A single-task-engine-shaped ``push`` bound to job ``j`` — what
        the runtimes' inherited handlers call, so arrivals, scenario
        failures, retries and waiting-queue drains all stay job-bound."""
        return lambda t, kind, k, payload=None, h=0: \
            self._push(t, kind, k, j, payload, h)

    def _run_heap(self, time_budget, max_rounds, eval_every):
        self._resume()
        if not self._started:
            self._events = []
            self.waiting = [[] for _ in self.runtimes]
            for k in range(self.cfg.n_devices):
                # same per-device scalar draws, same order, as the
                # standalone engine's initial burst
                self._push(self.rng.uniform(0, 0.05), "request", k, -1)
            for rt in self.runtimes:
                rt._log(0.0)
                rt._started = True
            self._started = True
        events = self._events
        pushers = [self._task_pusher(j) for j in range(len(self.runtimes))]
        now = self._now
        while events:
            live = self._live(max_rounds)
            t_next = events[0][0]
            if t_next > time_budget or not live:
                now = t_next      # peek: boundary event stays queued
                break
            now, _, kind, k, task, payload, h = heapq.heappop(events)
            if kind == "request":
                if task < 0 or self.runtimes[task].server.t >= max_rounds:
                    task = self.assigner.assign(k, live)
                self.runtimes[task]._handle_request(
                    now, k, pushers[task], self.waiting[task])
            elif self.runtimes[task].server.t >= max_rounds:
                continue          # drop in-flight events of a finished job
            elif kind == "failure":
                self.runtimes[task]._handle_failure(
                    now, k, payload, pushers[task], self.waiting[task])
            else:
                self._on_arrival(task, now, k, payload, h, eval_every,
                                 pushers[task])
        return self._finish(now, time_budget)

    def _on_arrival(self, j, now, k, payload, h, eval_every, push_j,
                    batched: bool = False) -> None:
        # mirrors FLEngine._handle_arrival / BatchedEngine._handle_arrival,
        # except the re-request goes out unassigned (task = -1) so the
        # assigner routes the freed device on its next grant
        rt = self.runtimes[j]
        stale = max(0, rt.server.t - h)
        if batched:
            rt.strategy.policy.observe_arrivals([k], [stale])
            done_round, = rt.strategy.on_arrivals(rt, [(now, k, payload, h)])
        else:
            rt.strategy.policy.observe_arrival(k, stale)
            done_round = rt.strategy.on_arrival(rt, now, k, payload, h)
        rt.stats.completions += 1
        rt.stats.completed_per_device[k] += 1
        if done_round and rt.server.t % eval_every == 0:
            rt._log(now)
        if self.devices.alive[k]:
            self._push_free(now, "request", k)
        rt._drain_waiting(now, push_j, self.waiting[j])

    def _push_free(self, t, kind, k):
        self._push(t, kind, k, -1)

    # -- batched scheduler -------------------------------------------------
    def _run_batched(self, time_budget, max_rounds, eval_every):
        table = self.devices.event_table()
        n = self.cfg.n_devices
        self._resume()
        if not self._started:
            if n:
                table.time[:] = self.rng.uniform(0.0, 0.05, n)
                table.seq[:] = np.arange(n)
                table.kind[:] = KIND_IDS["request"]
                table.task[:] = -1
            self._seq = n
            self.waiting = [_FifoWaiting() for _ in self.runtimes]
            for rt in self.runtimes:
                rt._log(0.0)
                rt._started = True
            self._started = True
        spawned: List[Tuple] = []
        horizon = [(np.inf, np.inf)]   # (time, seq) of the batch's last event

        def make_push(j):
            def push(t, kind, k, payload=None, h=0):
                table.put(k, t, self._seq, kind, payload, h, task=j)
                if (t, self._seq) < horizon[0]:
                    heapq.heappush(spawned,
                                   (t, self._seq, kind, k, j, payload, h))
                self._seq += 1
            return push

        pushers = [make_push(j) for j in range(len(self.runtimes))]
        push_free = make_push(-1)
        self._push_free = lambda t, kind, k: push_free(t, kind, k)

        select_k = SCHEDULERS["batched"].SELECT_K
        now = self._now
        stop = False
        while not stop:
            sel = table.select_batch(select_k)
            if not len(sel):
                break
            ts = table.time[sel].tolist()
            ss = table.seq[sel].tolist()
            kinds = table.kind[sel].tolist()
            hs = table.h[sel].tolist()
            tks = table.task[sel].tolist()
            batch = [(ts[i], ss[i], KIND_NAMES[kinds[i]], k, tks[i],
                      table.payload[k], hs[i])
                     for i, k in enumerate(sel.tolist())]
            horizon[0] = (batch[-1][0], batch[-1][1])
            i, m = 0, len(batch)
            while i < m or spawned:
                if spawned and (i >= m or spawned[0][:2] < batch[i][:2]):
                    ev = heapq.heappop(spawned)
                else:
                    ev = batch[i]
                    i += 1
                now, _, kind, k, task, payload, h = ev
                live = self._live(max_rounds)
                if now > time_budget or not live:
                    stop = True   # boundary event stays in the table
                    break
                table.clear(k)
                if kind == "request":
                    if task < 0 or \
                            self.runtimes[task].server.t >= max_rounds:
                        task = self.assigner.assign(k, live)
                    self.runtimes[task]._handle_request(
                        now, k, pushers[task], self.waiting[task])
                elif self.runtimes[task].server.t >= max_rounds:
                    continue
                elif kind == "failure":
                    self.runtimes[task]._handle_failure(
                        now, k, payload, pushers[task], self.waiting[task])
                else:
                    self._on_arrival(task, now, k, payload, h, eval_every,
                                     pushers[task], batched=True)
            spawned.clear()
            horizon[0] = (np.inf, np.inf)
        del self._push_free        # restore the heap-path instance method
        return self._finish(now, time_budget)

    # -- wave scheduler (handler_mode="wave") ------------------------------
    def _run_wave(self, time_budget, max_rounds, eval_every):
        """Task-id-aware wave loop: the single-task wave machinery
        (``BatchedEngine._run_wave``) with the task column carried through.
        Same-kind runs are selected exactly like the serial batched loop,
        then partitioned per task id — unassigned requests (task=-1, and
        requests whose job already finished) are routed through the
        stateful assigner in event order first, so assignment decisions
        match the serial loop; each per-task sub-wave then dispatches
        through that runtime's ``_wave_requests`` / ``_wave_arrivals``.
        Cross-task ordering *within* one run is relaxed (sub-waves run in
        ascending task id, not interleaved event order) — task state is
        disjoint per runtime, so only the shared RNG/scenario draw order
        differs, which is already part of the wave contract.  A finished
        job's in-flight arrivals are consumed and dropped, exactly like the
        serial loops."""
        table = self.devices.event_table()
        n = self.cfg.n_devices
        self._resume()
        if not self._started:
            if n:
                table.time[:] = self.rng.uniform(0.0, 0.05, n)
                table.seq[:] = np.arange(n)
                table.kind[:] = KIND_IDS["request"]
                table.task[:] = -1
            self._seq = n
            self.waiting = [_FifoWaiting() for _ in self.runtimes]
            for rt in self.runtimes:
                rt._log(0.0)
                rt._started = True
            self._started = True
        # (time, seq, kind_id, device, task, payload, h)
        spawned: List[Tuple] = []
        horizon = [(np.inf, np.inf)]

        def make_push(j):
            def push(t, kind, k, payload=None, h=0):
                table.put(k, t, self._seq, kind, payload, h, task=j)
                if (t, self._seq) < horizon[0]:
                    heapq.heappush(spawned, (t, self._seq, KIND_IDS[kind],
                                             k, j, payload, h))
                self._seq += 1
            return push

        def make_push_wave(j):
            def push_wave(ts_w, ks_w, kind, payloads, h):
                g = len(ks_w)
                if not g:
                    return
                seqs = self._seq + np.arange(g)
                self._seq += g
                table.put_wave(ks_w, ts_w, seqs, kind, payloads, h, task=j)
                kid = KIND_IDS[kind]
                for w in np.flatnonzero(ts_w < horizon[0][0]).tolist():
                    heapq.heappush(spawned, (
                        float(ts_w[w]), int(seqs[w]), kid, int(ks_w[w]), j,
                        None if payloads is None else payloads[w], int(h)))
            return push_wave

        pushers = [make_push(j) for j in range(len(self.runtimes))]
        wavers = [make_push_wave(j) for j in range(len(self.runtimes))]
        push_free = make_push(-1)
        push_free_wave = make_push_wave(-1)
        self._push_free = lambda t, kind, k: push_free(t, kind, k)

        req_id, arr_id = KIND_IDS["request"], KIND_IDS["arrival"]
        select_k = SCHEDULERS["batched"].SELECT_K
        now = self._now
        stop = False
        while not stop:
            sel = table.select_batch(select_k)
            if not len(sel):
                break
            ts = table.time[sel]
            ss = table.seq[sel]
            kinds = table.kind[sel]
            hs = table.h[sel]
            tks = table.task[sel]
            payloads = [table.payload[k] for k in sel.tolist()]
            horizon[0] = (float(ts[-1]), int(ss[-1]))
            bounds = np.flatnonzero(np.diff(kinds) != 0) + 1
            i, m, b = 0, len(sel), 0
            while i < m or spawned:
                if not spawned:
                    while b < len(bounds) and bounds[b] <= i:
                        b += 1
                    j_end = int(bounds[b]) if b < len(bounds) else m
                    wts, wks = ts[i:j_end], sel[i:j_end]
                    wtk, whs = tks[i:j_end], hs[i:j_end]
                    wps = payloads[i:j_end]
                    kid = int(kinds[i])
                    i = j_end
                else:
                    rt_l: List[float] = []
                    rk_l: List[int] = []
                    rj_l: List[int] = []
                    rp_l: List[Any] = []
                    rh_l: List[int] = []
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
                            rt_l.append(e[0])
                            rk_l.append(e[3])
                            rj_l.append(e[4])
                            rp_l.append(e[5])
                            rh_l.append(e[6])
                        elif i < m:
                            if kid < 0:
                                kid = int(kinds[i])
                            elif int(kinds[i]) != kid:
                                break
                            rt_l.append(float(ts[i]))
                            rk_l.append(int(sel[i]))
                            rj_l.append(int(tks[i]))
                            rp_l.append(payloads[i])
                            rh_l.append(int(hs[i]))
                            i += 1
                        else:
                            break
                    wts = np.asarray(rt_l, np.float64)
                    wks = np.asarray(rk_l, np.int64)
                    wtk = np.asarray(rj_l, np.int64)
                    wps, whs = rp_l, np.asarray(rh_l, np.int64)
                live = self._live(max_rounds)
                if not live:
                    stop = True
                    break
                # partial budget cut: keep draining — the prefix spawns
                # re-requests still inside the budget, which serial order
                # grants before stopping (see BatchedEngine._run_wave)
                cut = int(np.searchsorted(wts, time_budget, side="right"))
                if cut < len(wts):
                    stop = True
                    if not cut:
                        break
                    wts, wks, wtk = wts[:cut], wks[:cut], wtk[:cut]
                    wps, whs = wps[:cut], whs[:cut]
                table.clear_wave(wks)
                if kid == req_id:
                    wtk = np.asarray(wtk, np.int64).copy()
                    for idx in range(len(wtk)):
                        tj = int(wtk[idx])
                        if tj < 0 or \
                                self.runtimes[tj].server.t >= max_rounds:
                            wtk[idx] = self.assigner.assign(int(wks[idx]),
                                                            live)
                    for tj in np.unique(wtk).tolist():
                        s = wtk == tj
                        self.runtimes[tj]._wave_requests(
                            wts[s], wks[s], pushers[tj], wavers[tj],
                            self.waiting[tj])
                elif kid == arr_id:
                    for tj in np.unique(wtk).tolist():
                        rt = self.runtimes[tj]
                        if rt.server.t >= max_rounds:
                            continue     # consumed + dropped, like serial
                        s = wtk == tj
                        sub_ps = [p for p, mm in zip(wps, s.tolist()) if mm]
                        if getattr(rt.strategy, "arrival_wave", False):
                            rt._wave_arrivals(
                                wts[s], wks[s], sub_ps, whs[s], eval_every,
                                pushers[tj], wavers[tj], self.waiting[tj],
                                push_wave_free=push_free_wave,
                                max_rounds=max_rounds)
                        else:
                            sis = np.flatnonzero(s).tolist()
                            for idx in sis:
                                if rt.server.t >= max_rounds:
                                    break
                                self._on_arrival(
                                    tj, float(wts[idx]), int(wks[idx]),
                                    wps[idx], int(whs[idx]), eval_every,
                                    pushers[tj], batched=True)
                else:
                    for idx in range(len(wks)):
                        tj = int(wtk[idx])
                        if self.runtimes[tj].server.t >= max_rounds:
                            continue
                        self.runtimes[tj]._handle_failure(
                            float(wts[idx]), int(wks[idx]), wps[idx],
                            pushers[tj], self.waiting[tj])
                if not stop:
                    now = float(wts[-1])
            spawned.clear()
            horizon[0] = (np.inf, np.inf)
        if stop:
            # resume cursor = earliest unprocessed event (serial loops
            # break ON that event); empty slots hold +inf
            rem = float(table.time.min()) if n else np.inf
            if np.isfinite(rem):
                now = rem
        del self._push_free
        return self._finish(now, time_budget)

    # -- checkpoint/resume -------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """Full fleet state: the shared pieces once (RNG streams, registry,
        event queue/table, per-task waiting queues, assigner) plus each
        runtime's core (``FLEngine._core_state``) and deferred cohort
        buffers.  Same plain-ndarray format as ``FLEngine.state_dict`` —
        feed to ``repro_torch.checkpoint.io.save_blob``; restore with
        :meth:`load_state` on a freshly built identical fleet."""
        regs = [({}, []) for _ in self.runtimes]
        state = {
            "version": 1,
            "rng": _pack_rng(self.rng),
            "scenario_rng": _pack_rng(self.scenario_rng),
            "devices": _pack_devices(self.devices),
            "started": bool(self._started),
            "now": float(self._now),
            "seq": int(self._seq),
            "assigner": self.assigner.state_dict(),
            "tasks": [rt._core_state(regs[j])
                      for j, rt in enumerate(self.runtimes)],
        }
        if self.cfg.scheduler == "batched":
            tab, table = self.devices.events, None
            if tab is not None:
                live = np.flatnonzero(tab.time < np.inf).tolist()
                table = [[int(k), float(tab.time[k]), int(tab.seq[k]),
                          int(tab.kind[k]), int(tab.h[k]), int(tab.task[k]),
                          self._pack_ev_payload(int(tab.task[k]),
                                                tab.payload[k], regs)]
                         for k in live]
            state["sched"] = {"table": table}
            state["waiting"] = [[int(x) for x in w._items[w._head:]]
                                for w in self.waiting]
        else:
            events = None
            if self._events is not None:
                events = [[float(t), int(s), kind, int(k), int(j),
                           self._pack_ev_payload(int(j), p, regs), int(h)]
                          for t, s, kind, k, j, p, h in self._events]
            state["sched"] = {"events": events}
            state["waiting"] = [[int(x) for x in w] for w in self.waiting]
        state["pending"] = [rt._pack_pending(regs[j])
                            for j, rt in enumerate(self.runtimes)]
        return state

    def _pack_ev_payload(self, j: int, payload: Any, regs) -> List[Any]:
        # unassigned (task = -1) events are requests with no payload; route
        # them through runtime 0's packer for a well-formed ["none"] tag
        j = max(j, 0)
        return self.runtimes[j]._pack_payload(payload, regs[j])

    def load_state(self, state: Dict[str, Any]) -> None:
        if int(state["version"]) != 1:
            raise ValueError(
                f"unknown fleet checkpoint version {state['version']!r}")
        _load_rng(self.rng, state["rng"])
        _load_rng(self.scenario_rng, state["scenario_rng"])
        _load_devices(self.devices, state["devices"])
        self._started = bool(state["started"])
        self._now = float(state["now"])
        self._seq = int(state["seq"])
        self.assigner.load_state(state["assigner"])
        ptss = [rt._unpack_pending(state["pending"][j])
                for j, rt in enumerate(self.runtimes)]
        for j, rt in enumerate(self.runtimes):
            rt._load_core(state["tasks"][j], ptss[j])
        if self.cfg.scheduler == "batched":
            tab = self.devices.event_table()
            tab.time[:] = np.inf
            tab.payload = [None] * len(tab.time)
            if state["sched"]["table"] is not None:
                for k, t, seq, kind, h, task, p in state["sched"]["table"]:
                    k, task = int(k), int(task)
                    tab.time[k] = float(t)
                    tab.seq[k] = int(seq)
                    tab.kind[k] = int(kind)
                    tab.h[k] = int(h)
                    tab.task[k] = task
                    tab.payload[k] = self._unpack_ev_payload(task, p, ptss)
            self.waiting = []
            for items in state["waiting"]:
                w = _FifoWaiting()
                w._items = [int(x) for x in items]
                self.waiting.append(w)
        else:
            ev = state["sched"]["events"]
            self._events = None if ev is None else [
                (float(t), int(s), str(kind), int(k), int(j),
                 self._unpack_ev_payload(int(j), p, ptss), int(h))
                for t, s, kind, k, j, p, h in ev]
            self.waiting = [[int(x) for x in w] for w in state["waiting"]]

    def _unpack_ev_payload(self, j: int, packed, ptss) -> Any:
        j = max(j, 0)
        return self.runtimes[j]._unpack_payload(packed, ptss[j])


def build_fleet(cfg: FleetConfig, *, iid: bool = True, n_train: int = 600,
                n_test: int = 200, device=None,
                init_params: Optional[Sequence[Dict[str, Any]]] = None
                ) -> MultiTaskEngine:
    """One-call fleet constructor: each job's (data, partitions, w0) from
    ``repro_torch.fl.protocols.make_setup``, with per-job data seeds offset
    by the job index so that jobs do not share datasets, every job on
    ``device`` (the card unless the caller names another).
    ``init_params[i]``, when given, is job i's initial weights (e.g. the
    JAX package's, as numpy), carried over unchanged."""
    from repro_torch.fl.protocols import make_setup
    datas, parts, w0s = [], [], []
    for i in range(len(cfg.tasks)):
        spec = cfg.resolve(i)
        data, p, w0 = make_setup(
            cfg.n_devices, iid, cfg.seed + i, n_train, n_test, spec.task,
            device=device,
            init_params=None if init_params is None else init_params[i])
        datas.append(data)
        parts.append(p)
        w0s.append(w0)
    return MultiTaskEngine(datas, parts, w0s, cfg, device=device)
