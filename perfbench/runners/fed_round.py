"""The TEASQ-Fed datacenter round of the port, one chip.

The window drives ``repro_torch.core.fed_step.make_fed_train_step`` with
``lm_loss`` (and the cell's ``loss`` options) as ``launch/train.py --mode
fed`` calls it: one round a call, ``torch.cuda.synchronize()`` after each
round, each round on a new token batch and a new staleness vector from
the feed.

Set-up: the port's modules, the benchmark's weights on the device, the
round, and its first :data:`CHECKED_ROUNDS` rounds on the feed (they warm
every shape the window runs, and their readings are the program's side of
the check).  Then the window: rounds until ``--seconds`` have passed,
the rate taken over all of them.  A ``--trace 1`` run also times each
call of the compressor (kernel B's channel form) with CUDA events in its
window, then profiles :data:`TRACE_ROUNDS` more rounds (again once where
the profiler lost records).  Last, with the program's state freed, the
reference follows the checked rounds (``perfbench.check``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from perfbench import check, reference
from perfbench.feed import RoundFeed, weight_generator
from perfbench.harness import ProfilerLoss, Result
from perfbench.reference.fed_round import fed_round, flatten, unflatten

# faults a test or a control reading may plant in the program's round
FAULTS = ("unchanged", "half_batch", "leaf_unmoved", "leaf_double")
# profiled windows a traced run makes at most before it gives no result
TRACE_ATTEMPTS = 2
# rounds that set-up drives and the reference follows: the reference takes
# about 4x the port's time a round, so two keep it near the window
CHECKED_ROUNDS = 2
# rounds a profiled window holds: a round of 13-16 s at the cells' sizes
# runs every kernel the metrics read
TRACE_ROUNDS = 1


def round_settings(traffic: Dict) -> Dict:
    """The round's settings of a cell's file; ``loss`` holds the keyword
    arguments of the port's ``lm_loss`` (``remat``, ``loss_chunk``)."""
    keys = ("groups", "local_steps", "lr", "mu", "alpha", "a", "p_s", "p_q",
            "schedule", "threshold_iters")
    out = {k: traffic[k] for k in keys}
    out["loss"] = traffic.get("loss", {})
    return out


def half_rows(tokens):
    """The first half of a microbatch's tokens: its first rows, or, for
    one row, the first half of its positions."""
    if tokens.shape[0] >= 2:
        return tokens[:tokens.shape[0] // 2]
    return tokens[:, :tokens.shape[1] // 2]


class Program:
    """The port's round as the window calls it; ``fault`` plants one of
    :data:`FAULTS`."""

    def __init__(self, model: Dict, fed: Dict, fault: Optional[str] = None):
        from repro_torch.configs.base import ModelConfig
        from repro_torch.core.fed_step import FedConfig, make_fed_train_step
        from repro_torch.models import transformer as T
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        cfg = ModelConfig(**model)
        cut = half_rows if fault == "half_batch" else (lambda t: t)
        opts = fed.get("loss", {})

        def loss(p, b):
            return T.lm_loss(p, {"tokens": cut(b["tokens"])}, cfg, **opts)[0]

        self.step = make_fed_train_step(loss, FedConfig(
            n_groups=fed["groups"], local_steps=fed["local_steps"],
            lr=fed["lr"], mu=fed["mu"], alpha=fed["alpha"], a=fed["a"],
            p_s=fed["p_s"], p_q=fed["p_q"], schedule=fed["schedule"],
            threshold_iters=fed["threshold_iters"]))
        self.fault = fault

    def __call__(self, params, tokens, stale):
        new, m = self.step(params, {"tokens": tokens}, stale)
        if self.fault == "unchanged":
            return params, m
        if self.fault in ("leaf_unmoved", "leaf_double"):
            pairs = flatten(new)
            old = dict(flatten(params))
            i = max(range(len(pairs)), key=lambda j: pairs[j][1].numel())
            p, v = pairs[i]
            pairs[i] = (p, old[p] if self.fault == "leaf_unmoved"
                        else 2 * v - old[p])
            new = unflatten(pairs)
        return new, m


def counters() -> Dict[str, int]:
    """The port's launch counters of kernels B and C."""
    from repro_torch.kernels import ssd_scan, topk_quant
    return {"channel": topk_quant.LAUNCHES, "ssd_fwd": ssd_scan.LAUNCHES,
            "ssd_bwd": ssd_scan.BWD_LAUNCHES}


# the kernel that ends each counted call: B's plan entries end in the
# cluster kernel or the wide route's store; C's backward calls in its
# rows pass or its small route
COUNTED = {"channel": ("topk_quant_kernel", "topk_quant_wide_store"),
           "ssd_fwd": ("ssd_scan_kernel",),
           "ssd_bwd": ("ssd_bwd_rows", "ssd_bwd_small")}


class ChannelTimer:
    """CUDA events around each call of ``ops.threshold_channel_leaves``,
    which ``fed_step`` looks up at call time; installed for a traced
    run's window only."""

    def __init__(self):
        self.pairs: List = []
        self._orig = None

    def install(self):
        import torch
        from repro_torch.kernels import ops
        orig = self._orig = ops.threshold_channel_leaves

        def timed(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function("channel"):
                a.record()
                out = orig(*args, **kwargs)
                b.record()
            self.pairs.append((a, b))
            return out

        ops.threshold_channel_leaves = timed

    def remove(self):
        from repro_torch.kernels import ops
        if self._orig is not None:
            ops.threshold_channel_leaves = self._orig
            self._orig = None

    def ms(self) -> List[float]:
        return [a.elapsed_time(b) for a, b in self.pairs]


@dataclass
class RoundResult(Result):
    """A fed-round run's result: the harness's, and what the round's
    metrics read besides."""
    tokens_per_round: int = 0
    param_count: int = 0
    n_leaves: int = 0
    channel_ms: List[float] = field(default_factory=list)
    trace_calls: Dict[str, int] = field(default_factory=dict)


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def program_readings(step: Callable, params, feed, rounds: int, sync,
                     log=lambda msg: None):
    """Drive ``step`` through the checked rounds -> (params after them,
    the program's readings)."""
    w0 = {p: v.clone() for p, v in flatten(params)}
    w0 = unflatten(w0.items())
    r = None
    for i in range(rounds):
        tokens, stale = feed.next()
        params, m = step(params, tokens, stale)
        sync()
        if r is None:
            names, upd = check.leaf_norms(params, w0)
            r = check.Readings(names, update=upd)
        r.losses.append(float(m["local_loss"]))
        log(f"checked round {i + 1}: local loss {r.losses[-1]!r}")
    r.change = check.leaf_norms(params, w0)[1]
    return params, r


def reference_readings(spec, rounds: int, mode: str = "f32",
                       fault: Optional[str] = None) -> check.Readings:
    """The reference through the checked rounds from the seed's weights
    and feed.  ``mode``: ``f32``; ``tf32`` (each product's operands
    rounded to TF32); ``tf32_card`` (the card's TF32 switched on).
    ``fault``: ``half_batch`` plants that fault in the reference."""
    import torch
    from perfbench.reference import layers
    ref = reference.model(spec.config["reference"])
    model = spec.config["model"]
    fed = round_settings(spec.traffic)
    dev = torch.device(spec.device)
    w0 = ref.init_params(model, weight_generator(spec.seed, dev))
    feed = RoundFeed(spec.seed, spec.traffic, model["vocab"], dev)
    cut = half_rows if fault == "half_batch" else (lambda t: t)

    def loss_fn(p, tokens):
        return ref.lm_loss(p, cut(tokens), model)

    before = (layers.PRECISION["mode"],
              torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    layers.PRECISION["mode"] = "tf32" if mode == "tf32" else "f32"
    if mode == "tf32_card":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    try:
        w, r = w0, None
        for i in range(rounds):
            tokens, stale = feed.next()
            w, loss, grad_norms = fed_round(loss_fn, w, tokens,
                                            stale.tolist(), fed)
            if r is None:
                names, upd = check.leaf_norms(w, w0)
                r = check.Readings(names, update=upd, grad_norms=grad_norms)
            r.losses.append(loss)
        r.change = check.leaf_norms(w, w0)[1]
    finally:
        (layers.PRECISION["mode"], torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
    return r


def _guard(win, deltas: Dict[str, int]) -> List[str]:
    """Where the profiler holds fewer records of B's and C's calls than
    the port's counters made."""
    return [f"{k}: {win.launches(*COUNTED[k])} records of {deltas[k]} "
            f"calls" for k in COUNTED if win.launches(*COUNTED[k]) <
            deltas[k]]


def run(spec, fault: Optional[str] = None) -> RoundResult:
    """One run of a fed-round cell (the module docstring)."""
    import torch
    from perfbench import devtrace as tr
    dev = torch.device(spec.device)
    model, traffic = spec.config["model"], spec.traffic
    if traffic.get("world", 1) != 1:
        raise ValueError("the fed_round runner runs the round on one card; "
                         "a mesh cell needs a runner of its own")
    fed = round_settings(traffic)
    ref = reference.model(spec.config["reference"])
    res = RoundResult(tokens_per_round=traffic["batch"] * traffic["seq"])
    log = spec.log

    step = Program(model, fed, fault)
    log("the port is imported")
    params = ref.init_params(model, weight_generator(spec.seed, dev))
    leaves = flatten(params)
    res.param_count = sum(v.numel() for _, v in leaves)
    res.n_leaves = len(leaves)
    del leaves
    feed = RoundFeed(spec.seed, traffic, model["vocab"], dev)
    _sync(dev)
    log("the weights are made")
    params, prog = program_readings(step, params, feed,
                                    CHECKED_ROUNDS,
                                    lambda: _sync(dev), log)

    timer = ChannelTimer() if spec.trace and dev.type == "cuda" else None
    if timer:
        timer.install()
    losses = []
    if dev.type == "cuda":
        res.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res.setup_s = t0 - spec.t_start
    while True:
        tokens, stale = feed.next()
        params, m = step(params, tokens, stale)
        _sync(dev)
        losses.append(m["local_loss"])
        res.rounds += 1
        t1 = time.perf_counter()
        if t1 - t0 >= spec.seconds:
            break
    res.window_s = t1 - t0
    res.attempted = res.rounds
    res.failed = int((~torch.isfinite(torch.stack(losses))).sum())
    if dev.type == "cuda":
        res.window_peak_bytes = torch.cuda.max_memory_allocated(dev)
        res.memory_peak_bytes = max(res.memory_peak_bytes,
                                    res.window_peak_bytes)
    if timer:
        _sync(dev)
        res.channel_ms = timer.ms()
    log(f"window: {res.rounds} rounds in {res.window_s:.3f} s")

    if spec.trace and dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile, record_function
        n = TRACE_ROUNDS
        for attempt in range(TRACE_ATTEMPTS):
            before = counters()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function(tr.WINDOW_SPAN):
                    for _ in range(n):
                        with record_function("batch copy"):
                            tokens, stale = feed.next()
                        with record_function("round"):
                            params, m = step(params, tokens, stale)
                        with record_function("synchronize"):
                            _sync(dev)
            after = counters()
            deltas = {k: after[k] - before[k] for k in after}
            win = tr.read_window(prof.profiler.kineto_results.events())
            short = _guard(win, deltas)
            if not short:
                break
            log("the profiler lost device records (" + "; ".join(short)
                + ")" + (": profiling again" if attempt + 1 <
                         TRACE_ATTEMPTS else ""))
        else:
            raise ProfilerLoss("the profiler lost device records in every "
                               "profiled window")
        res.trace, res.trace_rounds, res.trace_calls = win, n, deltas
        parts = {"B": "topk_quant", "C": "ssd_scan_kernel",
                 "C's backward": "ssd_bwd_"}
        log(f"profiled {n} rounds: busy {win.busy_s:.4f} s of "
            f"{win.window_s:.4f} s; device s " + ", ".join(
                f"{k} {win.device_s(v):.5f}" for k, v in parts.items())
            + f"; calls {deltas}")
    if timer:
        timer.remove()

    del params, step, m, losses, tokens, stale, feed
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    refr = reference_readings(spec, CHECKED_ROUNDS)
    log(f"reference: local losses {refr.losses} "
        f"({time.perf_counter() - t_ref:.1f} s)")
    out = check.excluded(refr)
    if out:
        log(f"left out of the leaf numbers (gradient nought to rounding): "
            f"{out}")
    res.found = check.gaps(prog, refr)
    log("every number: " + ", ".join(
        f"{k} {v['value']:.3e} ({v['at']})" for k, v in res.found.items()))
    ok, res.checks = check.judge(res.found, traffic["limits"])
    res.correct = ok and res.failed == 0
    return res

