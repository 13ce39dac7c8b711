"""One run of one cell: find it by name, check the card, run its runner,
read its metrics, print the result.

``BENCHMARK.json`` names the cell; the cell's file
(``workloads/<cell>.json``) names its runner and traffic, the
configuration's file its sizes and reference, and each metric is read by
``metrics/<metric>.py``'s ``read(result, spec)``, which returns None
where it finds nothing to read (the metric is then left out of the
line).  With ``--trace 0`` the line holds the cell's end-to-end metrics,
with ``--trace 1`` its per-layer ones.

The last lines of standard error, and the last key of the result line,
give each number the check compared beside its limit.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Spec:
    """What a runner needs of one run."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: str
    cell: Dict
    traffic: Dict
    config: Dict
    t_start: float
    log: Callable[[str], None]


@dataclass
class Result:
    """What one run of a cell measured and found; a runner's own result
    adds what its metrics read besides."""
    setup_s: float = 0.0
    window_s: float = 0.0
    rounds: int = 0
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    window_peak_bytes: int = 0
    trace: object = None            # perfbench.devtrace.Window
    trace_rounds: int = 0
    found: Dict = field(default_factory=dict)
    checks: Dict = field(default_factory=dict)
    correct: bool = False


class ProfilerLoss(RuntimeError):
    """The profiler lost device records in every profiled window: a
    runner raises it, and the run gives no result."""


def make_log(t0: float) -> Callable[[str], None]:
    """A writer of lines on standard error, each stamped with the seconds
    since ``t0`` (``time.perf_counter``)."""
    def log(msg: str) -> None:
        print(f"[perfbench {time.perf_counter() - t0:7.2f} s] {msg}",
              file=sys.stderr, flush=True)
    return log


def load_benchmark(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def resolve(bench: Dict, workload: str, root: Path = ROOT):
    """-> (the cell's entry, its traffic file, its configuration file),
    each found by name."""
    cells = [w for w in bench["workloads"] if w["name"] == workload]
    if len(cells) != 1:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json")
    cell = cells[0]
    configs = [c for c in bench["configs"] if c["name"] == cell["config"]]
    if len(configs) != 1:
        raise KeyError(f"no configuration {cell['config']!r}")
    with open(root / "perfbench" / "workloads" / f"{workload}.json") as f:
        traffic = json.load(f)
    with open(root / configs[0]["file"]) as f:
        config = json.load(f)
    for key in ("config", "traffic"):
        if traffic[key] != cell[key]:
            raise ValueError(f"{workload}: the cell's file names {key} "
                             f"{traffic[key]!r}, BENCHMARK.json "
                             f"{cell[key]!r}")
    return cell, traffic, config


def metrics_of(bench: Dict, workload: str, trace: bool) -> List[Dict]:
    """The cell's metrics for this kind of run: those without a
    ``workloads`` list, and those whose list names the cell."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader(name: str):
    return importlib.import_module(f"perfbench.metrics.{name}")


def jax_modules(names: Optional[List[str]] = None) -> List[str]:
    """Of ``names`` (the loaded modules by default) those whose top-level
    name is one of :data:`FORBIDDEN`, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def run_cell(spec: Spec, fault: Optional[str] = None):
    """Run the cell's runner -> its Result."""
    from perfbench.runners import runner
    return runner(spec.traffic["runner"]).run(spec, fault=fault)


def result_line(bench: Dict, spec: Spec, res, device: Dict) -> Dict:
    metrics = {}
    for m in metrics_of(bench, spec.workload, spec.trace):
        value = reader(m["name"]).read(res, spec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": bool(res.correct), "attempted": res.attempted,
            "failed": res.failed, "metrics": metrics, "device": device}
    if spec.trace and res.trace is not None:
        line["breakdown"] = {"device_ops": res.trace.device_ops(10),
                             "idle_gaps": [[k, v] for k, v in
                                           res.trace.idle_gaps]}
    line["checks"] = {k: {"value": _num(c["value"]), "limit": c["limit"]}
                      for k, c in res.checks.items()}
    return line


def _num(x: float):
    return x if math.isfinite(x) else str(x)


def parse(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None,
         t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    log = make_log(t_start)
    args = parse(argv)
    bench = load_benchmark()
    cell, traffic, config = resolve(bench, args.workload)
    if importlib.util.find_spec("repro_torch") is None:
        log("the port (src/repro_torch) is not beside the benchmark: "
            "no result")
        return 2
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        log(f"this cell needs {cell['chips']} CUDA device(s); "
            f"{have} available: no result")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    spec = Spec(args.workload, args.seed, args.seconds, bool(args.trace),
                "cuda", cell, traffic, config, t_start, log)
    try:
        res = run_cell(spec)
    except ProfilerLoss as e:
        log(f"{e}: no result")
        return 3
    found = jax_modules()
    if found:
        log(f"modules of JAX or of the JAX package were loaded: {found}")
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": int(res.memory_peak_bytes)}
    if spec.trace:
        device["busy_s"] = res.trace.busy_s
        device["window_s"] = res.trace.window_s
    line = result_line(bench, spec, res, device)
    from perfbench.check import format_checks
    for text in format_checks(res.checks, res.found):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
