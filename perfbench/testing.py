"""Helpers of the benchmark's CPU tests: a cell's run on the CPU at its
configuration's ``test_model`` sizes, with the harness's look for a card
skipped."""
from __future__ import annotations

import time
from typing import Optional

from perfbench import harness

TEST_BATCH, TEST_SEQ = 8, 64


def cpu_spec(workload: str, seed: int = 20260, seconds: float = 0.2,
             batch: int = TEST_BATCH, seq: int = TEST_SEQ) -> harness.Spec:
    bench = harness.load_benchmark()
    cell, traffic, config = harness.resolve(bench, workload)
    config = dict(config, model=config["test_model"])
    traffic = dict(traffic, batch=batch, seq=seq)
    return harness.Spec(workload, seed, seconds, False, "cpu", cell, traffic,
                        config, time.perf_counter(), lambda msg: None)


def cpu_run(workload: str, fault: Optional[str] = None, **kw):
    """-> (the run's Result, its result line)."""
    spec = cpu_spec(workload, **kw)
    res = harness.run_cell(spec, fault=fault)
    line = harness.result_line(harness.load_benchmark(), spec, res,
                               {"platform": "cpu"})
    return res, line
