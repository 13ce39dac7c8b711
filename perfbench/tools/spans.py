"""Run one cell traced, as ``perfbench/run.py --trace 1`` runs it, then
read the port's spans of its profiled rounds (``repro_torch.utils.spans``)
and print one more JSON line: per span name its count, device ms and self
device ms a round; ``fed.round``'s self share of its device time; its
device ms over the window's busy device ms (the profiler's records); and
the share of that busy time the five span metrics and ``fed.compress``
account for.

    python3 perfbench/tools/spans.py --workload <cell> --seed <n> \\
        --seconds <s>
"""
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[2]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from perfbench import use_checkout_caches  # noqa: E402

use_checkout_caches(ROOT)

from perfbench import harness  # noqa: E402

# the spans the metrics read, and fed.compress: together the round
PARTS = (("lm.loss", False), ("remat.recompute", False), ("fed.grad", True),
         ("fed.prox", False), ("fed.combine", True), ("fed.compress", False))


def summary(rounds, busy_s: float):
    n = len(rounds)
    names = sorted({k for r in rounds for k in r.counts})
    spans = {k: {"count": sum(r.counts.get(k, 0) for r in rounds) / n,
                 "ms": sum(r.device_ms(k) or 0.0 for r in rounds) / n,
                 "self_ms": sum(r.device_ms(k, own=True) or 0.0
                                for r in rounds) / n} for k in names}
    whole = spans["fed.round"]
    parts = sum(spans.get(k, {}).get("self_ms" if own else "ms", 0.0)
                for k, own in PARTS)
    busy_ms = 1000.0 * busy_s / n
    return {"rounds": n, "spans": spans,
            "round_self_share": whole["self_ms"] / whole["ms"],
            "round_over_busy": whole["ms"] / busy_ms,
            "parts_over_busy": parts / busy_ms}


def main(argv=None) -> int:
    got = {}
    run_cell = harness.run_cell

    def keep(spec, fault=None):
        got["res"] = run_cell(spec, fault)
        return got["res"]

    harness.run_cell = keep
    argv = list(sys.argv[1:] if argv is None else argv) + ["--trace", "1"]
    rc = harness.main(argv, T_START)
    res = got.get("res")
    if rc or res is None or res.trace is None:
        return rc or 1
    from repro_torch.utils import spans
    rounds = spans.rounds()[-res.trace_rounds:]
    print(json.dumps(summary(rounds, res.trace.busy_s)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
