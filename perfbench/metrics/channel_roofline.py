"""Kernel B's channel form against its bound: the bound of one call at
the round's rows (every group's delta of every leaf; ``work/kernels.py``:
8 bytes and 17 operations a value) over the device time of B's kernels a
call, from the profiled window."""
from perfbench.work.kernels import channel_bound_s


def read(res, spec):
    win = res.trace
    calls = res.trace_calls.get("channel", 0)
    if win is None or spec.traffic["schedule"] != "gather_q" or not calls:
        return None
    device_s = win.device_s("topk_quant")
    if device_s <= 0:
        return None
    rounds = res.trace_rounds
    values = spec.traffic["groups"] * res.param_count
    rows = spec.traffic["groups"] * res.n_leaves
    return 100.0 * rounds * channel_bound_s(values, rows) / device_s
