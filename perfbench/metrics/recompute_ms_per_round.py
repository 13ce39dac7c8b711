"""Milliseconds a round of remat's recompute: the device time of the
port's ``remat.recompute`` spans, each the rerun of one layer or loss
chunk in the backward pass before its vector-Jacobian product, over the
profiled rounds."""
from perfbench.spans import ms_per_round


def read(res, spec):
    return ms_per_round(res, spec, "remat.recompute")
