"""Milliseconds a round of the backward pass: the self device time of
the port's ``fed.grad`` spans, one a local step (the step's gradient
less its forward pass, ``lm.loss``, and its recomputes,
``remat.recompute``), over the profiled rounds."""
from perfbench.spans import ms_per_round


def read(res, spec):
    return ms_per_round(res, spec, "fed.grad", own=True)
