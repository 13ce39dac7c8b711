"""Milliseconds a round of the prox-SGD update (Eq. 5): the device time
of the port's ``fed.prox`` spans, one a local step, over the profiled
rounds."""
from perfbench.spans import ms_per_round


def read(res, spec):
    return ms_per_round(res, spec, "fed.prox")
