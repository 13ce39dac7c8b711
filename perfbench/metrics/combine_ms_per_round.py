"""Milliseconds a round of the combine: the self device time of the
port's ``fed.combine`` span (the deltas, the staleness weights of Eqs.
6-10, the weighted sum, the new params and the delta's norm; its child
``fed.compress``, the channel, left out), over the profiled rounds."""
from perfbench.spans import ms_per_round


def read(res, spec):
    return ms_per_round(res, spec, "fed.combine", own=True)
