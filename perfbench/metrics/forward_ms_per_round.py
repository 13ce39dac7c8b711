"""Milliseconds a round of the forward pass: the device time of the
port's ``lm.loss`` spans, one a local step (the layers and the chunked
loss, their activations not kept under remat), over the profiled
rounds."""
from perfbench.spans import ms_per_round


def read(res, spec):
    return ms_per_round(res, spec, "lm.loss")
