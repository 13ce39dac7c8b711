"""Milliseconds a round of the compressor, ``gather_q``'s call of
``ops.threshold_channel_leaves`` (kernel B's channel form), by CUDA
events that the harness records around each call in a traced run's
window."""


def read(res, spec):
    if not res.channel_ms or not res.rounds:
        return None
    return sum(res.channel_ms) / res.rounds
