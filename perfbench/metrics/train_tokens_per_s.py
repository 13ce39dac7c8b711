"""Tokens trained a second over the whole window: rounds completed times
the batch's tokens, over the window's seconds from its start to the end
of its last round (host clock, each round synchronized).  A stall lowers
it."""


def read(res, spec):
    if not res.rounds:
        return None
    return res.rounds * res.tokens_per_round / res.window_s
