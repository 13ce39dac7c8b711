"""The profiled window's share in which the card ran nothing: 1 minus the
union of its kernels', copies' and sets' intervals over the window."""


def read(res, spec):
    win = res.trace
    if win is None or win.window_s <= 0 or win.busy_s <= 0:
        return None
    return 100.0 * (1.0 - win.busy_s / win.window_s)
