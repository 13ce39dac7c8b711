"""Seconds from the start of the process to the first timed round:
imports, the kernel library (built into the checkout's ``build/`` at the
first run, loaded after), the weights, the checked rounds that warm every
shape, and the check's own set-up (host clock)."""


def read(res, spec):
    return res.setup_s
