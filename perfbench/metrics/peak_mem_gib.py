"""The card's peak of allocated memory over the window, in GiB:
``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``
at the window's start."""


def read(res, spec):
    if not res.window_peak_bytes:
        return None
    return res.window_peak_bytes / 2 ** 30
