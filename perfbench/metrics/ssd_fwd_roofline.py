"""Kernel C (the SSD's intra-chunk step, forward) against its bound: the
bound of one launch at the round's cells (``work/kernels.py``, split TF32
on the tensor cores, or bytes) over its device time a launch, from the
profiled window."""
from perfbench.work.kernels import ssd_fwd_bound_s
from perfbench.work.shapes import ssd_call


def read(res, spec):
    win = res.trace
    if win is None:
        return None
    n = win.launches("ssd_scan_kernel")
    device_s = win.device_s("ssd_scan_kernel")
    if not n or device_s <= 0:
        return None
    return 100.0 * n * ssd_fwd_bound_s(*ssd_call(spec)) / device_s
