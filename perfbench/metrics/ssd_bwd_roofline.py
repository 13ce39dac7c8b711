"""Kernel C's backward against its bound: the bound of one call at the
round's cells (``work/kernels.py``; split TF32 on the tensor cores, or f32
FMAs where the trace shows the small-chunk route) over the device time of
its kernels a call, from the profiled window."""
from perfbench.work.kernels import ssd_bwd_bound_s
from perfbench.work.shapes import ssd_call


def read(res, spec):
    win = res.trace
    calls = res.trace_calls.get("ssd_bwd", 0)
    if win is None or not calls:
        return None
    device_s = win.device_s("ssd_bwd_")
    if device_s <= 0:
        return None
    tensor_cores = win.launches("ssd_bwd_small") == 0
    return 100.0 * calls * ssd_bwd_bound_s(
        *ssd_call(spec), tensor_cores=tensor_cores) / device_s
