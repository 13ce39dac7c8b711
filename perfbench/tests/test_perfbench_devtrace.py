"""The profiled window's reader on made-up events: busy time as a union,
kernels by name, idle gaps named by the host's span and operator, and
events of builds of PyTorch that do and do not record their kind."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import devtrace as tr  # noqa: E402
from perfbench.runners.fed_round import COUNTED, _guard  # noqa: E402


class Event:
    def __init__(self, name, device, start, end, corr=0, kind=None):
        self._n, self._d, self._s, self._e, self._c = (name, device, start,
                                                       end, corr)
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType." + self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def correlation_id(self):
        return self._c


def window(with_kinds):
    k = (lambda x: x) if with_kinds else (lambda x: None)
    return [
        Event(tr.WINDOW_SPAN, "CPU", 0, 1000, kind=k("user_annotation")),
        Event("round", "CPU", 10, 800, kind=k("user_annotation")),
        Event("aten::mm", "CPU", 20, 60, kind=k("cpu_op")),
        Event("cudaLaunchKernel", "CPU", 30, 40, corr=1,
              kind=k("cuda_runtime")),
        Event("aten::add", "CPU", 300, 340, kind=k("cpu_op")),
        Event("cudaLaunchKernel", "CPU", 310, 320, corr=2,
              kind=k("cuda_runtime")),
        Event("round", "CUDA", 10, 800, kind=k("gpu_user_annotation")),
        Event("void gemm<float, 4>(float*, int)", "CUDA", 100, 300, corr=1,
              kind=k("kernel")),
        Event("void gemm<float, 4>(float*, int)", "CUDA", 250, 320, corr=7,
              kind=k("kernel")),
        Event("add_kernel(float*)", "CUDA", 400, 500, corr=2,
              kind=k("kernel")),
    ]


@pytest.mark.parametrize("with_kinds", [True, False])
def test_window_reading(with_kinds):
    w = tr.read_window(window(with_kinds))
    assert w.window_s == pytest.approx(1000e-9)
    # kernels 100-320 and 400-500: the overlap counted once
    assert w.busy_s == pytest.approx(320e-9)
    assert w.launches("gemm") == 2 and w.launches("add_kernel") == 1
    assert w.device_s("gemm") == pytest.approx(270e-9)
    assert w.device_ops()[0] == ["gemm<float, 4>", pytest.approx(270e-9)]
    gaps = dict(w.idle_gaps)
    # 0-100 ended by the launch at 30 inside aten::mm; 320-400 by the one
    # at 310 inside aten::add; 500-1000 at the window's end
    assert gaps["round / aten::mm"] == pytest.approx(100e-9)
    assert gaps["round / aten::add"] == pytest.approx(80e-9)
    assert gaps[tr.WINDOW_SPAN + " / no operator"] == pytest.approx(500e-9)


def test_short_names():
    assert tr.short_name("void ssd_bwd_rows<true>(Args)") == \
        "ssd_bwd_rows<true>"
    assert tr.short_name("ampere_sgemm_128x64_nn") == \
        "ampere_sgemm_128x64_nn"
    assert tr.short_name("void (anonymous namespace)::ssd_scan_kernel<"
                         "false>(Args)") == "ssd_scan_kernel<false>"
    assert tr.short_name("(cudaMemsetAsync)") == "(cudaMemsetAsync)"


def test_the_guard_finds_lost_records():
    w = tr.Window(kernels={"void topk_quant_wide_store<false, false>()":
                           [3, 1e-3],
                           "void topk_quant_wide_max<false>()": [3, 1e-3],
                           "void ssd_scan_kernel<false>(Args)": [96, 1e-2],
                           "void ssd_bwd_rows<false>(Args)": [40, 1e-2]})
    calls = {"channel": 3, "ssd_fwd": 96, "ssd_bwd": 48}
    short = _guard(w, calls)
    assert len(short) == 1 and short[0].startswith("ssd_bwd")
    assert not _guard(w, dict(calls, ssd_bwd=40))
    assert set(COUNTED) == set(calls)
