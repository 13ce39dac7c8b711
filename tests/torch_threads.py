"""One intra-op thread for torch while a port test module runs.

The tier-1 suite runs in several worker processes at once (pytest-xdist),
and torch starts one intra-op thread per core in each: the workers'
threads then contend for the cores, and the port's tests ran about five
times slower in parallel than with one thread each.  Only the f32
summation order of torch's CPU ops depends on the thread count, which
every tolerance of the port's tests covers; the exact comparisons are of
integer counts, maxima and elementwise ops.

A port test module takes it with
``from torch_threads import one_torch_thread  # noqa: F401``.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
